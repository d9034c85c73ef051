"""Fleet workers: claim -> execute -> complete over the spool board.

A worker is a pure probe executor: all run-defining state (seeds, budgets,
strategy names, the oracle by value) arrives inside the job payload, so
any worker -- or two workers at once -- can execute any job: to the same
bytes under a seeded oracle, to the same rows on the card.  Heartbeats are
claim-file mtimes (``JobBoard.heartbeat``), refreshed by the oracle's
``beat`` callback (between ``WallClockSim``'s sleep slices, between a
``CudaEventTimer``'s rows and while it waits for the card's lock); the
coordinator's per-worker ``Watchdog`` watches exactly this channel.  A
worker given ``warm`` (the coordinator's oracle as JSON) builds it and
calls its ``warm()`` before the first claim -- on the card that loads the
kernel libraries and makes the CUDA context -- so no lease runs through a
build; ``card`` selects its CUDA device.  A worker whose warm-up raised
(no card, or a card of another model than the job's) fails every job it
claims with that error, so the board gives up on them after
``max_attempts`` instead of the coordinator respawning it forever.

The serve loop is wrapped in ``distributed.fault_tolerance.retry_loop``:
an unexpected crash outside per-job handling (per-job errors are caught
and recorded on the board) restarts the loop instead of silently losing
the worker.  ``FaultPlan`` injects the failure modes the tests and
``chip_smoke.py`` assert recovery from: a worker that dies mid-job, one
that hangs mid-job (stops heartbeating), and one that vanishes (abandons
its lease without crashing the process).  ``run_worker``'s arguments are
plain values and a ``FaultPlan``, so the coordinator's process backend
can spawn it (nothing of CUDA crosses the process boundary).
"""

from __future__ import annotations

import dataclasses
import os
import time
from dataclasses import dataclass
from typing import Mapping

import numpy as np

from ..core.collect import ChunkedProber, collect, collect_batch
from ..distributed.fault_tolerance import retry_loop
from ..search import SearchBudget

from .board import JobBoard
from .jobs import SpecRef, device_from_json, hw_by_name

__all__ = ["FaultPlan", "execute_job", "run_worker"]


@dataclass
class FaultPlan:
    """Injected worker misbehavior, counted in claimed jobs (1-based).

    ``kill_at_job``    call os._exit mid-job: the process dies holding the
                       lease (process workers only)
    ``vanish_at_job``  abandon the claim and exit the loop without
                       completing (the thread-safe analogue of a kill)
    ``hang_at_job``    sleep ``hang_s`` mid-job without heartbeating, then
                       resume -- exercises lease expiry + duplicate-result
                       dropping when the sleeper eventually finishes
    """

    kill_at_job: int | None = None
    vanish_at_job: int | None = None
    hang_at_job: int | None = None
    hang_s: float = 0.0


def execute_job(job: dict, beat=None) -> dict:
    """Run one job document; returns the result payload (JSON-able).

    Every random stream is derived from seeds in the payload (see
    ``core.collect``), so re-execution anywhere reproduces the same bytes
    under a seeded oracle, and the same rows on the card.
    """
    kind = job["kind"]
    p = job["payload"]
    spec = SpecRef.from_json(p["spec"]).build()
    device = device_from_json(p["device"], beat=beat)
    hw = hw_by_name(p["hw"])
    budget = (SearchBudget(**p["budget"])
              if p.get("budget") is not None else None)

    if kind == "batch":
        shard = collect_batch(
            spec, device, p["D"], hw=hw, repeats=p["repeats"],
            max_configs_per_size=p["max_configs_per_size"], seed=p["seed"],
            batch_index=p["batch_index"], budget=budget,
            strategy=p.get("strategy"), shard_rows=p.get("shard_rows"))
        return {"shard": shard.to_json()}

    if kind == "kernel":
        data = collect(
            spec, device, probe_data=p.get("probe_data"), hw=hw,
            repeats=p["repeats"],
            max_configs_per_size=p["max_configs_per_size"], seed=p["seed"],
            strategy=p.get("strategy"), budget=budget,
            shard_rows=p.get("shard_rows"))
        return {"data": data.to_json()}

    if kind == "rows":
        table = spec.candidates(p["D"], hw)
        tt = spec.traffic_table(p["D"], table, hw)
        prober = ChunkedProber(device, tt, p["seed"], p["batch_index"],
                               p["shard_rows"])
        probe = prober.probe_chunk(
            np.asarray(p["indices"], dtype=np.int64),
            np.asarray(p["row_repeats"], dtype=np.int64),
            p["call_index"], p["chunk_index"])
        return {"probe": {f.name: getattr(probe, f.name).tolist()
                          for f in dataclasses.fields(probe)}}

    if kind == "retune":
        return _execute_retune(p, spec, device, hw, budget)

    raise ValueError(f"unknown job kind {kind!r}")


def _execute_retune(p: dict, spec, device, hw, budget) -> dict:
    """Run one drift reaction farm-side.

    The durable outcome is the versioned cache write-through (a corrected
    generation the serving fleet warm-starts from); the serving node is
    never touched.  The refit also hot-swaps the driver into this
    process's registry: a process worker discards that with the process,
    but a thread worker shares the coordinator's process, so there the
    swap lands in the coordinator's registry (the reference behaves the
    same way).
    """
    from ..core.cache import DriverCache
    from ..core.tuner import Klaraptor
    from ..telemetry.config import TelemetryConfig
    from ..telemetry.drift import DriftEvent
    from ..telemetry.refit import RefitController

    drift = DriftEvent(
        kernel=p["drift"]["kernel"], hw_name=p["drift"]["hw"],
        bucket=tuple(), D=dict(p["drift"]["D"]),
        config=dict(p["drift"]["config"]),
        rel_error_ewma=float(p["drift"]["rel_error_ewma"]),
        n_samples=int(p["drift"].get("n_samples", 0)),
        predicted_s=float(p["drift"].get("predicted_s", 0.0)),
        observed_s=float(p["drift"].get("observed_s", 0.0)))
    cfg_kw = dict(p.get("config", {}))
    if budget is not None:
        cfg_kw["refit_budget"] = budget    # the farm's per-key budget slice
    config = TelemetryConfig(**cfg_kw)
    cache = DriverCache(p["cache_dir"])
    kl = Klaraptor(device, hw=hw, cache=cache)
    result = RefitController(kl, config, seed=p["seed"]).refit(spec, drift)
    out = dataclasses.asdict(result)
    out["budget"] = dict(result.budget)
    return {"refit": out}


def _warm(device_json: Mapping | None, card: int | None) -> None:
    if card is not None:
        import torch

        from ..core.card_lock import CardLock
        # CUDA 12 makes the context here: GPU work, so under the lock
        with CardLock.for_device(torch.device("cuda", card)).hold():
            torch.cuda.set_device(card)
    if device_json is None:
        return
    device = device_from_json(device_json)
    warm = getattr(device, "warm", None)
    if warm is not None:
        warm()


def run_worker(spool, worker_id: str, poll_s: float = 0.02,
               max_jobs: int | None = None, idle_exit_s: float | None = None,
               fault: FaultPlan | None = None, max_failures: int = 3,
               warm: Mapping | None = None, card: int | None = None) -> int:
    """Serve jobs from the spool until stopped; returns jobs completed.

    Exits when the board's stop sentinel appears, after ``max_jobs``
    completions, or after ``idle_exit_s`` with nothing to claim.  The
    loop itself is retry-wrapped (``retry_loop``): only per-job errors
    are recorded on the board; loop-level crashes restart the loop.  Each
    result records the job's wall seconds, the failed or expired attempts
    before it (``attempts``), the longest gap between two of its
    heartbeats (``max_beat_gap_s``) and the kernel launches this process
    made while it ran (``launches``; thread workers share one process's
    counters, so theirs overlap).
    """
    try:
        _warm(warm, card)
        broken = None
    except Exception as e:      # the jobs fail with it (module docstring)
        broken = f"worker warm-up failed: {e!r}"
    # imported before the first claim, so no lease waits on it
    from ..serving.graphs import launch_counts
    board = JobBoard(spool)
    state = {"done": 0, "claimed": 0}

    def _serve(_start: int) -> None:
        idle_since = time.monotonic()
        while not board.stop_requested():
            if max_jobs is not None and state["done"] >= max_jobs:
                return
            job = board.claim(worker_id)
            if job is None:
                if idle_exit_s is not None and \
                        time.monotonic() - idle_since > idle_exit_s:
                    return
                time.sleep(poll_s)
                continue
            idle_since = time.monotonic()
            state["claimed"] += 1
            key = job["key"]
            gap = {"last": time.monotonic(), "max": 0.0}

            def beat() -> bool:
                now = time.monotonic()
                gap["max"] = max(gap["max"], now - gap["last"])
                gap["last"] = now
                return board.heartbeat(key, worker_id)

            beat()
            if broken is not None:
                board.fail(key, worker_id, broken)
                continue
            if fault is not None:
                if fault.kill_at_job == state["claimed"]:
                    os._exit(3)         # dies holding the lease
                if fault.vanish_at_job == state["claimed"]:
                    return              # abandons the lease, loop exits
                if fault.hang_at_job == state["claimed"]:
                    time.sleep(fault.hang_s)    # no heartbeats while asleep
            t0 = time.monotonic()
            before = launch_counts()
            try:
                payload = execute_job(job, beat=beat)
            except Exception as e:      # per-job failure: board bookkeeping
                board.fail(key, worker_id, repr(e))
                continue
            beat()
            launches = {k: n - before[k]
                        for k, n in launch_counts().items() if n != before[k]}
            board.complete(key, worker_id, {
                "ok": True, "wall_seconds": time.monotonic() - t0,
                "attempts": int(job.get("attempts", 0)),
                "max_beat_gap_s": gap["max"], "launches": launches,
                "payload": payload})
            state["done"] += 1

    retry_loop(_serve, lambda: 0, max_failures=max_failures)
    return state["done"]
