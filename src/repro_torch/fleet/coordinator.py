"""The fleet coordinator: partition, lease, supervise, merge, write through.

``FleetCoordinator.tune`` turns kernel tune requests into content-keyed
jobs on the spool board, supervises a pool of workers while they drain
it, folds the results into canonical ``CollectedData``, and runs the
fit -> codegen -> versioned ``DriverCache`` write-through -- with the
*same* cache key a single-process ``build_driver`` would compute, so a
fleet of serving nodes warm-starts from probes no single node paid for.

Partitioning modes (per kernel):

  ``batch``   one job per probe size -- the default for strategies without
              cross-size state (random, lhs); per-batch derived rngs make
              the shards bit-identical to the single-process batches
  ``kernel``  one job for the whole collect -- required when the strategy
              carries state across sizes (``Strategy.cross_size_state``)
  ``rows``    the strategy loop runs *here* and every probe call fans its
              row-chunks out as jobs (``chunk_noise_seed`` placement
              independence); finest grain, works for any strategy
  ``auto``    ``kernel`` when the strategy demands it, else ``batch``

Fault supervision wires ``distributed.fault_tolerance`` to the board's
lease mechanics: one re-armable ``Watchdog`` per worker watches the
claim-mtime heartbeat channel (fire -> leases reassigned, reset on
revival), a ``StragglerMonitor`` over per-worker job durations triggers
speculative duplicates of a slow worker's leases, and ``requeue_stale``
is the lease-expiry backstop that catches killed workers.  Everything
converges because jobs are idempotent and results first-writer-win:
reassigned, speculated and duplicate executions are dropped by key,
never double-merged.

``retune`` drains a ``RetuneQueue`` (ledger-fed drift keys) through
``retune`` jobs: search -> refit -> versioned cache write-through happens
entirely farm-side, under per-key slices of one ``SearchBudget``.

On the card (the oracle a ``CudaEventTimer``) the process backend spawns
its workers -- a child forked after the parent touched CUDA cannot use
CUDA -- and worker ``i`` takes card ``i % torch.cuda.device_count()``.
Each worker rebuilds the oracle from the job's JSON on its own card, and
the card's lock (core/card_lock.py) makes the timed rows of workers on
one card take turns: on one card the farm overlaps only host work
(tables, fits, JSON), so it is slower in wall time than one process by
the workers' start-up; its gain needs several cards.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Mapping, Sequence

import numpy as np

from ..core.cache import DriverCache
from ..core.collect import (batch_budgets, concat_row_probes,
                            default_probe_data)
from ..core.device_model import (CudaEventTimer, DeviceModel, HardwareParams,
                                 RowProbe)
from ..core.tuner import BuildResult, Klaraptor
from ..distributed.fault_tolerance import StragglerMonitor, Watchdog
from ..search import SearchBudget, resolve_strategy
from ..trace import trace_span

from .board import JobBoard
from .jobs import (ProbeJob, SpecRef, device_from_json, device_to_json,
                   make_job)
from .merge import merge_batch_results, merge_kernel_result
from .queue import RetuneQueue
from .worker import FaultPlan, run_worker

__all__ = ["FleetConfig", "FleetCoordinator", "FleetStats"]

# RowProbe's integer columns (a rows job's result is JSON lists).
_ROW_DTYPES = {"grid_steps": np.int64, "stage_bytes": np.int64,
               "blocks_resident": np.int64, "repeats": np.int64}


@dataclass(frozen=True)
class FleetConfig:
    """Farm-level policy (worker pool + fault tolerance)."""

    n_workers: int = 4
    backend: str = "thread"             # "thread" | "process"
    lease_s: float = 1.5                # heartbeat timeout = lease length
    poll_s: float = 0.02
    respawn: bool = True                # replace dead workers
    max_attempts: int = 4               # per-job tries before failed/
    straggler_threshold: float = 3.0
    straggler_patience: int = 3
    job_timeout_s: float = 120.0        # _await() safety net


@dataclass
class FleetStats:
    """What supervision observed during one coordinator lifetime."""

    jobs_submitted: int = 0
    results_seen: int = 0
    requeues: int = 0
    stale_requeues: int = 0
    watchdog_fires: int = 0
    worker_deaths: int = 0
    respawns: int = 0
    speculations: int = 0
    by_kind: dict = field(default_factory=dict)


class _WorkerHandle:
    def __init__(self, wid: str, handle, watchdog: Watchdog):
        self.id = wid
        self.handle = handle
        self.watchdog = watchdog
        self.last_mtime = 0.0
        self.ewma: float | None = None
        self.lost = False

    def alive(self) -> bool:
        return self.handle.is_alive()


class FleetCoordinator:
    """Own one spool board + worker pool; see module docstring."""

    def __init__(self, spool, device: DeviceModel,
                 hw: HardwareParams | None = None,
                 cache: DriverCache | None = None,
                 config: FleetConfig | None = None,
                 worker_faults: Mapping[int, FaultPlan] | None = None):
        if isinstance(device, CudaEventTimer):
            # a timer of another card model is refused here, once, and not
            # in every worker's warm-up (device_from_json raises)
            device_from_json(device_to_json(device))
        self.config = config or FleetConfig()
        self.board = JobBoard(spool, max_attempts=self.config.max_attempts)
        self.device = device
        self.hw = hw if hw is not None else device.hw
        self.cache = cache if cache is not None else DriverCache()
        self.stats = FleetStats()
        self.worker_faults = dict(worker_faults or {})
        self.workers: list[_WorkerHandle] = []
        self._spawned = 0
        self._pump_stop = threading.Event()
        self._pump_thread: threading.Thread | None = None
        self._monitor: StragglerMonitor | None = None
        self._speculated: set[str] = set()
        self._seen_results: set[str] = set()
        self._lock = threading.Lock()

    # -- worker pool ---------------------------------------------------------
    def _spawn(self, fault: FaultPlan | None) -> _WorkerHandle:
        wid = f"w{self._spawned}"
        self._spawned += 1
        kwargs = dict(spool=self.board.root, worker_id=wid,
                      poll_s=self.config.poll_s, fault=fault,
                      warm=device_to_json(self.device), card=self._card(wid))
        if self.config.backend == "process":
            import multiprocessing
            # spawn, never fork: a child forked after this process touched
            # CUDA cannot use CUDA
            ctx = multiprocessing.get_context("spawn")
            handle = ctx.Process(target=run_worker, kwargs=kwargs,
                                 daemon=True, name=f"fleet-{wid}")
        elif self.config.backend == "thread":
            handle = threading.Thread(target=run_worker, kwargs=kwargs,
                                      daemon=True, name=f"fleet-{wid}")
        else:
            raise ValueError(
                f"unknown backend {self.config.backend!r} "
                f"(use 'thread' or 'process')")
        wd = Watchdog(self.config.lease_s).start()
        handle.start()
        w = _WorkerHandle(wid, handle, wd)
        self.workers.append(w)
        return w

    def _card(self, wid: str) -> int | None:
        """Worker ``w<i>`` times on card ``i % device_count`` (None when the
        oracle is not a card)."""
        if not isinstance(self.device, CudaEventTimer):
            return None
        import torch
        return int(wid[1:]) % torch.cuda.device_count()

    def start(self) -> "FleetCoordinator":
        self.board.clear_stop()
        for i in range(self.config.n_workers):
            self._spawn(self.worker_faults.get(i))
        self._monitor = StragglerMonitor(
            n_hosts=len(self.workers),
            threshold=self.config.straggler_threshold,
            patience=self.config.straggler_patience)
        self._pump_stop.clear()
        self._pump_thread = threading.Thread(target=self._pump, daemon=True,
                                             name="fleet-pump")
        self._pump_thread.start()
        return self

    def stop(self) -> None:
        self.board.request_stop()
        self._pump_stop.set()
        if self._pump_thread is not None:
            self._pump_thread.join(timeout=5.0)
        for w in self.workers:
            w.watchdog.stop()
            if hasattr(w.handle, "terminate") and w.handle.is_alive():
                w.handle.join(timeout=2.0)
                if w.handle.is_alive():
                    w.handle.terminate()
            else:
                w.handle.join(timeout=2.0)

    def __enter__(self) -> "FleetCoordinator":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- supervision ---------------------------------------------------------
    def _pump(self) -> None:
        while not self._pump_stop.wait(self.config.poll_s):
            try:
                self._tick()
            except Exception:           # supervision must never die silently
                import logging
                logging.getLogger(__name__).exception("fleet pump tick")

    def _tick(self) -> None:
        cfg = self.config
        board = self.board
        with self._lock:
            stale = board.requeue_stale(cfg.lease_s)
            self.stats.stale_requeues += len(stale)
            self.stats.requeues += len(stale)

            held: dict[str, list[tuple[str, float]]] = {}
            for key, worker, mtime in board.claims():
                held.setdefault(worker, []).append((key, mtime))

            for w in list(self.workers):
                if w.lost:
                    continue
                if not w.alive():
                    w.lost = True
                    w.watchdog.stop()
                    requeued = board.requeue_worker(w.id, "worker died")
                    self.stats.worker_deaths += 1
                    self.stats.requeues += len(requeued)
                    if cfg.respawn and not board.stop_requested():
                        self._spawn(None)
                        self.stats.respawns += 1
                    continue
                mine = held.get(w.id, [])
                if not mine:
                    # Holding nothing: cannot be hung *on a lease*.  Keep
                    # the watchdog quiet and re-arm it if it had fired.
                    w.watchdog.beat()
                    if w.watchdog.fired:
                        w.watchdog.reset()
                    continue
                newest = max(m for _, m in mine)
                if newest > w.last_mtime:
                    w.last_mtime = newest
                    if w.watchdog.fired:
                        w.watchdog.reset()  # revived: re-arm for next time
                    else:
                        w.watchdog.beat()
                elif w.watchdog.fired:
                    # Hung: heartbeat stopped while holding leases.
                    requeued = board.requeue_worker(
                        w.id, "watchdog fired: heartbeat stopped")
                    if requeued:
                        self.stats.watchdog_fires += 1
                        self.stats.requeues += len(requeued)

            self._observe_results(held)

    def _observe_results(self, held: dict) -> None:
        """Feed new result durations to the straggler monitor; speculate
        the current leases of flagged workers."""
        rdir = os.path.join(self.board.root, "results")
        try:
            names = os.listdir(rdir)
        except OSError:
            return
        fresh = False
        for name in names:
            if not name.endswith(".json") or name in self._seen_results:
                continue
            self._seen_results.add(name)
            self.stats.results_seen += 1
            doc = self.board.result(name[:-len(".json")])
            if doc is None:
                continue
            fresh = True
            for w in self.workers:
                if w.id == doc.get("worker"):
                    dur = float(doc.get("wall_seconds", 0.0))
                    w.ewma = dur if w.ewma is None else \
                        0.5 * w.ewma + 0.5 * dur
        live = [w for w in self.workers if not w.lost]
        if not fresh or self._monitor is None or not live:
            return
        if self._monitor.n_hosts != len(live):
            self._monitor = StragglerMonitor(
                n_hosts=len(live),
                threshold=self.config.straggler_threshold,
                patience=self.config.straggler_patience)
        known = [w.ewma for w in live if w.ewma is not None]
        if not known:
            return
        default = sorted(known)[len(known) // 2]
        flagged = self._monitor.observe(
            [w.ewma if w.ewma is not None else default for w in live])
        for i in flagged:
            for key, _ in held.get(live[i].id, []):
                if key not in self._speculated and self.board.speculate(key):
                    self._speculated.add(key)
                    self.stats.speculations += 1

    # -- job submission / waiting --------------------------------------------
    def _submit(self, job: ProbeJob) -> str:
        stage = self.board.submit(job)
        self.stats.jobs_submitted += 1
        k = self.stats.by_kind
        k[job.kind] = k.get(job.kind, 0) + 1
        return stage

    def _await(self, keys: Sequence[str],
               timeout_s: float | None = None) -> dict[str, dict]:
        """Block until every key has a result; raise on failure/timeout."""
        timeout_s = timeout_s if timeout_s is not None \
            else self.config.job_timeout_s
        deadline = time.monotonic() + timeout_s
        pending = set(keys)
        out: dict[str, dict] = {}
        while pending:
            for key in sorted(pending):
                doc = self.board.result(key)
                if doc is not None:
                    out[key] = doc
                    pending.discard(key)
                    continue
                fail = self.board.failure(key)
                if fail is not None:
                    raise RuntimeError(
                        f"fleet job {key[:12]} permanently failed after "
                        f"{fail.get('attempts')} attempts: "
                        f"{fail.get('errors')}")
            if pending:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"fleet: {len(pending)} job(s) still unresolved "
                        f"after {timeout_s}s; board={self.board.counts()}")
                time.sleep(self.config.poll_s)
        return out

    # -- tune ----------------------------------------------------------------
    def _common_payload(self, ref: SpecRef, seed: int, repeats: int,
                        max_configs_per_size: int, strategy,
                        shard_rows) -> dict:
        return {
            "spec": ref.to_json(),
            "device": device_to_json(self.device),
            "hw": self.hw.name,
            "seed": int(seed),
            "repeats": int(repeats),
            "max_configs_per_size": int(max_configs_per_size),
            "strategy": strategy,
            "shard_rows": int(shard_rows) if shard_rows is not None else None,
        }

    def tune(self, spec_refs: Mapping[str, SpecRef] | Sequence[SpecRef],
             probe_data=None, repeats: int = 3,
             max_configs_per_size: int = 32, seed: int = 0,
             strategy: str | None = None, budget: SearchBudget | None = None,
             shard_rows: int | None = None,
             mode: str = "auto", use_cache: bool = True,
             ) -> dict[str, BuildResult]:
        """Farm one collect -> fit -> write-through per kernel.

        ``strategy`` must be a registry *name* (or None): workers
        reconstruct it from the payload.  ``probe_data`` is None, one
        shared probe list, or a per-kernel-name mapping -- exactly what
        the equivalent single-process ``build_driver`` would be given, so
        cache keys (and the collected rows; under a seeded oracle the
        bytes) match it.  The reference's ``max_stages`` has no counterpart
        (core/collect.py).
        """
        if not isinstance(spec_refs, Mapping):
            spec_refs = {ref.build().name: ref for ref in spec_refs}
        if strategy is not None and not isinstance(strategy, str):
            raise TypeError("fleet tune takes a strategy *name*; workers "
                            "must be able to reconstruct it from JSON")
        if mode not in ("auto", "batch", "kernel", "rows"):
            raise ValueError(f"unknown mode {mode!r}")
        strat = resolve_strategy(strategy)
        kernel_mode = strat.cross_size_state
        if mode == "kernel":
            kernel_mode = True
        elif mode in ("batch", "rows"):
            if strat.cross_size_state:
                raise ValueError(
                    f"strategy {strat.name!r} carries cross-size state and "
                    f"cannot run in {mode!r} mode (use 'kernel' or 'auto')")
            kernel_mode = False
        if mode == "rows" and shard_rows is None:
            raise ValueError("mode='rows' requires shard_rows")

        def _pd_arg(name):
            if probe_data is None:
                return None
            if isinstance(probe_data, Mapping):
                return probe_data.get(name)
            return probe_data

        plans: dict[str, dict] = {}
        with trace_span("fleet.tune", kernels=sorted(spec_refs),
                        mode=mode, shard_rows=shard_rows):
            for name, ref in sorted(spec_refs.items()):
                spec = ref.build()
                pd_arg = _pd_arg(name)
                pd = list(pd_arg) if pd_arg is not None else \
                    default_probe_data(spec)
                common = self._common_payload(
                    ref, seed, repeats, max_configs_per_size, strategy,
                    shard_rows)
                plan = {"spec": spec, "ref": ref, "pd_arg": pd_arg,
                        "pd": pd, "keys": [], "mode": None}
                if mode == "rows":
                    plan["mode"] = "rows"
                elif kernel_mode:
                    plan["mode"] = "kernel"
                    job = make_job("kernel", {
                        **common,
                        "probe_data": [{k: int(v) for k, v in d.items()}
                                       for d in pd],
                        "budget": (budget.fingerprint()
                                   if budget is not None else None)})
                    self._submit(job)
                    plan["keys"] = [job.key]
                else:
                    plan["mode"] = "batch"
                    budgets = batch_budgets(len(pd), budget,
                                            max_configs_per_size, repeats)
                    for i, (D, b) in enumerate(zip(pd, budgets)):
                        job = make_job("batch", {
                            **common,
                            "D": {k: int(v) for k, v in D.items()},
                            "batch_index": i,
                            "budget": b.fingerprint()})
                        self._submit(job)
                        plan["keys"].append(job.key)
                plans[name] = plan

            results: dict[str, BuildResult] = {}
            for name, plan in sorted(plans.items()):
                spec = plan["spec"]
                if plan["mode"] == "rows":
                    data = self._collect_rows_mode(
                        spec, plan["ref"], plan["pd"], repeats,
                        max_configs_per_size, seed, strategy, budget,
                        shard_rows)
                else:
                    docs = self._await(plan["keys"])
                    payloads = [docs[k]["payload"] for k in plan["keys"]]
                    if plan["mode"] == "kernel":
                        data = merge_kernel_result(payloads[0])
                    else:
                        data = merge_batch_results(spec, payloads)
                kl = Klaraptor(self.device, hw=self.hw, cache=self.cache)
                results[name] = kl.build_driver(
                    spec, probe_data=plan["pd_arg"], repeats=repeats,
                    max_configs_per_size=max_configs_per_size, seed=seed,
                    strategy=strategy, budget=budget,
                    shard_rows=shard_rows, data=data, use_cache=use_cache)
        return results

    def _collect_rows_mode(self, spec, ref, pd, repeats,
                           max_configs_per_size, seed, strategy, budget,
                           shard_rows):
        """Run the strategy loop here, farm out every probe call's chunks."""
        from ..core.collect import collect

        coord = self

        def prober_factory(batch_index: int, D: dict, tt):
            state = {"call": 0}

            def prober(idx: np.ndarray, reps: np.ndarray) -> RowProbe:
                call = state["call"]
                state["call"] += 1
                common = coord._common_payload(
                    ref, seed, repeats, max_configs_per_size, strategy,
                    shard_rows)
                keys = []
                for j, lo in enumerate(range(0, int(idx.size), shard_rows)):
                    sl = slice(lo, lo + shard_rows)
                    job = make_job("rows", {
                        **common,
                        "D": {k: int(v) for k, v in D.items()},
                        "batch_index": int(batch_index),
                        "call_index": int(call),
                        "chunk_index": int(j),
                        "indices": idx[sl].tolist(),
                        "row_repeats": reps[sl].tolist(),
                        "budget": None})
                    coord._submit(job)
                    keys.append(job.key)
                docs = coord._await(keys)
                parts = []
                for key in keys:
                    p = docs[key]["payload"]["probe"]
                    parts.append(RowProbe(**{
                        f.name: np.asarray(p[f.name], dtype=_ROW_DTYPES.get(
                            f.name, np.float64))
                        for f in dataclasses.fields(RowProbe)}))
                return concat_row_probes(parts)

            return prober

        return collect(
            spec, self.device, probe_data=pd, hw=self.hw, repeats=repeats,
            max_configs_per_size=max_configs_per_size, seed=seed,
            strategy=strategy, budget=budget,
            shard_rows=shard_rows, prober_factory=prober_factory)

    # -- retune --------------------------------------------------------------
    def retune(self, queue: RetuneQueue,
               spec_refs: Mapping[str, SpecRef],
               budget: SearchBudget | None = None, seed: int = 0,
               telemetry_config: dict | None = None) -> list[dict]:
        """Drain pending drift keys through farm-side retune jobs.

        One total ``budget`` is split across the pending keys (the farm
        spends a bounded amount, however long the queue).  Each completed
        job marks its key done with the refit summary; a kernel with no
        known spec ref is marked failed (nothing can rebuild it).
        """
        pend = queue.pending()
        if not pend:
            return []
        budgets = budget.split(len(pend)) if budget is not None \
            else [None] * len(pend)
        submitted: list[tuple[str, str]] = []    # (drift_key, job_key)
        with trace_span("fleet.retune", n_keys=len(pend)):
            for (dkey, event), b in zip(pend, budgets):
                ref = spec_refs.get(event.get("kernel"))
                if ref is None:
                    queue.mark_failed(
                        dkey, f"no spec ref for kernel "
                              f"{event.get('kernel')!r}")
                    continue
                job = make_job("retune", {
                    "spec": ref.to_json(),
                    "device": device_to_json(self.device),
                    "hw": self.hw.name,
                    "seed": int(seed),
                    # the shared root: DriverCache adds the port's level
                    "cache_dir": os.path.dirname(self.cache.root),
                    "config": dict(telemetry_config or {}),
                    "budget": b.fingerprint() if b is not None else None,
                    "drift": {
                        "kernel": event.get("kernel"),
                        "hw": event.get("hw"),
                        "bucket": event.get("bucket"),
                        "D": event.get("D", {}),
                        "config": event.get("config", {}),
                        "rel_error_ewma": event.get("rel_error_ewma", 0.0),
                        "n_samples": event.get("n_samples", 0),
                        "predicted_s": event.get("predicted_s", 0.0),
                        "observed_s": event.get("observed_s", 0.0),
                    }})
                self._submit(job)
                submitted.append((dkey, job.key))
            outcomes = []
            if submitted:
                docs = self._await([jk for _, jk in submitted])
                for dkey, jk in submitted:
                    summary = docs[jk]["payload"]["refit"]
                    queue.mark_done(dkey, summary)
                    outcomes.append({"key": dkey, **summary})
        return outcomes

    # -- status --------------------------------------------------------------
    def status(self) -> dict:
        return {
            "board": self.board.counts(),
            "workers": [{"id": w.id, "alive": w.alive(), "lost": w.lost,
                         "ewma_s": w.ewma,
                         "watchdog_fired": w.watchdog.fired}
                        for w in self.workers],
            "stats": dataclasses.asdict(self.stats),
            "dropped": len(self.board.dropped()),
        }
