"""Fleet launcher: coordinator, workers, and the drift-retuning queue.

    # tune the tier-1 kernels across 4 local workers, timed on the card
    python -m repro_torch.launch.fleet tune --spool /tmp/spool --workers 4

    # the same on the CPU, against the analytic H100 (HopperModel)
    python -m repro_torch.launch.fleet tune --spool /tmp/spool --workers 2 \
        --device cpu

    # ingest a serving process's flight ledger and retune every drifted key
    python -m repro_torch.launch.fleet retune --spool /tmp/spool \
        --ledger run.jsonl --state retune.json --cache ~/.cache/klaraptor

    # a standalone worker against an existing spool (another process/host
    # on a shared filesystem); exits on the spool's stop sentinel
    python -m repro_torch.launch.fleet worker --spool /tmp/spool --id w9

    # what is the farm doing / what has the queue seen
    python -m repro_torch.launch.fleet status --spool /tmp/spool \
        --state retune.json

``tune``/``retune`` run an in-process coordinator that starts its own
worker pool (``--workers N``, ``--backend thread|process``; process
workers are spawned) *and* feeds any standalone workers pointed at the
same spool.  The oracle is the card's ``CudaEventTimer`` on
``HardwareParams.from_device()`` (it raises without a card; worker ``i``
times on card ``i % device_count``, and workers on one card take turns);
``--device cpu`` selects ``HopperModel`` (``--noise``, ``--device-seed``),
under which farm results are the single-process build's bytes.  ``--hw``
takes the port's names: ``h100_sxm_cc90`` or the card's own.  The JAX
launcher's ``status --dash`` waits for ``launch/dash.py``.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..core.cache import DriverCache
from ..core.device_model import (H100, CudaEventTimer, HardwareParams,
                                 HopperModel)
from ..fleet import (FleetConfig, FleetCoordinator, JobBoard, RetuneQueue,
                     hw_by_name, run_worker, tier1_spec_refs)
from ..search import SearchBudget

from .status import section, table

__all__ = ["main"]


def _hw(args) -> HardwareParams:
    if args.hw is not None:
        return hw_by_name(args.hw)
    return H100 if args.device == "cpu" else HardwareParams.from_device()


def _device(args):
    if args.device == "cpu":
        return HopperModel(_hw(args), noise=args.noise,
                           seed=args.device_seed)
    return CudaEventTimer(_hw(args), seed=args.device_seed)


def _coordinator(args) -> FleetCoordinator:
    cfg = FleetConfig(n_workers=args.workers, backend=args.backend,
                      lease_s=args.lease, job_timeout_s=args.job_timeout)
    cache = DriverCache(args.cache) if args.cache else DriverCache()
    device = _device(args)
    return FleetCoordinator(args.spool, device, hw=device.hw, cache=cache,
                            config=cfg)


def _selected_refs(args) -> dict:
    refs = tier1_spec_refs()
    if not args.kernels:
        return refs
    missing = [k for k in args.kernels if k not in refs]
    if missing:
        raise SystemExit(f"unknown kernel(s) {missing}; "
                         f"tier-1 set is {sorted(refs)}")
    return {k: refs[k] for k in args.kernels}


def _budget(args) -> SearchBudget | None:
    if args.max_executions is None and args.max_device_seconds is None:
        return None
    return SearchBudget(max_executions=args.max_executions,
                       max_device_seconds=args.max_device_seconds)


def _cmd_tune(args) -> int:
    refs = _selected_refs(args)
    with _coordinator(args) as fc:
        results = fc.tune(
            refs, repeats=args.repeats,
            max_configs_per_size=args.max_configs_per_size,
            seed=args.seed, strategy=args.strategy, budget=_budget(args),
            shard_rows=args.shard_rows, mode=args.mode)
        lines = section("fleet tune")
        rows = []
        for name in sorted(results):
            r = results[name]
            rows.append([name,
                         "cache" if r.from_cache else "farmed",
                         str(r.collected.n_probe_executions),
                         f"{r.collected.probe_device_seconds:.4f}s",
                         f"{r.build_wall_seconds:.2f}s"])
        lines += table(["kernel", "source", "probes", "device", "wall"],
                       rows)
        lines += _status_lines(fc)
    print("\n".join(lines))
    return 0


def _cmd_retune(args) -> int:
    q = RetuneQueue(args.state)
    new = 0
    for path in args.ledger or []:
        new += q.ingest(path)
    print(f"retune queue: {new} new drift key(s); {json.dumps(q.summary())}")
    if not q.pending():
        print("nothing pending; done")
        return 0
    with _coordinator(args) as fc:
        outcomes = fc.retune(q, tier1_spec_refs(), budget=_budget(args),
                             seed=args.seed)
        lines = section("farm retunes")
        rows = [[o["key"],
                 "ok" if o.get("succeeded") else "failed",
                 str(o.get("cache_version")),
                 f"{o.get('wall_seconds', 0.0):.2f}s"]
                for o in outcomes]
        lines += table(["drift key", "status", "version", "wall"], rows) \
            if rows else ["  (no retunes ran)"]
        lines += _status_lines(fc)
    print("\n".join(lines))
    return 0


def _cmd_worker(args) -> int:
    done = run_worker(args.spool, args.id, poll_s=args.poll,
                      max_jobs=args.max_jobs, idle_exit_s=args.idle_exit)
    print(f"worker {args.id}: {done} job(s) completed")
    return 0


def _status_lines(fc: FleetCoordinator) -> list[str]:
    st = fc.status()
    lines = section("farm")
    lines.append("  board: " + json.dumps(st["board"]))
    lines += table(
        ["worker", "alive", "ewma", "watchdog"],
        [[w["id"], "yes" if w["alive"] else ("lost" if w["lost"] else "no"),
          f"{w['ewma_s']:.3f}s" if w["ewma_s"] is not None else "-",
          "fired" if w["watchdog_fired"] else "ok"]
         for w in st["workers"]])
    s = st["stats"]
    lines.append(f"  jobs={s['jobs_submitted']} results={s['results_seen']} "
                 f"requeues={s['requeues']} "
                 f"watchdog_fires={s['watchdog_fires']} "
                 f"deaths={s['worker_deaths']} respawns={s['respawns']} "
                 f"speculations={s['speculations']}")
    return lines


def _cmd_status(args) -> int:
    lines = []
    if args.spool:
        board = JobBoard(args.spool)
        lines += section("spool " + args.spool)
        lines.append("  " + json.dumps(board.counts()))
        claims = board.claims()
        if claims:
            lines += table(["job", "worker"],
                           [[k[:12], w] for k, w, _ in claims])
    if args.state:
        q = RetuneQueue(args.state)
        lines += section("retune queue " + args.state)
        lines.append("  " + json.dumps(q.summary(), sort_keys=True))
        pend = q.pending()
        if pend:
            lines += table(
                ["drift key", "seen", "ewma"],
                [[k, str(q.state["pending"][k]["n_seen"]),
                  f"{e.get('rel_error_ewma', 0.0):.3f}"]
                 for k, e in pend])
    if not lines:
        print("nothing to show (pass --spool and/or --state)")
        return 1
    print("\n".join(lines))
    return 0


def _add_common(ap: argparse.ArgumentParser, spool_required=True) -> None:
    ap.add_argument("--spool", required=spool_required,
                    help="spool directory shared by coordinator and workers")


def _add_farm(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--backend", choices=("thread", "process"),
                    default="thread")
    ap.add_argument("--lease", type=float, default=1.5,
                    help="lease/heartbeat timeout in seconds")
    ap.add_argument("--job-timeout", type=float, default=300.0)
    ap.add_argument("--cache", default=None,
                    help="DriverCache root (default: the user cache dir)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: time the kernels on the card "
                         "(CudaEventTimer); cpu: the analytic HopperModel")
    ap.add_argument("--hw", default=None,
                    help=f"hardware table: {H100.name} or the card's name "
                         f"(default: the card's; {H100.name} with "
                         f"--device cpu)")
    ap.add_argument("--noise", type=float, default=0.04)
    ap.add_argument("--device-seed", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-executions", type=int, default=None)
    ap.add_argument("--max-device-seconds", type=float, default=None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.fleet",
        description="KLARAPTOR tuning farm: distribute probe work across "
                    "fault-tolerant workers and retune drifted kernels "
                    "from serving flight ledgers.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("tune", help="farm a tier-1 tune run")
    _add_common(t)
    _add_farm(t)
    t.add_argument("--kernels", nargs="*", default=None,
                   help="subset of tier-1 kernel names (default: all)")
    t.add_argument("--repeats", type=int, default=3)
    t.add_argument("--max-configs-per-size", type=int, default=32)
    t.add_argument("--strategy", default=None,
                   help="search strategy name (registry)")
    t.add_argument("--shard-rows", type=int, default=None)
    t.add_argument("--mode", choices=("auto", "batch", "kernel", "rows"),
                   default="auto")
    t.set_defaults(fn=_cmd_tune)

    r = sub.add_parser("retune",
                       help="ingest flight ledgers, retune drifted keys")
    _add_common(r)
    _add_farm(r)
    r.add_argument("--ledger", action="append", metavar="PATH",
                   help="JSONL flight ledger to ingest (repeatable)")
    r.add_argument("--state", required=True,
                   help="durable retune-queue state file")
    r.set_defaults(fn=_cmd_retune)

    w = sub.add_parser("worker", help="serve jobs from an existing spool")
    _add_common(w)
    w.add_argument("--id", required=True,
                   help="worker id (no dots; unique per spool)")
    w.add_argument("--poll", type=float, default=0.05)
    w.add_argument("--max-jobs", type=int, default=None)
    w.add_argument("--idle-exit", type=float, default=None,
                   help="exit after this many idle seconds")
    w.set_defaults(fn=_cmd_worker)

    s = sub.add_parser("status", help="inspect a spool / retune queue")
    _add_common(s, spool_required=False)
    s.add_argument("--state", default=None)
    s.set_defaults(fn=_cmd_status)

    args = ap.parse_args(argv)
    if getattr(args, "id", None) is not None and "." in args.id:
        raise SystemExit("worker ids must not contain '.' "
                         "(they delimit lease filenames)")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
