"""Training steps on the card, this tree's and another's in turns::

    python src/repro_torch/benchmarks/train_step.py [--src DIR]
    python src/repro_torch/benchmarks/train_step.py --parent DIR
    (either with --arch A [A ...], --steps N and --json PATH)

Run it as a file, not with ``-m``: ``--src`` decides which ``repro_torch``
it imports.  Every kernel source is built first, one nvcc each, all at
once.  For each architecture, at full width and depth, ``TrainLoop`` (its
default AdamW, seeded weights, B 8 x S 256 from its synthetic stream) runs
``--steps`` steps: ms a step (the median of steps 2 on: step 1 also tunes
the kernels' launches), tokens/s, peak memory, and the device-busy share
of one more step under ``torch.profiler`` (its kernels' device time over
its wall).  ``--parent DIR`` runs DIR's tree and this one in turns,
parent, this, this, parent, each in a process of its own, and prints each
architecture's times side by side.  The last line is one JSON object.
Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

TRAIN_B, TRAIN_S = 8, 256
ARCHS = ("mamba2-130m", "internlm2-1.8b", "whisper-medium")
SEED = 0
HERE = Path(__file__).resolve()


def busy_share(fn) -> tuple[float, float]:
    """(device ms, wall ms) of one call of fn under ``torch.profiler``: the
    device time is the sum of its kernels' and copies' (one stream, so no
    overlap); a ``record_function`` range's span on the device (the step's
    ``adamw_update``) is not an execution and is left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device = sum(ev.time_range.end - ev.time_range.start
                 for ev in prof.events()
                 if str(ev.device_type).endswith("CUDA")
                 and not getattr(ev, "is_user_annotation", False)
                 and ev.name != "adamw_update") / 1e3
    return device, wall


def measure(src: str | None, archs, steps: int) -> list[dict]:
    """Each architecture's row, with the ``repro_torch`` under ``src`` (this
    tree's by default)."""
    sys.path.insert(0, str(Path(src).resolve() if src
                           else HERE.parents[2]))
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapePreset
    from repro_torch.kernels import _build
    from repro_torch.launch.train import TrainLoop

    t0 = time.perf_counter()
    _build.build_all()
    print(f"  built in {time.perf_counter() - t0:.1f} s", flush=True)
    rows = []
    for arch in archs:
        cfg = get_config(arch)
        loop = TrainLoop(cfg, ShapePreset("bench", "train", TRAIN_S, TRAIN_B),
                         seed=SEED)
        loop.init_state()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        hist = loop.run(steps, log_every=1)
        peak = torch.cuda.max_memory_allocated() / 2**30
        step_ms = float(np.median([m["step_time_s"] for m in hist[1:]])) \
            * 1e3
        batch = loop.next_batch()
        device, wall = busy_share(
            lambda: loop.step_fn(loop.params, loop.opt_state, batch))
        row = {"arch": arch, "step_ms": step_ms,
               "steps_ms": [m["step_time_s"] * 1e3 for m in hist],
               "tokens_per_s": TRAIN_B * TRAIN_S / step_ms * 1e3,
               "peak_gib": peak, "device_ms": device,
               "profiled_wall_ms": wall, "busy": device / wall,
               "losses": [m["loss"] for m in hist]}
        rows.append(row)
        print(f"  {arch}: {step_ms:.2f} ms a step (median of steps "
              f"2-{steps}), {row['tokens_per_s']:.0f} tokens/s, peak "
              f"{peak:.2f} GiB; profiled step: device {device:.2f} ms of "
              f"{wall:.2f} ms wall ({row['busy']:.1%} busy)", flush=True)
        del loop
        torch.cuda.empty_cache()
    return rows


def in_turns(parent: str, archs, steps: int) -> dict:
    """parent, this, this, parent, each in a process of its own: every
    architecture's ms a step, peak and busy share per run."""
    runs = []
    for label, src in (("parent", parent), ("this", None), ("this", None),
                       ("parent", parent)):
        cmd = [sys.executable, str(HERE), "--steps", str(steps), "--arch",
               *archs] + (["--src", src] if src else [])
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"{label} run failed:\n{proc.stdout[-4000:]}"
                               f"\n{proc.stderr[-4000:]}")
        runs.append((label, json.loads(proc.stdout.strip().splitlines()[-1])
                     ["rows"]))
        print(f"[{label}]\n" + "\n".join(
            ln for ln in proc.stdout.splitlines() if ln.startswith("  ")),
            flush=True)
    table = []
    for i, arch in enumerate(archs):
        entry = {"arch": arch}
        for lab in ("parent", "this"):
            rs = [rows[i] for label, rows in runs if label == lab]
            for key in ("step_ms", "peak_gib", "busy"):
                entry[f"{lab}_{key}"] = [r[key] for r in rs]
        table.append(entry)
        print(f"  {arch}: ms a step parent {entry['parent_step_ms']}, this "
              f"{entry['this_step_ms']}; peak GiB parent "
              f"{entry['parent_peak_gib']}, this {entry['this_peak_gib']}; "
              f"busy parent {entry['parent_busy']}, this "
              f"{entry['this_busy']}", flush=True)
    return {"in_turns": table, "runs": runs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", help="train with the repro_torch under this src")
    ap.add_argument("--parent", help="this src and the tree's in turns")
    ap.add_argument("--arch", nargs="+", default=list(ARCHS))
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--json", help="also write the result here")
    args = ap.parse_args(argv)
    out = in_turns(args.parent, args.arch, args.steps) if args.parent else \
        {"rows": measure(args.src, args.arch, args.steps)}
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
