"""What a neighbour on the card's host does to ``CudaEventTimer``'s times::

    python -m repro_torch.benchmarks.probe_interference

The tuning farm's workers probe the same rows as one process does, yet
its probe times can differ.  This script times the rows that ``collect``
picks for the four tier-1 kernels at the farm's probe settings (2
repeats, 24 configs per size, each kernel's probe grid, seed 0) in this
process, alone and beside one neighbour at a time, each a spawned
process:

  ``idle``      has made a CUDA context on the card and sleeps
  ``contexts``  starts process after process that each makes a CUDA
                context and loads the kernel libraries without the card's
                lock, as a farm worker's start did
  ``cpu``       keeps every core busy with numpy products (the host load
                of a coordinator's fits)
  ``prober``    probes the same rows through the card's lock (a second
                farm worker)

and alone again at the end.  Every condition runs ``ROUNDS`` times with
the timer as it is (a launch the host enqueued after its spin ended is
timed again, ``RETIMES``) and as many times with that off (``RETIMES``
0).  Per condition, mode and kernel it prints the summed probe time, its
ratio to the first alone run's, the per-row ratio's median, 90th
percentile and maximum (rows' medians over the rounds), and the late
enqueue windows the timer counted over all four kernels.  The last line
is one JSON object of the same numbers.  Needs a card.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

PROBE_KW = dict(repeats=2, max_configs_per_size=24, seed=0)
NEIGHBOURS = ("idle", "contexts", "cpu", "prober")
ROUNDS = 3


def _specs():
    from ..core.kernel_spec import (flash_probe_data, gmm_probe_data,
                                    ssd_probe_data)
    from ..fleet import tier1_spec_refs

    pd = {"matmul_b16": None, "flash_attn_d128_causal": flash_probe_data(),
          "moe_gmm_b16": gmm_probe_data(),
          "ssd_scan_h64_n128": ssd_probe_data()}
    return [(ref.build(), pd[name])
            for name, ref in sorted(tier1_spec_refs().items())]


def _collect_all(timer) -> dict:
    from ..core.collect import collect

    return {spec.name: np.asarray(collect(spec, timer, probe_data=pd,
                                          hw=timer.hw, **PROBE_KW
                                          ).metrics["total_time_s"])
            for spec, pd in _specs()}


# -- neighbours (spawned; each writes ``ready`` and runs until ``stop``) --

def _neighbour(kind: str, ready: str, stop: str) -> None:
    if kind == "cpu":
        a = np.random.RandomState(0).rand(768, 768)
        Path(ready).touch()
        while not os.path.exists(stop):
            a = np.tanh(a @ a)
        return
    import torch

    from ..core.device_model import CudaEventTimer

    if kind == "idle":
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        Path(ready).touch()
        while not os.path.exists(stop):
            time.sleep(0.05)
        return
    if kind == "contexts":
        src = str(Path(__file__).resolve().parents[2])
        code = ("import torch; from repro_torch.kernels import _build; "
                "torch.cuda.set_device(0); "
                "[_build.load(p.stem) for p in _build.CSRC.glob('*.cu')]; "
                "torch.zeros(1, device='cuda'); torch.cuda.synchronize()")
        env = dict(os.environ, PYTHONPATH=src)
        Path(ready).touch()
        while not os.path.exists(stop):
            subprocess.run([sys.executable, "-c", code], env=env, check=True)
        return
    timer = CudaEventTimer()           # "prober"
    timer.warm()
    _collect_all(timer)
    Path(ready).touch()
    while not os.path.exists(stop):
        _collect_all(timer)


def _with_neighbour(kind: str | None, run):
    if kind is None:
        return run()
    tmp = tempfile.mkdtemp(prefix="interference-")
    ready, stop = os.path.join(tmp, "ready"), os.path.join(tmp, "stop")
    proc = multiprocessing.get_context("spawn").Process(
        target=_neighbour, args=(kind, ready, stop), daemon=True)
    proc.start()
    try:
        deadline = time.monotonic() + 300
        while not os.path.exists(ready):
            if not proc.is_alive() or time.monotonic() > deadline:
                raise RuntimeError(f"the {kind} neighbour did not start")
            time.sleep(0.05)
        time.sleep(1.0)
        return run()
    finally:
        Path(stop).touch()
        proc.join(120)
        if proc.is_alive():
            proc.terminate()
            proc.join(10)


def main() -> int:
    import torch

    from ..core.device_model import CudaEventTimer
    from ..kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    _build.build_all()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)

    class NoRetime(CudaEventTimer):
        RETIMES = 0

    timers = {"retime": CudaEventTimer(), "no_retime": NoRetime()}
    for t in timers.values():
        t.warm()
    _collect_all(timers["retime"])         # first-use costs, not measured

    def measure():
        out = {}
        for mode, timer in timers.items():
            late0 = timer.late
            rounds = [_collect_all(timer) for _ in range(ROUNDS)]
            out[mode] = {"late": timer.late - late0, "rounds": rounds}
        return out

    conditions = [("alone", None)] + [(k, k) for k in NEIGHBOURS] + \
        [("alone_again", None)]
    raw = {}
    for label, kind in conditions:
        t0 = time.perf_counter()
        raw[label] = _with_neighbour(kind, measure)
        print(f"{label}: {time.perf_counter() - t0:.1f} s", flush=True)

    def medians(rounds):
        return {k: np.median([r[k] for r in rounds], axis=0)
                for k in rounds[0]}

    base = {mode: medians(raw["alone"][mode]["rounds"]) for mode in timers}
    report = []
    for label, _ in conditions:
        for mode in timers:
            med = medians(raw[label][mode]["rounds"])
            for kernel in sorted(med):
                ref = base[mode][kernel]
                ratio = med[kernel] / ref
                sums = [float(np.sum(r[kernel]))
                        for r in raw[label][mode]["rounds"]]
                row = {"condition": label, "mode": mode, "kernel": kernel,
                       "rows": int(ref.size),
                       "sum_s": float(np.median(sums)),
                       "sum_ratio": float(np.median(sums)
                                          / np.sum(ref)),
                       "row_ratio_p50": float(np.median(ratio)),
                       "row_ratio_p90": float(np.quantile(ratio, 0.9)),
                       "row_ratio_max": float(np.max(ratio)),
                       "late": raw[label][mode]["late"]}
                report.append(row)
                print(f"{label:12s} {mode:9s} {kernel:24s} "
                      f"sum {row['sum_s'] * 1e3:8.4f} ms  "
                      f"x{row['sum_ratio']:.3f}"
                      f"  rows p50 {row['row_ratio_p50']:.3f} p90 "
                      f"{row['row_ratio_p90']:.3f} max "
                      f"{row['row_ratio_max']:.3f}  late {row['late']}",
                      flush=True)
    print(json.dumps({"card": card, "rounds": ROUNDS, "report": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
