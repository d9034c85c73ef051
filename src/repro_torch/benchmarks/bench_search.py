"""Search-strategy benchmark: selection quality vs probe budget.

For every search strategy x kernel, run a budgeted online search
(``search_best``) capped at 25% of the device-seconds an exhaustive pass
over the feasible set spends, and record the paper's Fig. 1 ``ratio``
(best time / time of the chosen config; >= 0.85 is "good") plus the
fraction of the exhaustive budget actually spent::

    python -m repro_torch.benchmarks.bench_search [--device cpu] [--smoke]
                                                  [--out PATH]

The oracle is chosen as ``benchmarks/common.py`` chooses it: the port's
kernels timed on the card (``CudaEventTimer``), or ``HopperModel`` on the
compute-capability-9.0 table with ``--device cpu``.  One exhaustive pass
per kernel gives every candidate's time (``true_time_batch``: the median
of the timer's timed launches on the card, the noise-free model on the
CPU); the ratio reads both the best and the chosen config's time from it.
A search that found nothing scores ratio 0.

The rows are the reference benchmark's four kernels at its sizes on the
port's specs, whose bf16 tables are the compiled tiles (matmul and grouped
matmul 9 rows, flash attention 4, the SSD scan 2), plus the f32 SIMT
matmul and grouped matmul (88 rows each at these sizes), where a quarter
of the exhaustive device-seconds buys more than one or two probes.
``--smoke`` runs only ``matmul_b32`` and exits non-zero unless some
strategy reaches ratio >= 0.85 within the 25% budget.  The JSON report is
written only to ``--out``, never over the reference's
``benchmarks/BENCH_search.json``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from ..core import (CudaEventTimer, DeviceModel, HardwareParams, HopperModel,
                    KernelSpec, exhaustive_pass, flash_attention_spec,
                    matmul_spec, moe_gmm_spec, search_best, ssd_scan_spec)
from ..search import STRATEGIES, SearchBudget

__all__ = ["BUDGET_FRACTION", "GOOD_RATIO", "KERNELS", "main", "run",
           "score"]

BUDGET_FRACTION = 0.25      # of exhaustive probe device-seconds
GOOD_RATIO = 0.85           # the paper's Fig. 1 "good" threshold

MATMUL_D = {"m": 4096, "n": 4096, "k": 4096}
GMM_D = {"e": 8, "g": 4096, "k": 4096, "n": 1536}
KERNELS = [
    (matmul_spec(), MATMUL_D),
    (flash_attention_spec(), {"bh": 64, "sq": 8192, "skv": 8192}),
    (moe_gmm_spec(), GMM_D),
    (ssd_scan_spec(), {"bh": 48, "s": 65536, "chunkflops": 1}),
    (matmul_spec(4), MATMUL_D),
    (moe_gmm_spec(4), GMM_D),
]
SMOKE_KERNEL = "matmul_b32"

# The reference's report; this module never writes it.
_REFERENCE_REPORT = Path(__file__).resolve().parents[3] / "benchmarks" / \
    "BENCH_search.json"


class _RowCounter(DeviceModel):
    """An oracle that counts the rows it probes, so a search's rows that
    were probed but dropped by the budget's post-probe cut show."""

    def __init__(self, oracle: DeviceModel):
        self.oracle = oracle
        self.hw = oracle.hw
        self.rows = 0

    def fingerprint(self) -> dict:
        return self.oracle.fingerprint()

    def probe_rows(self, table, rng, repeats=1):
        self.rows += len(table)
        return self.oracle.probe_rows(table, rng, repeats)


def score(spec: KernelSpec, oracle: DeviceModel, D, hw: HardwareParams,
          times: np.ndarray, strategy: str, budget: SearchBudget,
          seed: int) -> dict:
    """One budgeted search, scored against the exhaustive pass's ``times``:
    the ratio, the spend, the wall seconds and the rows the post-probe cut
    dropped (``n_cut_rows``)."""
    counter = _RowCounter(oracle)
    r = search_best(spec, counter, D, strategy=strategy, budget=budget,
                    hw=hw, seed=seed)
    best_t, exhaustive_s = float(np.min(times)), float(np.sum(times))
    chosen_t = (float(times[r.best_index]) if r.best_index is not None
                else float("inf"))
    return {
        "kernel": spec.name,
        "D": dict(D),
        "strategy": strategy,
        "ratio": best_t / max(chosen_t, 1e-300),
        "budget": r.budget,
        "device_seconds_fraction":
            r.probe_device_seconds / max(exhaustive_s, 1e-300),
        "n_probe_executions": r.n_probe_executions,
        "probe_device_seconds": r.probe_device_seconds,
        "n_probed_rows": r.n_probed_rows,
        "n_cut_rows": counter.rows - r.n_probed_rows,
        "n_candidates": len(times),
        "exhaustive_device_seconds": exhaustive_s,
        "chosen": r.best_config,
        "chosen_time_s": chosen_t,
        "best_time_s": best_t,
        "search_wall_seconds": r.wall_seconds,
    }


def run(kernels=None, device: str | torch.device = "cuda",
        seed: int = 29) -> dict:
    hw = HardwareParams.from_device(device)
    oracle = (CudaEventTimer(hw, device=device, seed=seed)
              if torch.device(device).type == "cuda"
              else HopperModel(hw, noise=0.04, seed=seed))
    rows = []
    for spec, D in (kernels if kernels is not None else KERNELS):
        table, times = exhaustive_pass(spec, oracle, D, hw)
        best = int(np.argmin(times))
        budget = SearchBudget(
            max_device_seconds=BUDGET_FRACTION * float(np.sum(times)))
        for name in sorted(STRATEGIES):
            row = score(spec, oracle, D, hw, times, name, budget, seed)
            row["budget_fraction"] = BUDGET_FRACTION
            row["best"] = table.row(best)
            rows.append(row)
    good = [r for r in rows
            if r["ratio"] >= GOOD_RATIO
            and r["device_seconds_fraction"] <= BUDGET_FRACTION]
    return {
        "budget_fraction": BUDGET_FRACTION,
        "good_ratio_threshold": GOOD_RATIO,
        "seed": seed,
        "oracle": type(oracle).__name__,
        "hw": hw.name,
        "results": rows,
        "n_good": len(good),
        "kernels_with_good_strategy": sorted({r["kernel"] for r in good}),
    }


def main(argv=None) -> list[str]:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.bench_search")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help=f"{SMOKE_KERNEL} only; exit 1 below the bar")
    ap.add_argument("--out", type=Path, default=None,
                    help="write the JSON report here")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if args.out is not None and args.out.resolve() == _REFERENCE_REPORT:
        ap.error(f"{args.out} is the reference's report; pick another path")
    kernels = [(s, D) for s, D in KERNELS if s.name == SMOKE_KERNEL] \
        if args.smoke else KERNELS
    report = run(kernels=kernels, device=args.device)
    if args.out is not None:
        args.out.write_text(json.dumps(report, indent=2))
    lines = [f"search/{r['kernel']}/{r['strategy']},"
             f"{r['search_wall_seconds'] * 1e6:.0f},"
             f"ratio={r['ratio']:.3f} "
             f"dev_frac={r['device_seconds_fraction']:.3f} "
             f"probes={r['n_probe_executions']} "
             f"oracle={report['oracle']}"
             for r in report["results"]]
    covered = set(report["kernels_with_good_strategy"])
    wanted = {spec.name for spec, _ in kernels}
    if not wanted <= covered:
        lines.append(
            f"search/FAIL,0,no strategy reached ratio>={GOOD_RATIO} within "
            f"{BUDGET_FRACTION:.0%} of exhaustive device-seconds on: "
            f"{sorted(wanted - covered)}")
        if args.smoke:
            for ln in lines:
                print(ln)
            sys.exit(1)
    return lines


if __name__ == "__main__":
    for ln in main():
        print(ln)
