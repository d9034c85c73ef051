"""Paper Fig. 1: chosen-config time against the exhaustive-search best.

For each suite kernel at N 2048 (the figure's data size), report
best_time / chosen_time with the oracle that timed both -- ratios >= 0.85
are "good" per the paper.  The summary gives each oracle's median ratio and
good count over the distinct kernels it timed::

    python -m repro_torch.benchmarks.fig1_accuracy [--device cpu]
"""

from __future__ import annotations

import numpy as np

from .common import (build_suite_drivers, device_arg, selection_ratios,
                     timed)

N = 2048
GOOD = 0.85


def run(kernels=None, device="cuda") -> list[dict]:
    hw, drivers = build_suite_drivers(kernels, device=device)
    return [{
        "kernel": r["kernel"],
        "timed": r["timed"],
        "oracle": r["oracle"],
        "ratio": r["ratio"],
        "chosen_ms": r["chosen_time_s"] * 1e3,
        "best_ms": r["best_time_s"] * 1e3,
        "chosen": r["chosen"],
        "best": r["best"],
    } for r in selection_ratios(drivers, (N,), hw)]


def summary(rows: list[dict]) -> dict:
    """Median ratio and good count per oracle, over the distinct kernels it
    timed (rows timed as one kernel count once: on the card the nine matmul
    rows are one ``matmul_b32``), and over every row as ``all`` when one
    oracle timed them all."""
    out = {}
    oracles = sorted({r["oracle"] for r in rows})
    for oracle in oracles:
        ratios = list({r["timed"]: r["ratio"] for r in rows
                       if r["oracle"] == oracle}.values())
        out[oracle] = _stats(ratios)
    if len(oracles) == 1:
        out["all"] = _stats([r["ratio"] for r in rows])
    return out


def _stats(ratios: list[float]) -> dict:
    return {"median_ratio": float(np.median(ratios)),
            "good": sum(x >= GOOD for x in ratios), "rows": len(ratios)}


def main(argv=None) -> list[str]:
    device = device_arg(argv, "python -m repro_torch.benchmarks.fig1_accuracy")
    rows, dt = timed(run, device=device)
    lines = [f"fig1/{r['kernel']},{dt / max(len(rows), 1) * 1e6:.0f},"
             f"ratio={r['ratio']:.3f} chosen={r['chosen_ms']:.3f}ms "
             f"best={r['best_ms']:.3f}ms oracle={r['oracle']}"
             for r in rows]
    for oracle, s in summary(rows).items():
        lines.append(f"fig1/summary_{oracle},{dt * 1e6:.0f},"
                     f"median_ratio={s['median_ratio']:.3f} "
                     f"good={s['good']}/{s['rows']}")
    return lines


if __name__ == "__main__":
    for ln in main():
        print(ln)
