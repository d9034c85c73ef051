"""Paper Table I: chosen against best configuration per kernel per size,
each row with its oracle::

    python -m repro_torch.benchmarks.table1_configs [--device cpu]
"""

from __future__ import annotations

from .common import (build_suite_drivers, device_arg, selection_ratios,
                     timed)

SIZES = (1024, 2048)
# The reference's cross-family subset; pass kernels=None for all 28 rows.
DEFAULT_KERNELS = ("gemm", "mm2_k1", "atax_k1", "atax_k2", "bicg_k1",
                   "mvt_k1", "gesummv", "conv2d", "corr", "reduce",
                   "gramschmidt_k1", "syrk", "fdtd_step1", "mean")


def run(kernels=DEFAULT_KERNELS, device="cuda") -> list[dict]:
    hw, drivers = build_suite_drivers(kernels, device=device)
    return [{
        "kernel": r["kernel"], "N": r["N"], "oracle": r["oracle"],
        "chosen": r["chosen"], "chosen_ms": r["chosen_time_s"] * 1e3,
        "best": r["best"], "best_ms": r["best_time_s"] * 1e3,
        "ratio": r["ratio"],
    } for r in selection_ratios(drivers, SIZES, hw)]


def fmt(cfg: dict) -> str:
    return "x".join(str(v) for v in cfg.values())


def main(argv=None) -> list[str]:
    device = device_arg(argv,
                        "python -m repro_torch.benchmarks.table1_configs")
    rows, dt = timed(run, device=device)
    return [f"table1/{r['kernel']}@N{r['N']},{dt / len(rows) * 1e6:.0f},"
            f"chosen={fmt(r['chosen'])}({r['chosen_ms']:.3f}ms) "
            f"best={fmt(r['best'])}({r['best_ms']:.3f}ms) "
            f"ratio={r['ratio']:.3f} oracle={r['oracle']}" for r in rows]


if __name__ == "__main__":
    for ln in main():
        print(ln)
