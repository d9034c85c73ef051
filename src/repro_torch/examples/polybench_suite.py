"""The paper's evaluation: KLARAPTOR over the PolyBench/GPU-analogue suite.

Reproduces the Fig. 1 / Table I experiment: for every suite kernel, build a
driver from small-size probes, then compare its chosen launch configuration
against exhaustive search at large sizes, with the oracle of each row (on
the card, ``CudaEventTimer`` for the matmul rows that launch the f32 SIMT
matmul and ``HopperModel`` for the rest; with ``--device cpu``,
``HopperModel`` for all)::

    python -m repro_torch.examples.polybench_suite [--device cpu]
        [--sizes 1024 2048] [--kernels gemm atax_k1 ...]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..benchmarks.common import build_suite_drivers, selection_ratios


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "polybench_suite")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--sizes", type=int, nargs="+", default=[1024, 2048])
    ap.add_argument("--kernels", nargs="*", default=None)
    args = ap.parse_args(argv)

    hw, drivers = build_suite_drivers(args.kernels, device=args.device)
    print(f"{'kernel':>16} {'N':>6} {'chosen':>14} {'best':>14} {'ratio':>6} "
          f"oracle")
    fmt = "x".join
    ratios = {}
    for r in selection_ratios(drivers, args.sizes, hw):
        ratios[(r["timed"], r["N"])] = r["ratio"]
        print(f"{r['kernel']:>16} {r['N']:>6} "
              f"{fmt(map(str, r['chosen'].values())):>14} "
              f"{fmt(map(str, r['best'].values())):>14} "
              f"{r['ratio']:>6.3f} {r['oracle']}")
    good = sum(1 for r in ratios.values() if r >= 0.85)
    print(f"\nmedian ratio {np.median(list(ratios.values())):.3f}; "
          f"{good}/{len(ratios)} cells >= 0.85 ('good' per paper Fig. 1; "
          f"rows timed as one kernel count once)")


if __name__ == "__main__":
    main()
