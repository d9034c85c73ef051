"""Quickstart: KLARAPTOR end to end on one kernel, the bf16 matmul.

Builds a driver program for ``matmul_b16`` (compile time: probe the nine
compiled wgmma tiles at small sizes, fit rational functions, generate the
driver), then uses it at run time to choose launch parameters for sizes it
never saw, against exhaustive search over the same tiles.  On the card (the
default) the oracle is ``CudaEventTimer``, the kernel timed with CUDA
events, and the sizes are N 1024-16384; with ``--device cpu`` it is
``HopperModel``.  The build goes through the driver cache, so a second run
finds the driver there and probes nothing::

    python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from ..core import (BuildResult, CudaEventTimer, DeviceModel, HardwareParams,
                    HopperModel, KernelSpec, Klaraptor, matmul_spec,
                    selection_ratio)

SIZES = (1024, 2048, 4096, 8192, 16384)


def build(device: str | torch.device = "cuda", cache=None
          ) -> tuple[KernelSpec, DeviceModel, HardwareParams, BuildResult]:
    """The quickstart's build of ``matmul_b16`` on ``device``: probes at m,
    n, k <= 1024, 24 configurations per size, two repeats."""
    hw = HardwareParams.from_device(device)
    if torch.device(device).type == "cuda":
        oracle: DeviceModel = CudaEventTimer(hw, device=device)
    else:
        oracle = HopperModel(hw, noise=0.04, seed=42)
    spec = matmul_spec(dtype_bytes=2)
    result = Klaraptor(oracle, hw=hw, cache=cache).build_driver(
        spec, repeats=2, max_configs_per_size=24)
    return spec, oracle, hw, result


def fmt(cfg: dict) -> str:
    return "x".join(str(v) for v in cfg.values())


def main(argv=None) -> BuildResult:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "quickstart")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    print("== compile time: probe + fit + codegen ==")
    spec, oracle, hw, result = build(args.device)
    print(f"oracle {type(oracle).__name__} on {hw.name}; from the driver "
          f"cache: {result.from_cache}")
    print(result.fit_report())

    print("\n== generated driver program (its functions) ==")
    print("\n".join(ln for ln in result.driver.source.splitlines()
                    if ln.startswith("def ")))

    print("\n== run time: choose launch parameters per data size ==")
    print(f"{'N':>6} {'chosen':>12} {'t_chosen':>11} {'best':>12} "
          f"{'t_best':>11} {'ratio':>6}")
    for n in SIZES:
        r = selection_ratio(spec, oracle, result.driver,
                            {"m": n, "n": n, "k": n}, hw)
        print(f"{n:>6} {fmt(r['chosen']):>12} "
              f"{r['chosen_time_s'] * 1e3:>9.4f}ms {fmt(r['best']):>12} "
              f"{r['best_time_s'] * 1e3:>9.4f}ms {r['ratio']:>6.3f}")
    print("\nratios >= 0.85 are 'good' per the paper (Fig. 1); the driver "
          "probed only N <= 1024.")
    return result


if __name__ == "__main__":
    main()
