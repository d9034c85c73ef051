"""Shared benchmark helpers: the suite's oracles, driver building, timing.

Each suite row's oracle is a property of the row, chosen before anything
runs: on a CUDA device the rows that launch a compiled kernel
(``POLYBENCH_LAUNCH_ALIASES``) get ``CudaEventTimer`` and every other row
gets ``HopperModel`` on the card's parameters; with ``device="cpu"`` every
row gets ``HopperModel`` on the compute-capability-9.0 table.  A failed
launch raises; nothing moves a row to another oracle.

A card-timed row is timed as the kernel it launches: its spec renamed to
that kernel (``timed_spec``), so ``CudaEventTimer`` binds it by a kernel
name ``kernels.ops.probe_launcher`` knows.  The nine matmul rows are then
one spec, ``matmul_b32``, and share one build and one driver.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import torch

from ..configs import polybench
from ..core import (BuildResult, CudaEventTimer, DeviceModel, HardwareParams,
                    HopperModel, KernelSpec, Klaraptor)
from ..core.kernel_spec import POLYBENCH_LAUNCH_ALIASES

__all__ = ["SuiteDriver", "build_suite_drivers", "probe_data",
           "row_oracle", "selection_ratios", "timed", "timed_spec"]


def timed(fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


def row_oracle(name: str, device: str | torch.device) -> str:
    """The oracle class that times suite row ``name`` on ``device``."""
    if torch.device(device).type == "cuda" and \
            name in POLYBENCH_LAUNCH_ALIASES:
        return "CudaEventTimer"
    return "HopperModel"


def timed_spec(name: str, device: str | torch.device) -> KernelSpec:
    """The spec row ``name``'s oracle times on ``device``: for a card-timed
    row, the row's spec under the name of the kernel it launches; for any
    other row, the row's own."""
    spec = polybench.suite()[name]
    if row_oracle(name, device) == "CudaEventTimer":
        return dataclasses.replace(spec, name=POLYBENCH_LAUNCH_ALIASES[name])
    return spec


def probe_data(spec: KernelSpec) -> list[dict[str, int]]:
    """The paper's probes: every data parameter at each of PROBE_SIZES."""
    return [dict(zip(spec.data_params, (n,) * len(spec.data_params)))
            for n in polybench.PROBE_SIZES]


@dataclass
class SuiteDriver:
    spec: KernelSpec                # what the oracle times (``timed_spec``)
    build: BuildResult
    oracle: DeviceModel

    @property
    def oracle_name(self) -> str:
        return type(self.oracle).__name__


def build_suite_drivers(kernels=None, device: str | torch.device = "cuda",
                        noise: float = 0.04, seed: int = 11,
                        max_configs_per_size: int = 20, repeats: int = 2,
                        cache=None
                        ) -> tuple[HardwareParams, dict[str, SuiteDriver]]:
    """Build KLARAPTOR drivers for (a subset of) the PolyBench suite.

    Returns the hardware parameters and {row name: SuiteDriver}; rows timed
    as one kernel share one build.  ``cache`` is ``Klaraptor``'s (None: the
    default driver cache; False: build anew).
    """
    hw = HardwareParams.from_device(device)
    model = HopperModel(hw, noise=noise, seed=seed)
    timer = None
    names = list(kernels) if kernels is not None else list(polybench.suite())
    built: dict[str, SuiteDriver] = {}
    out = {}
    for name in names:
        spec = timed_spec(name, device)
        if spec.name not in built:
            if row_oracle(name, device) == "CudaEventTimer":
                timer = timer or CudaEventTimer(hw, device=device, seed=seed)
                oracle = timer
            else:
                oracle = model
            build = Klaraptor(oracle, hw=hw, cache=cache).build_driver(
                spec, probe_data=probe_data(spec), repeats=repeats,
                max_configs_per_size=max_configs_per_size, register=False)
            built[spec.name] = SuiteDriver(spec, build, oracle)
        out[name] = built[spec.name]
    return hw, out


def selection_ratios(drivers: dict[str, SuiteDriver], sizes,
                     hw: HardwareParams) -> list[dict]:
    """``selection_ratio`` of every row at each of ``sizes`` (the paper's
    evaluation points), one exhaustive pass per timed spec and size: rows
    that share a build share its ratio.  Each result carries the row's
    name (``kernel``), its timed spec's (``timed``), N and the oracle."""
    from ..core import selection_ratio

    memo: dict[tuple, dict] = {}
    rows = []
    for name, row in drivers.items():
        for D in polybench.eval_points(row.spec, sizes=tuple(sizes)):
            key = (row.spec.name, tuple(sorted(D.items())))
            if key not in memo:
                memo[key] = selection_ratio(row.spec, row.oracle,
                                            row.build.driver, D, hw)
            rows.append({**memo[key], "kernel": name,
                         "timed": row.spec.name,
                         "N": next(iter(D.values())),
                         "oracle": row.oracle_name})
    return rows


def device_arg(argv, prog: str):
    """Parse ``--device`` (cuda, the default, or cpu) from ``argv``."""
    import argparse

    ap = argparse.ArgumentParser(prog=prog)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv).device
