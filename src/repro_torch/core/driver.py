"""Driver programs: runtime side of KLARAPTOR (paper Section IV, steps 4-6).

A ``DriverProgram`` wraps the generated rational-program module for one
kernel.  It is what ``kernels/ops.py`` calls immediately before each CUDA
launch -- the IO-builder contract of Section V-C: data parameter values in,
launch parameters out (the tile dict, which fixes the thread-block shape).

A process-wide registry maps kernel-spec names to built drivers so that
model code can ask for tuned launch parameters with one call.  Decisions are
memoized inside the generated module (its _HISTORY table).
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass, field
from typing import Mapping

import numpy as np

from .codegen import compile_driver_module
from .device_model import H100, HardwareParams

__all__ = ["DriverProgram", "registry", "register_driver",
           "choose_or_default", "dkey", "fit_tile"]

Dims = Mapping[str, int]


@functools.lru_cache(maxsize=4096)
def fit_tile(size: int, tile: int, align: int) -> int:
    """Largest divisor of ``size`` that is <= tile and a multiple of
    ``align`` -- keeps tuned tiles valid for shapes the tuner never saw."""
    tile = min(tile, size)
    t = (tile // align) * align
    while t > align and size % t:
        t -= align
    if t >= align and size % t == 0:
        return t
    return size  # degenerate: single block


def dkey(D: Dims) -> tuple:
    """Canonical hashable form of a data-parameter dict."""
    return tuple(sorted(D.items()))


@dataclass
class DriverProgram:
    kernel: str
    source: str
    namespace: dict = field(repr=False)
    hw: HardwareParams = H100

    @classmethod
    def from_source(cls, kernel: str, source: str,
                    hw: HardwareParams = H100) -> "DriverProgram":
        return cls(kernel=kernel, source=source,
                   namespace=compile_driver_module(source), hw=hw)

    # -- step 4: rational program evaluation ---------------------------------
    def estimate(self, D: Dims, P: Dims) -> float:
        return float(self.namespace["estimate"](**{**D, **P}))

    def estimate_batch(self, D: Dims,
                       columns: Mapping[str, np.ndarray]) -> np.ndarray:
        """Vectorized E over a columnar candidate table: one ndarray pass."""
        est = self.namespace["estimate"](**{**D, **columns})
        return np.asarray(est, dtype=np.float64)

    def candidates(self, D: Dims) -> dict[str, np.ndarray]:
        """Columnar feasible table: one int64 ndarray per program param."""
        return self.namespace["candidates"](**D)

    # -- steps 5-6: selection (memoized) --------------------------------------
    def choose(self, D: Dims, margin: float = 0.02) -> dict[str, int]:
        return self.namespace["choose"](**D, margin=margin)


class _Registry:
    """Process-wide driver registry consulted by kernels/ops.py.

    Holds the built drivers and per-shape pinned configs (overrides): an
    override is measured evidence for one shape and outranks the driver's
    model-based choice.
    """

    def __init__(self) -> None:
        self._drivers: dict[str, DriverProgram] = {}
        self._overrides: dict[tuple, dict[str, int]] = {}
        self._lock = threading.Lock()

    def register(self, driver: DriverProgram) -> None:
        with self._lock:
            self._drivers[driver.kernel] = driver

    def get(self, kernel: str) -> DriverProgram | None:
        return self._drivers.get(kernel)

    def note_override(self, kernel: str, D: Dims,
                      config: dict[str, int]) -> None:
        with self._lock:
            self._overrides[(kernel, dkey(D))] = dict(config)

    def override(self, kernel: str, D: Dims) -> dict[str, int] | None:
        return self._overrides.get((kernel, dkey(D)))

    def clear(self) -> None:
        with self._lock:
            self._drivers.clear()
            self._overrides.clear()

    def kernels(self) -> list[str]:
        return sorted(self._drivers)


registry = _Registry()


def register_driver(driver: DriverProgram) -> None:
    registry.register(driver)


def choose_or_default(kernel: str, D: Dims,
                      default: dict[str, int]) -> dict[str, int]:
    """Launch parameters for ``kernel`` at data size D.

    Order: a pinned per-shape override, then the registered driver's
    choice, then ``default`` (the static heuristic config).  A driver built
    for other data parameters raises KeyError on the missing names and an
    infeasible D raises ValueError; both fall back to ``default`` rather
    than fail the untuned path.
    """
    override = registry.override(kernel, D)
    if override is not None:
        return dict(override)
    drv = registry.get(kernel)
    if drv is not None:
        try:
            return drv.choose(D)
        except (ValueError, KeyError, TypeError):
            pass
    return dict(default)
