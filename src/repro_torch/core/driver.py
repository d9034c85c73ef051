"""Driver programs: runtime side of KLARAPTOR (paper Section IV, steps 4-6).

A ``DriverProgram`` wraps the generated rational-program module for one
kernel.  It is what ``kernels/ops.py`` calls immediately before each CUDA
launch -- the IO-builder contract of Section V-C: data parameter values in,
launch parameters out (the tile dict, which fixes the thread-block shape).

A process-wide registry maps kernel-spec names to built drivers so that
model code can ask for tuned launch parameters with one call.  Decisions are
memoized inside the generated module (its _HISTORY table).  On a registry
miss, ``get_driver`` (and so ``choose_or_default``), given the caller's
kernel spec, reads the persistent driver cache (core/cache.py): a driver
built by an earlier process is loaded, not rebuilt.  Only entries tuned for
the hardware at hand and built for that spec under the current kernel
sources (the entry's ``code_digest``) are read, and a kernel the cache does
not hold is remembered as missing until the registry changes.
"""

from __future__ import annotations

import functools
import logging
import threading
from dataclasses import dataclass, field
from typing import Mapping, Sequence

import numpy as np
import torch

from .codegen import compile_driver_module
from .device_model import H100, HardwareParams
from .kernel_spec import KernelSpec

__all__ = ["DriverProgram", "registry", "register_driver",
           "choose_or_default", "dkey", "fit_tile", "get_driver",
           "local_hw", "warm_start_from_cache"]

logger = logging.getLogger(__name__)

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
    tuning_version: int = 0         # the cache generation it was built as

    @classmethod
    def from_source(cls, kernel: str, source: str,
                    hw: HardwareParams = H100,
                    tuning_version: int = 0) -> "DriverProgram":
        return cls(kernel=kernel, source=source,
                   namespace=compile_driver_module(source), hw=hw,
                   tuning_version=tuning_version)

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

    Holds the built drivers, per-shape pinned configs (overrides: an
    override is measured evidence for one shape and outranks the driver's
    model-based choice) and the (kernel, hardware) pairs the driver cache
    was found not to hold.
    """

    def __init__(self) -> None:
        self._drivers: dict[str, DriverProgram] = {}
        self._overrides: dict[tuple, dict[str, int]] = {}
        self._cache_misses: set[tuple[str, str]] = set()
        self._lock = threading.Lock()

    def register(self, driver: DriverProgram) -> None:
        with self._lock:
            self._drivers[driver.kernel] = driver
            self._cache_misses = {m for m in self._cache_misses
                                  if m[0] != driver.kernel}

    def note_cache_miss(self, kernel: str, hw_name: str) -> None:
        with self._lock:
            self._cache_misses.add((kernel, hw_name))

    def known_cache_miss(self, kernel: str, hw_name: str) -> bool:
        return (kernel, hw_name) in self._cache_misses

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
            self._cache_misses.clear()

    def kernels(self) -> list[str]:
        return sorted(self._drivers)


registry = _Registry()


def register_driver(driver: DriverProgram) -> None:
    registry.register(driver)


@functools.lru_cache(maxsize=None)
def local_hw() -> HardwareParams:
    """The hardware a cache read-through serves when its caller names none:
    the card's parameters where there is a card, else the
    compute-capability-9.0 table (what the CPU builds are tuned for)."""
    if torch.cuda.is_available():
        return HardwareParams.from_device("cuda")
    return H100


_bad_entry_warned = False


def _cached_driver(cache, spec: KernelSpec,
                   hw: HardwareParams) -> DriverProgram | None:
    """The newest driver ``cache`` holds for ``spec`` under the current
    kernel sources, tuned for ``hw``, or None if there is none or its
    source does not load (one warning per process: one bad entry must not
    stop a server)."""
    global _bad_entry_warned
    from .cache import code_digest

    entry = cache.lookup_latest(spec.name, hw_name=hw.name,
                                code=code_digest(spec))
    if entry is None:
        return None
    try:
        return DriverProgram.from_source(spec.name, entry.source, hw,
                                         tuning_version=entry.tuning_version)
    except Exception as e:
        if not _bad_entry_warned:
            _bad_entry_warned = True
            logger.warning(
                "cached driver for kernel %s (key %s...) failed to load "
                "(%s: %s); skipping it, and any further bad entry silently",
                spec.name, entry.key[:12], type(e).__name__, e)
        return None


def get_driver(kernel: str, spec: KernelSpec | None = None,
               hw: HardwareParams | None = None) -> DriverProgram | None:
    """The registered driver of ``kernel``; on a registry miss, and given
    the kernel's ``spec``, the newest driver the default cache holds for
    that spec under the current kernel sources, tuned for ``hw`` (default
    ``local_hw()``), which is then registered.  Without a spec only the
    registry is read.  A miss is remembered per kernel and card until the
    registry changes, so an untuned kernel costs one dict lookup."""
    drv = registry.get(kernel)
    if drv is not None or spec is None:
        return drv
    if spec.name != kernel:
        raise ValueError(f"spec {spec.name!r} is not kernel {kernel!r}'s")
    hw = hw or local_hw()
    if registry.known_cache_miss(kernel, hw.name):
        return None
    from .cache import default_cache

    drv = _cached_driver(default_cache(), spec, hw)
    if drv is None:
        registry.note_cache_miss(kernel, hw.name)
        return None
    registry.register(drv)
    return drv


def warm_start_from_cache(specs: Sequence[KernelSpec],
                          hw: HardwareParams | None = None) -> list[str]:
    """Register the cached drivers of ``specs`` tuned for ``hw`` (default
    ``local_hw()``), as a serving process does at start.  Registered
    kernels are left alone; entries of another card or of other kernel
    code, and entries that fail to load, are skipped.  Returns the names
    loaded."""
    from .cache import default_cache

    hw = hw or local_hw()
    cache = default_cache()
    loaded = []
    for spec in specs:
        if registry.get(spec.name) is not None:
            continue
        drv = _cached_driver(cache, spec, hw)
        if drv is not None:
            registry.register(drv)
            loaded.append(spec.name)
    return loaded


def choose_or_default(kernel: str, D: Dims, default: dict[str, int],
                      spec: KernelSpec | None = None) -> dict[str, int]:
    """Launch parameters for ``kernel`` at data size D.

    Order: a pinned per-shape override, then the driver's choice (the
    registered one, else, given the kernel's ``spec``, one read from the
    driver cache, see ``get_driver``), then ``default`` (the static
    heuristic config).  A driver built for other data parameters raises
    KeyError on the missing names and an infeasible D raises ValueError;
    both fall back to ``default`` rather than fail the untuned path.
    """
    override = registry.override(kernel, D)
    if override is not None:
        return dict(override)
    drv = get_driver(kernel, spec)
    if drv is not None:
        try:
            return drv.choose(D)
        except (ValueError, KeyError, TypeError):
            pass
    return dict(default)
