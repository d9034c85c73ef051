"""Driver programs: runtime side of KLARAPTOR (paper Section IV, steps 4-6).

A ``DriverProgram`` wraps the generated rational-program module for one
kernel.  It is what ``kernels/ops.py`` calls immediately before each CUDA
launch -- the IO-builder contract of Section V-C: data parameter values in,
launch parameters out (the tile dict, which fixes the thread-block shape).

A process-wide registry maps kernel-spec names to built drivers so that
model code can ask for tuned launch parameters with one call
(``choose_or_default``).  A decision is taken in this order: the decision
memo (one dict probe for a shape already decided in this registry
generation), a pinned per-shape override, the kernel's compiled launch plan
(core/plan.py), the driver's ``choose``, and the caller's default.  On a
registry miss, ``get_driver``, given the caller's kernel spec, reads the
persistent driver cache (core/cache.py): a driver built by an earlier
process is loaded, not rebuilt, with the newest plan compiled from it.
Only entries tuned for the hardware at hand and built for that spec under
the current kernel sources (the entry's ``code_digest``) are read, and a
kernel the cache does not hold is remembered as missing until the registry
changes.

Opt-in, ``choose_or_default(..., spec=, device=)`` escalates an undecided
shape to a budgeted online search on the ``device`` oracle (``search/``),
memoized per search configuration.  ``spec=`` alone only reads the driver
cache through: the port's ``spec=`` names the read-through key, so the
search needs the oracle as well.
"""

from __future__ import annotations

import functools
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from .codegen import compile_driver_module
from .device_model import H100, HardwareParams
from .kernel_spec import KernelSpec
from .plan import LaunchPlanTable
from ..trace import trace_span

__all__ = ["ChoiceEvent", "DriverProgram", "WarmStartSummary",
           "choose_or_default", "dkey", "fit_tile", "get_choice_listener",
           "get_driver", "local_hw", "memo_key", "register_driver",
           "registry", "set_choice_listener", "set_decision_memo",
           "warm_start_from_cache"]

logger = logging.getLogger(__name__)

Dims = Mapping[str, int]


@functools.lru_cache(maxsize=4096)
def fit_tile(size: int, tile: int, align: int) -> int:
    """Largest divisor of ``size`` that is <= tile and a multiple of
    ``align`` -- keeps tuned tiles valid for shapes the tuner never saw.
    Memoized: the scan down from ``tile`` would otherwise run on every
    launch, and (size, tile, align) triples recur under steady traffic."""
    tile = min(tile, size)
    t = (tile // align) * align
    while t > align and size % t:
        t -= align
    if t >= align and size % t == 0:
        return t
    return size  # degenerate: single block


def dkey(D: Dims) -> tuple:
    """Canonical hashable form of a data-parameter dict (sorted items):
    the shape key of step plans and of the registry's per-shape tables."""
    return tuple(sorted(D.items()))


def memo_key(kernel: str, hw_name: str, D: Dims) -> tuple:
    """The decision memo's key: D in *insertion* order, not sorted (the
    memo's probe cannot afford the sort; see ``choose_or_default``)."""
    return (kernel, hw_name, tuple(D.items()))


@dataclass(frozen=True)
class ChoiceEvent:
    """One launch-parameter decision, as the choice listener sees it.

    ``source`` names the path that gave the config: ``"driver"``,
    ``"override"`` (a pinned per-shape config), ``"plan"`` (a compiled
    launch plan), ``"search"`` / ``"search_memo"`` (the opt-in search
    escalation, then its memo) or ``"default"``.  ``predicted_s`` is the
    driver's estimate for the returned config, computed only when a
    listener is installed.  ``n_coalesced`` > 1 marks one sampled event
    standing for that many decision-memo hits past the per-entry full
    window.  ``t_ns`` is ``time.monotonic_ns()`` at emission.
    """

    kernel: str
    D: dict
    config: dict
    source: str
    predicted_s: float | None
    hw_name: str
    n_coalesced: int = 1
    t_ns: int | None = None


# The process-wide choice listener: a module global, not a registry field,
# so it survives ``registry.clear()`` and costs one ``is None`` check per
# decision when unused.
_choice_listener: Callable[[ChoiceEvent], None] | None = None
_listener_error_warned = False


def set_choice_listener(
        listener: Callable[[ChoiceEvent], None] | None) -> None:
    """Install (or with None remove) the process-wide choice listener,
    called after every ``choose_or_default`` decision.  What it raises is
    swallowed, with one warning per process: observation must not stop a
    launch."""
    global _choice_listener
    _choice_listener = listener


def get_choice_listener() -> Callable[[ChoiceEvent], None] | None:
    return _choice_listener


def _notify(kernel: str, D: Dims, config: dict, source: str,
            predicted_s: float | None, hw_name: str,
            n_coalesced: int = 1) -> None:
    global _listener_error_warned
    if _choice_listener is None:
        return
    try:
        _choice_listener(ChoiceEvent(
            kernel=kernel, D=dict(D), config=dict(config), source=source,
            predicted_s=predicted_s, hw_name=hw_name,
            n_coalesced=n_coalesced, t_ns=time.monotonic_ns()))
    except Exception:
        if not _listener_error_warned:
            _listener_error_warned = True
            logger.warning(
                "choice listener raised; further listener errors in this "
                "process are suppressed", exc_info=True)


# -- decision memo ------------------------------------------------------------
# A (kernel, hw, D) memo consulted before everything else in
# ``choose_or_default``: a repeated decision is one dict probe, with no
# registry lock and no plan hash.  An entry is valid for one registry
# *generation*: every mutation that could change a decision (a driver
# registered, a kernel invalidated, an override pinned, a plan registered)
# bumps the generation and drops the whole memo.
#
# With a choice listener installed, memo hits still report: the first
# ``MEMO_FULL_WINDOW`` hits of an entry emit one event each (its source,
# a fresh prediction), later hits are coalesced into one event per
# ``MEMO_NOTIFY_EVERY`` carrying their count.  With no listener a hit
# reports nothing.
MEMO_FULL_WINDOW = 16
MEMO_NOTIFY_EVERY = 64

_memo_enabled = True


def set_decision_memo(enabled: bool) -> bool:
    """Turn the decision memo on or off; returns the previous setting.
    ``chip_smoke.py`` phase 21 (e) turns it off to time the chain behind
    it, as the JAX package's ``benchmarks/bench_dispatch.py`` does."""
    global _memo_enabled
    prev = _memo_enabled
    _memo_enabled = bool(enabled)
    return prev


def _predicted(drv: "DriverProgram | None", D: Dims,
               config: dict) -> float | None:
    """The driver's estimate for an emitted event; an estimate that fails
    gives None and never stops the decision."""
    if drv is None:
        return None
    try:
        return drv.estimate(D, config)
    except Exception:
        return None


def _memo_notify(kernel: str, D: Dims, ent: list, hw_name: str) -> None:
    """Report one memo hit: in full inside the entry's window, coalesced
    after it.  ``ent`` is the memo entry [config, source, hits, pending]."""
    ent[2] += 1
    ent[3] += 1
    if ent[2] <= MEMO_FULL_WINDOW:
        ent[3] = 0
        _notify(kernel, D, ent[0], ent[1],
                _predicted(registry.get(kernel), D, ent[0]), hw_name)
        return
    if ent[3] >= MEMO_NOTIFY_EVERY:
        pending, ent[3] = ent[3], 0
        _notify(kernel, D, ent[0], ent[1],
                _predicted(registry.get(kernel), D, ent[0]), hw_name,
                n_coalesced=pending)


@dataclass
class DriverProgram:
    kernel: str
    source: str
    namespace: dict = field(repr=False)
    hw: HardwareParams = H100
    tuning_version: int = 0         # the cache generation it was built as
    # ``cache.code_digest`` of the spec it was built for, under the kernel
    # sources of its build ("" when unknown); compiled plans carry it.
    code: str = ""

    @classmethod
    def from_source(cls, kernel: str, source: str,
                    hw: HardwareParams = H100, tuning_version: int = 0,
                    code: str = "") -> "DriverProgram":
        return cls(kernel=kernel, source=source,
                   namespace=compile_driver_module(source), hw=hw,
                   tuning_version=tuning_version, code=code)

    @property
    def data_params(self) -> tuple[str, ...]:
        return tuple(self.namespace["DATA_PARAMS"])

    @property
    def program_params(self) -> tuple[str, ...]:
        return tuple(self.namespace["PROGRAM_PARAMS"])

    @property
    def source_hash(self) -> str:
        """Identity of the generated module (stamps compiled plans)."""
        h = self.namespace.get("__source_hash__")
        if h is None:
            from .cache import driver_source_hash
            h = driver_source_hash(self.source)
            self.namespace["__source_hash__"] = h
        return h

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

    def choose_many(self, D_table: Mapping[str, np.ndarray],
                    margin: float = 0.02
                    ) -> tuple[dict[str, np.ndarray], np.ndarray]:
        """Selection over S shapes at once.

        ``D_table`` maps each data parameter to a column of S values (or a
        scalar, broadcast).  Returns ``(configs, ok)``: an (S,) int64
        column per program parameter and the (S,) feasibility mask.  A
        driver module generated with ``choose_many`` runs it as one (S, C)
        pass; one without it (a cached driver written before the function
        existed) is asked ``choose`` row by row, with the same results.
        """
        cols = [np.asarray(D_table[d], dtype=np.int64).reshape(-1)
                for d in self.data_params]
        cols = np.broadcast_arrays(*cols)
        n = int(cols[0].shape[0]) if cols else 0
        registry.note_choose_many(n)
        fn = self.namespace.get("choose_many")
        if fn is not None:
            return fn(**dict(zip(self.data_params, cols)), margin=margin)
        out = {p: np.zeros(n, dtype=np.int64) for p in self.program_params}
        ok = np.zeros(n, dtype=bool)
        for s in range(n):
            D = {d: int(c[s]) for d, c in zip(self.data_params, cols)}
            try:
                cfg = self.choose(D, margin=margin)
            except (ValueError, KeyError, TypeError):
                continue
            ok[s] = True
            for p in self.program_params:
                out[p][s] = cfg[p]
        return out, ok


# Distinguishes "never searched" from "searched and failed" in the memo.
_MISS = object()


def _fresh_stats() -> dict[str, int]:
    return {"disk_cache_hits": 0, "disk_cache_misses": 0,
            "plan_hits": 0, "plan_misses": 0,
            "choose_many_calls": 0, "choose_many_rows": 0,
            "plan_invalidations": 0, "memo_invalidations": 0}


class _Registry:
    """Process-wide driver registry consulted by kernels/ops.py.

    Holds the built drivers, per-shape pinned configs (an override is
    measured evidence for one shape and outranks the driver's model-based
    choice), the compiled launch plans, the decision memo, the (kernel,
    hardware) pairs the driver cache was found not to hold, and counters.
    """

    def __init__(self) -> None:
        self._drivers: dict[str, DriverProgram] = {}
        self._overrides: dict[tuple, dict[str, int]] = {}
        self._cache_misses: set[tuple[str, str]] = set()
        # (kernel, hw name, D, strategy, budget) -> the searched config, or
        # None for a failed search (see ``choose_or_default``)
        self._searched: dict[tuple, dict[str, int] | None] = {}
        # (kernel, hw name) -> plan, and the per-shape fills of driver
        # decisions outside its envelope.
        self._plans: dict[tuple[str, str], LaunchPlanTable] = {}
        self._plan_fills: dict[tuple, dict[str, int]] = {}
        # kernel -> the hardware name its decisions are keyed on when the
        # caller names none: the registered driver's, else that of the plan
        # registered for the kernel alone.
        self._hw_names: dict[str, str] = {}
        # Bumped by every mutation that could change a decision; the memo
        # and frozen step plans (core/step_plan.py) compare one int.
        self._generation = 0
        # (kernel, hw name, D items) -> [config, source, hits, pending].
        # Read without the lock (a dict probe is atomic under the GIL) and
        # replaced, never cleared in place, on a bump.
        self._memo: dict[tuple, list] = {}
        self._stats = _fresh_stats()
        self._lock = threading.Lock()

    @property
    def generation(self) -> int:
        return self._generation

    def _bump_generation_locked(self) -> None:
        self._generation += 1
        if self._memo:
            # only bumps that discarded decisions count
            self._stats["memo_invalidations"] += 1
        self._memo = {}

    # -- decision memo --------------------------------------------------------
    def memo_size(self) -> int:
        return len(self._memo)

    def memo_get(self, key: tuple) -> list | None:
        return self._memo.get(key)

    def memo_store(self, generation: int, key: tuple,
                   config: dict[str, int], source: str) -> None:
        """Memoize a decision, unless the registry moved on since it was
        taken (a driver swapped between the decision and this store must
        not pin the old driver's choice)."""
        with self._lock:
            if generation == self._generation:
                self._memo[key] = [dict(config), source, 0, 0]

    def memo_hits(self) -> int:
        """Decision-memo hits of this generation (summed from the entries,
        so the hit path takes no lock)."""
        return sum(e[2] for e in list(self._memo.values()))

    # -- drivers --------------------------------------------------------------
    def register(self, driver: DriverProgram) -> None:
        with self._lock:
            self._drivers[driver.kernel] = driver
            self._hw_names[driver.kernel] = driver.hw.name
            self._cache_misses = {m for m in self._cache_misses
                                  if m[0] != driver.kernel}
            # A plan is frozen output of the driver it was compiled from:
            # another driver retires the kernel's plans, the same module
            # registered again (a cache read-through) keeps them.
            self._drop_plans_locked(driver.kernel,
                                    keep_source_hash=driver.source_hash)
            self._bump_generation_locked()

    def get(self, kernel: str) -> DriverProgram | None:
        return self._drivers.get(kernel)

    def hw_name(self, kernel: str) -> str:
        """The hardware name that keys ``kernel``'s memo entries, overrides
        and plans when a caller names none: the one the registered driver
        was tuned for (a driver built on the cc-9.0 table serves under that
        table's name on a card host too), else that of a plan registered
        without a driver, else ``local_hw()``'s."""
        name = self._hw_names.get(kernel)
        return name if name is not None else local_hw().name

    def note_cache_miss(self, kernel: str, hw_name: str) -> None:
        with self._lock:
            self._cache_misses.add((kernel, hw_name))

    def known_cache_miss(self, kernel: str, hw_name: str) -> bool:
        return (kernel, hw_name) in self._cache_misses

    # -- the search escalation's memo ---------------------------------------
    # Searching costs device time, so a (kernel, hw, D, strategy, budget) is
    # searched at most once per process; ``config=None`` records a failed
    # search (infeasible D, a budget too small for one probe), which would
    # otherwise be paid again at every launch.
    def note_searched(self, key: tuple,
                      config: dict[str, int] | None) -> None:
        with self._lock:
            self._searched[key] = config

    def searched(self, key: tuple):
        """The stored config, None for a memoized failure, ``_MISS`` if
        never searched."""
        return self._searched.get(key, _MISS)

    def note_disk_cache(self, hit: bool) -> None:
        with self._lock:
            self._stats["disk_cache_hits" if hit
                        else "disk_cache_misses"] += 1

    # -- overrides ------------------------------------------------------------
    def note_override(self, kernel: str, hw_name: str, D: Dims,
                      config: dict[str, int]) -> None:
        with self._lock:
            self._overrides[(kernel, hw_name, dkey(D))] = dict(config)
            # outranks every memoized decision and frozen step plan
            self._bump_generation_locked()

    def override(self, kernel: str, hw_name: str,
                 D: Dims) -> dict[str, int] | None:
        return self._overrides.get((kernel, hw_name, dkey(D)))

    # -- compiled launch plans (core/plan.py) ---------------------------------
    def register_plan(self, plan: LaunchPlanTable) -> None:
        """Install a plan for (plan.kernel, plan.hw_name), consulted before
        the driver; a new driver or ``invalidate_kernel`` drops it."""
        with self._lock:
            self._plans[(plan.kernel, plan.hw_name)] = plan
            if plan.kernel not in self._drivers:
                self._hw_names[plan.kernel] = plan.hw_name
            self._bump_generation_locked()

    def plan(self, kernel: str, hw_name: str) -> LaunchPlanTable | None:
        return self._plans.get((kernel, hw_name))

    def plan_lookup(self, kernel: str, hw_name: str,
                    D: Dims) -> dict[str, int] | None:
        """The plan's config for D (then the per-shape fills), or None.
        Hits and misses are counted only for a kernel with a plan."""
        table = self._plans.get((kernel, hw_name))
        if table is None:
            return None
        cfg = table.lookup(D)
        if cfg is None:
            cfg = self._plan_fills.get((kernel, hw_name, dkey(D)))
            if cfg is not None:
                cfg = dict(cfg)
        with self._lock:
            self._stats["plan_hits" if cfg is not None
                        else "plan_misses"] += 1
        return cfg

    def note_plan_fill(self, kernel: str, hw_name: str, D: Dims,
                       config: dict[str, int],
                       source_hash: str | None = None) -> None:
        """A driver decision for a shape outside the plan's envelope joins
        the plan, so a repeat is a probe.  A no-op without a plan, and --
        checked under the lock -- when the plan was compiled from another
        driver than the one that decided (``source_hash``)."""
        with self._lock:
            table = self._plans.get((kernel, hw_name))
            if table is None:
                return
            if source_hash is not None and table.source_hash and \
                    table.source_hash != source_hash:
                return
            self._plan_fills[(kernel, hw_name, dkey(D))] = dict(config)

    def note_choose_many(self, n_shapes: int) -> None:
        with self._lock:
            self._stats["choose_many_calls"] += 1
            self._stats["choose_many_rows"] += int(n_shapes)

    def _drop_plans_locked(self, kernel: str,
                           keep_source_hash: str | None = None) -> None:
        doomed = [k for k, p in self._plans.items()
                  if k[0] == kernel and (keep_source_hash is None
                                         or p.source_hash != keep_source_hash)]
        for k in doomed:
            del self._plans[k]
        self._stats["plan_invalidations"] += len(doomed)
        if doomed or keep_source_hash is None:
            self._plan_fills = {k: v for k, v in self._plan_fills.items()
                                if k[0] != kernel}

    # -- maintenance ----------------------------------------------------------
    def stats(self) -> dict[str, int]:
        """Snapshot of the read-through and dispatch counters."""
        with self._lock:
            return dict(self._stats)

    def invalidate_kernel(self, kernel: str) -> None:
        """Forget the kernel's driver, cache-miss memo, searched shapes,
        overrides and plans (with their fills): the path by which a
        corrected driver replaces one, none of which may outlive the fit
        it came from."""
        with self._lock:
            self._drivers.pop(kernel, None)
            self._hw_names.pop(kernel, None)
            self._cache_misses = {m for m in self._cache_misses
                                  if m[0] != kernel}
            self._searched = {k: v for k, v in self._searched.items()
                              if k[0] != kernel}
            self._overrides = {k: v for k, v in self._overrides.items()
                               if k[0] != kernel}
            self._drop_plans_locked(kernel)
            self._bump_generation_locked()

    def clear(self) -> None:
        with self._lock:
            self._drivers.clear()
            self._hw_names.clear()
            self._overrides.clear()
            self._cache_misses.clear()
            self._searched.clear()
            self._plans.clear()
            self._plan_fills.clear()
            self._bump_generation_locked()
            # after the bump: a full clear resets the counters rather than
            # counting itself as an invalidation
            self._stats = _fresh_stats()

    def kernels(self) -> list[str]:
        return sorted(self._drivers)


registry = _Registry()


def register_driver(driver: DriverProgram) -> None:
    registry.register(driver)


@functools.lru_cache(maxsize=None)
def local_hw() -> HardwareParams:
    """The hardware a decision or cache read serves when its caller names
    none: the card's parameters where there is a card, else the
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
    from .cache import code_digest

    entry = cache.lookup_latest(spec.name, hw_name=hw.name,
                                code=code_digest(spec))
    return None if entry is None else _driver_from_entry(entry, hw)


def _driver_from_entry(entry, hw: HardwareParams) -> DriverProgram | None:
    global _bad_entry_warned
    try:
        return DriverProgram.from_source(entry.kernel, entry.source, hw,
                                         tuning_version=entry.tuning_version,
                                         code=entry.code)
    except Exception as e:
        if not _bad_entry_warned:
            _bad_entry_warned = True
            logger.warning(
                "cached driver for kernel %s (key %s...) failed to load "
                "(%s: %s); skipping it, and any further bad entry silently",
                entry.kernel, entry.key[:12], type(e).__name__, e)
        return None


def _install_plan_if_matching(spec: KernelSpec, drv: DriverProgram | None,
                              hw: HardwareParams, cache) -> bool:
    """Register the newest cached plan of ``spec``'s kernel for ``hw``,
    when it is safe: the plan was compiled for the kernel code the spec
    names now (its ``code`` is ``code_digest(spec)``) and, when a driver
    serves the kernel, from that driver (its ``source_hash``).  A plan of
    other code or of another driver is left on disk.  Returns whether a
    plan was registered.  (The JAX package installs a plan with no driver
    whatever code built it.)"""
    from .cache import code_digest

    entry = cache.lookup_latest_plan(
        spec.name, hw_name=hw.name, code=code_digest(spec),
        source_hash=drv.source_hash if drv is not None else None)
    if entry is None:
        return False
    try:
        table = LaunchPlanTable.from_json(entry.plan)
    except (KeyError, ValueError, TypeError):
        return False
    registry.register_plan(table)
    return True


def get_driver(kernel: str, spec: KernelSpec | None = None,
               hw: HardwareParams | None = None) -> DriverProgram | None:
    """The registered driver of ``kernel``; on a registry miss, and given
    the kernel's ``spec``, the newest driver the default cache holds for
    that spec under the current kernel sources, tuned for ``hw`` (default
    ``local_hw()``), which is then registered together with the newest
    cached plan compiled from it.  Without a spec only the registry is
    read.  A miss is remembered per kernel and card until the registry
    changes, so an untuned kernel costs one dict lookup."""
    drv = registry.get(kernel)
    if drv is not None or spec is None:
        return drv
    if spec.name != kernel:
        raise ValueError(f"spec {spec.name!r} is not kernel {kernel!r}'s")
    hw = hw or local_hw()
    if registry.known_cache_miss(kernel, hw.name):
        return None
    from .cache import default_cache

    cache = default_cache()
    drv = _cached_driver(cache, spec, hw)
    if drv is None:
        registry.note_cache_miss(kernel, hw.name)
        registry.note_disk_cache(hit=False)
        return None
    registry.register(drv)
    registry.note_disk_cache(hit=True)
    _install_plan_if_matching(spec, drv, hw, cache)
    return drv


class WarmStartSummary(list):
    """The kernels whose drivers were loaded (a list), with how many specs
    were already registered (``already_registered``), had no entry
    (``skipped_no_entry``) or an entry that failed to load
    (``skipped_bad``), and which kernels' plans were installed
    (``plans_loaded``)."""

    def __init__(self, loaded: list[str] | None = None) -> None:
        super().__init__(loaded or [])
        self.already_registered = 0
        self.skipped_no_entry = 0
        self.skipped_bad = 0
        self.plans_loaded: list[str] = []

    def as_dict(self) -> dict:
        return {"loaded": list(self),
                "plans_loaded": list(self.plans_loaded),
                "already_registered": self.already_registered,
                "skipped_no_entry": self.skipped_no_entry,
                "skipped_bad": self.skipped_bad}

    def __repr__(self) -> str:
        return (f"WarmStartSummary(loaded={list(self)!r}, "
                f"plans_loaded={self.plans_loaded!r}, "
                f"already_registered={self.already_registered}, "
                f"skipped_no_entry={self.skipped_no_entry}, "
                f"skipped_bad={self.skipped_bad})")


def warm_start_from_cache(specs: Sequence[KernelSpec],
                          hw: HardwareParams | None = None
                          ) -> WarmStartSummary:
    """Register the cached drivers of ``specs`` tuned for ``hw`` (default
    ``local_hw()``; a kernel already registered keeps its driver and reads
    plans of that driver's hardware), as a serving process does at start,
    and the newest
    cached plan of each kernel that matches its code and the driver that
    serves it (see ``_install_plan_if_matching``; a
    plan may serve alone when its driver entry is gone).  Registered
    kernels keep their driver; entries of another card or of other kernel
    code, and entries that fail to load, are skipped.  Loads no kernel
    library and launches nothing."""
    from .cache import code_digest, default_cache

    cache = default_cache()
    summary = WarmStartSummary()
    with trace_span("warm_start", hw=(hw or local_hw()).name) as sp:
        for spec in specs:
            drv = registry.get(spec.name)
            # a registered driver's plans are those of its own hardware
            khw = hw or (drv.hw if drv is not None else local_hw())
            entry = None if drv is not None else cache.lookup_latest(
                spec.name, hw_name=khw.name, code=code_digest(spec))
            if drv is not None:
                summary.already_registered += 1
            elif entry is None:
                summary.skipped_no_entry += 1
            else:
                drv = _driver_from_entry(entry, khw)
                if drv is None:
                    summary.skipped_bad += 1
                else:
                    registry.register(drv)
                    summary.append(spec.name)
            if registry.plan(spec.name, khw.name) is not None:
                continue
            if _install_plan_if_matching(spec, drv, khw, cache):
                summary.plans_loaded.append(spec.name)
        sp.set(loaded=len(summary), plans_loaded=len(summary.plans_loaded),
               skipped_no_entry=summary.skipped_no_entry,
               skipped_bad=summary.skipped_bad)
    return summary


def choose_or_default(kernel: str, D: Dims, default: dict[str, int],
                      spec: KernelSpec | None = None,
                      hw: HardwareParams | None = None, *,
                      device=None, strategy="surrogate",
                      budget=None) -> dict[str, int]:
    """Launch parameters for ``kernel`` at data size D.

    Order: the decision memo serves a (kernel, hw, D) already decided in
    this registry generation in one dict probe; else a pinned per-shape
    override; else the kernel's compiled plan (a probe of precomputed
    choices, core/plan.py); else the driver's choice (the registered one,
    else, given the kernel's ``spec``, one read from the driver cache, see
    ``get_driver``), which then joins the plan; else ``default``.  Every
    decision but the default is memoized with its source, and any registry
    mutation drops the memo, so it never serves a decision the chain would
    no longer take.  A memo hit returns the entry's *shared* config dict:
    callers read launch parameters out of it and never mutate it.

    A driver built for other data parameters raises KeyError on the
    missing names and an infeasible D raises ValueError; both fall back to
    ``default`` rather than fail the untuned path.  ``hw`` scopes the memo,
    the overrides, the plans and the cache read; without it they are keyed
    on ``registry.hw_name(kernel)`` (the registered driver's hardware) and
    the cache is read for ``local_hw()``.  Each decision is reported to the
    choice listener, when one is installed, with the driver's estimate for
    the returned config.

    The search escalation is opt-in: given ``device`` (an oracle:
    ``CudaEventTimer`` on the card, ``HopperModel`` on the CPU) and the
    kernel's ``spec``, a shape that no override, plan or driver decides --
    or whose driver raises on it -- is searched with ``search_best`` under
    ``strategy`` and ``budget`` (a ``SearchBudget``; None for
    ``default_budget``) on ``hw`` (default the oracle's), and the observed
    argmin is returned.  The result is memoized per (kernel, hw, D,
    strategy fingerprint, budget fingerprint), so a shape is searched once
    per search configuration, and a failed search (no feasible config, or
    a budget too small for one probe) is memoized as the default.  The
    listener sees ``"search"``, then ``"search_memo"``.  ``spec`` alone
    never searches (it is the read-through key); ``device`` without
    ``spec`` raises ``ValueError``, an unknown strategy name raises
    ``ValueError`` and a budget that is not a ``SearchBudget`` raises
    ``TypeError``, before anything is probed.
    """
    hw_name = hw.name if hw is not None else registry.hw_name(kernel)
    # The memo key keeps D's insertion order: a sort costs about as much
    # as the whole probe, and a call site builds D the same way every time
    # (two call sites that order one shape differently memoize it twice;
    # both entries die together).
    if _memo_enabled:
        mkey = (kernel, hw_name, tuple(D.items()))
        ent = registry._memo.get(mkey)
        if ent is not None:
            if _choice_listener is not None:
                _memo_notify(kernel, D, ent, hw_name)
            else:
                ent[2] += 1
            return ent[0]
        # taken before resolving: memo_store refuses the entry if the
        # generation moves meanwhile
        gen = registry.generation
    drv = get_driver(kernel, spec, hw)
    override = registry.override(kernel, hw_name, D)
    if override is not None:
        if _memo_enabled:
            registry.memo_store(gen, mkey, override, "override")
        if _choice_listener is not None:
            _notify(kernel, D, override, "override",
                    _predicted(drv, D, override), hw_name)
        return dict(override)
    plan_cfg = registry.plan_lookup(kernel, hw_name, D)
    if plan_cfg is not None:
        if _memo_enabled:
            registry.memo_store(gen, mkey, plan_cfg, "plan")
        if _choice_listener is not None:
            _notify(kernel, D, plan_cfg, "plan",
                    _predicted(drv, D, plan_cfg), hw_name)
        return plan_cfg
    if drv is not None:
        try:
            cfg = drv.choose(D)
        except (ValueError, KeyError, TypeError):
            cfg = None
        if cfg is not None:
            registry.note_plan_fill(kernel, hw_name, D, cfg,
                                    source_hash=drv.source_hash)
            if _memo_enabled:
                registry.memo_store(gen, mkey, cfg, "driver")
            if _choice_listener is not None:
                _notify(kernel, D, cfg, "driver", _predicted(drv, D, cfg),
                        hw_name)
            return cfg
    if device is None:
        # Not memoized: the default is the call site's, and two call sites
        # with different defaults must each get their own.
        if _choice_listener is not None:
            _notify(kernel, D, default, "default", None, hw_name)
        return dict(default)
    return _search_escalation(kernel, D, default, spec, hw, device,
                              strategy, budget)


def _search_escalation(kernel: str, D: Dims, default: dict[str, int],
                       spec: KernelSpec | None, hw: HardwareParams | None,
                       device, strategy, budget) -> dict[str, int]:
    """``choose_or_default``'s opt-in search (see there)."""
    if spec is None:
        # half an opt-in is a caller's bug, which running untuned would hide
        raise ValueError("choose_or_default search escalation needs BOTH "
                         "spec and device; got only device")
    from ..search import SearchBudget, resolve_strategy
    from .tuner import search_best

    hw = hw if hw is not None else device.hw
    # A typo'd strategy name is a configuration error: it raises here, not
    # inside the search's fallback.
    strategy = resolve_strategy(strategy)
    if budget is not None and not isinstance(budget, SearchBudget):
        raise TypeError(f"budget must be a repro_torch.search.SearchBudget, "
                        f"got {type(budget).__name__}")
    # Scoped by strategy and budget: a failure under a tiny budget, or a
    # weak strategy's result, must not serve a caller asking for another
    # search.
    key = (kernel, hw.name, dkey(D),
           dkey(strategy.fingerprint()),
           dkey(budget.fingerprint()) if budget is not None else None)
    hit = registry.searched(key)
    if hit is not _MISS:
        if hit is None:
            _notify(kernel, D, default, "default", None, hw.name)
            return dict(default)
        _notify(kernel, D, hit, "search_memo", None, hw.name)
        return dict(hit)
    try:
        result = search_best(spec, device, D, strategy=strategy,
                             budget=budget, hw=hw)
    except ValueError:          # infeasible D: nothing to search
        result = None
    cfg = result.best_config if result is not None else None
    registry.note_searched(key, cfg)
    if cfg is None:             # infeasible, or no probe fit the budget
        _notify(kernel, D, default, "default", None, hw.name)
        return dict(default)
    _notify(kernel, D, cfg, "search", None, hw.name)
    return dict(cfg)
