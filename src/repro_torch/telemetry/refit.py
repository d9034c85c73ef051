"""Refit controller: turn a drift event back into a trustworthy driver.

The reaction to drift is three budget-capped steps sharing one
``SearchBudget`` (the paper's compile-time frugality applied at runtime):

  1. **search** -- a direct ``repro_torch.search`` pass at the exact live
     shape that exposed the drift.  This yields measured evidence: the observed
     argmin config, independent of any fit.
  2. **re-fit** -- a ``Klaraptor.build_driver`` run whose probe points are
     the live traffic shapes (the drifted shape plus scaled-down variants
     for conditioning), producing a corrected rational program that also
     covers shapes the search never visited.  The rebuilt driver is
     hot-swapped into the process registry and written through the artifact
     cache with a bumped ``tuning_version``; older generations are evicted
     (invalidate-on-refit) so the whole fleet converges on the correction.
  3. **validation** -- a tiny probe-off between the refitted driver's choice
     and the search's best config at the drifted shape.  If the measured
     config wins, it is pinned as a per-shape registry override: measured
     evidence outranks the model at shapes where we have it.

Budget accounting is exact: each step runs under its own slice of the total
budget (slices sum to at most the whole), and the realized spend of all
three is reported in the ``RefitResult``.  The spend is the oracle's
accounted device-seconds; on the card (``CudaEventTimer``) a probe's
warm-up launch, L2 flush and spin are not in it, so a refit's wall is a
multiple of it.

The swap moves the registry's generation, so every step plan built before
it goes stale and a serving engine rebuilds its plan and re-captures its
graphed steps on the next step.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from ..core.driver import register_driver, registry
from ..core.kernel_spec import CandidateTable, KernelSpec
from ..core.tuner import Klaraptor
from ..search import SearchBudget, run_search
from ..trace import trace_span

from .config import TelemetryConfig
from .drift import DriftEvent

__all__ = ["RefitController", "RefitResult", "refit_probe_shapes",
           "scale_budget"]


def scale_budget(budget: SearchBudget, fraction: float) -> SearchBudget:
    """A fraction of a budget, floor-rounded so slices never sum past it
    (a 0-execution slice just makes its step a no-op: the total stays a
    hard ceiling even for absurdly small budgets)."""
    ex = None if budget.max_executions is None else \
        int(budget.max_executions * fraction)
    ds = None if budget.max_device_seconds is None else \
        budget.max_device_seconds * fraction
    return SearchBudget(max_executions=ex, max_device_seconds=ds)


def refit_probe_shapes(D, divisors=(1, 2, 4)) -> list[dict]:
    """Live-traffic probe grid: the drifted shape plus scaled-down variants.

    Re-fitting at a single data size leaves the fit's D-direction
    unconstrained (constant design-matrix columns); halved/quartered
    variants pin it down cheaply -- they cost a fraction of the full-size
    probes and keep every point on the live traffic ray instead of a
    synthetic small-size grid.
    """
    shapes, seen = [], set()
    for div in divisors:
        d = {k: max(1, int(v) // div) for k, v in D.items()}
        key = tuple(sorted(d.items()))
        if key not in seen:
            seen.add(key)
            shapes.append(d)
    return shapes


@dataclass
class RefitResult:
    """What one drift reaction did and what it cost."""

    kernel: str
    D: dict                               # live shape that triggered it
    succeeded: bool                       # a corrected driver was swapped in
    searched_config: dict | None          # observed argmin of the search pass
    driver_config: dict | None            # refitted driver's choice at D
    override: dict | None                 # pinned per-shape config (if any)
    cache_version: int                    # tuning generation written (0=none)
    search_device_seconds: float = 0.0
    search_executions: int = 0
    fit_device_seconds: float = 0.0
    fit_executions: int = 0
    validation_device_seconds: float = 0.0
    validation_executions: int = 0
    error: str | None = None
    wall_seconds: float = 0.0
    budget: dict = field(default_factory=dict)     # total-budget fingerprint

    @property
    def total_device_seconds(self) -> float:
        return (self.search_device_seconds + self.fit_device_seconds
                + self.validation_device_seconds)

    @property
    def total_executions(self) -> int:
        return (self.search_executions + self.fit_executions
                + self.validation_executions)


class RefitController:
    """Executes the search -> re-fit -> validate reaction to one drift."""

    def __init__(self, klaraptor: Klaraptor,
                 config: TelemetryConfig | None = None, seed: int = 0):
        self.kl = klaraptor
        self.config = config or TelemetryConfig()
        self._rng = np.random.RandomState(seed)
        self._seed = seed

    # -- budget slicing ------------------------------------------------------
    def _budgets(self, total: SearchBudget
                 ) -> tuple[SearchBudget, SearchBudget, SearchBudget]:
        c = self.config
        val_frac = min(max(c.validation_fraction, 0.0), 0.5)
        rest = 1.0 - val_frac
        search_frac = min(max(c.refit_search_fraction, 0.0), 1.0) * rest
        fit_frac = rest - search_frac
        search_b = scale_budget(total, search_frac)
        fit_b = scale_budget(total, fit_frac)
        val_b = scale_budget(total, val_frac)
        if total.max_executions is not None:
            # Floor rounding strands up to 2 executions; hand them to the
            # search slice (the step that most directly buys recovery
            # quality) so the slices sum exactly to the total, never past.
            leftover = total.max_executions - sum(
                b.max_executions for b in (search_b, fit_b, val_b))
            search_b = SearchBudget(
                max_executions=search_b.max_executions + leftover,
                max_device_seconds=search_b.max_device_seconds)
        return search_b, fit_b, val_b

    def _default_budget(self, spec: KernelSpec, D) -> SearchBudget:
        """~25% of a one-repeat exhaustive pass, in executions (matches
        ``repro_torch.search.default_budget`` without probing anything)."""
        table = spec.candidates(D, self.kl.hw)
        return SearchBudget(max_executions=max(8, len(table) // 4))

    # -- the reaction --------------------------------------------------------
    def refit(self, spec: KernelSpec, drift: DriftEvent) -> RefitResult:
        # One parent span for the whole reaction so the chain reads as a
        # single causal tree in traces: refit -> search -> fit -> validate
        # -> swap (nested under telemetry.observe when drift-triggered).
        with trace_span("refit", kernel=spec.name,
                        rel_error_ewma=drift.rel_error_ewma) as rsp:
            result = self._refit_inner(spec, drift)
            rsp.set(succeeded=result.succeeded,
                    override=result.override is not None,
                    device_seconds=result.total_device_seconds,
                    error=result.error)
            return result

    def _refit_inner(self, spec: KernelSpec,
                     drift: DriftEvent) -> RefitResult:
        t0 = time.perf_counter()
        total = self.config.refit_budget or self._default_budget(spec,
                                                                 drift.D)
        search_b, fit_b, val_b = self._budgets(total)
        result = RefitResult(
            kernel=spec.name, D=dict(drift.D), succeeded=False,
            searched_config=None, driver_config=None, override=None,
            cache_version=0, budget=total.fingerprint())

        # 1. direct search at the drifted live shape: measured evidence.
        with trace_span("refit.search", kernel=spec.name,
                        D=dict(drift.D)) as sp:
            try:
                sr = run_search(spec, self.kl.oracle, drift.D,
                                strategy=self.config.refit_strategy,
                                budget=search_b, hw=self.kl.hw,
                                seed=self._seed)
                result.searched_config = sr.best_config
                result.search_device_seconds = sr.probe_device_seconds
                result.search_executions = sr.n_probe_executions
                best_observed_s = sr.best_observed_time_s
                sp.set(executions=sr.n_probe_executions,
                       device_seconds=sr.probe_device_seconds)
            except ValueError as e:   # infeasible shape: nothing to correct
                result.error = f"search: {e}"
                result.wall_seconds = time.perf_counter() - t0
                return result

        # 2. re-fit on live traffic shapes; hot-swap only if the build lands.
        next_version = 0
        build = None
        with trace_span("refit.fit", kernel=spec.name) as sp:
            try:
                if self.kl.cache is not None:
                    next_version = self.kl.cache.latest_version(
                        spec.name, self.kl.hw.name) + 1
                build = self.kl.build_driver(
                    spec,
                    probe_data=refit_probe_shapes(drift.D),
                    repeats=self.config.refit_repeats,
                    max_configs_per_size=(
                        self.config.refit_max_configs_per_size),
                    seed=self._seed,
                    register=False,
                    use_cache=False,
                    strategy=self.config.refit_strategy,
                    budget=fit_b,
                    cache_version=next_version,
                )
                result.fit_device_seconds = build.probe_device_seconds
                result.fit_executions = build.collected.n_probe_executions
                sp.set(executions=result.fit_executions,
                       device_seconds=result.fit_device_seconds)
            except Exception as e:
                # Budget too small to collect a fittable dataset, degenerate
                # probes, ...: keep the old driver serving; the search result
                # still gives a measured per-shape correction below.
                result.error = f"fit: {type(e).__name__}: {e}"
                sp.set(error=result.error)

        # 3. validate: measured config vs (new) model choice at the shape.
        driver = build.driver if build is not None else None
        with trace_span("refit.validate", kernel=spec.name) as sp:
            if driver is not None:
                try:
                    result.driver_config = driver.choose(drift.D)
                except Exception:
                    result.driver_config = None
            result.override = self._pick_override(
                spec, drift.D, result, best_observed_s, val_b)
            sp.set(override=result.override is not None,
                   executions=result.validation_executions)

        # Hot swap + write-through, atomically from the registry's view:
        # drop every memo describing the old fit, then install the new
        # driver and the override.  Cache eviction last -- a concurrent
        # reader sees either the old generation or the new one, never
        # neither.  A failed re-fit swaps nothing: the old driver keeps
        # serving (a drifted fit beats no fit) with the measured override
        # patching the shape we have evidence for.
        with trace_span("refit.swap", kernel=spec.name) as sp:
            if driver is not None:
                registry.invalidate_kernel(spec.name)
                register_driver(driver)
                result.succeeded = True
                result.cache_version = next_version \
                    if self.kl.cache is not None else 0
                if self.kl.cache is not None:
                    self.kl.cache.invalidate(spec.name, self.kl.hw.name,
                                             below_version=next_version)
            if result.override is not None:
                registry.note_override(spec.name, self.kl.hw.name, drift.D,
                                       result.override)
            sp.set(swapped=driver is not None,
                   cache_version=result.cache_version)
        result.wall_seconds = time.perf_counter() - t0
        return result

    def _pick_override(self, spec: KernelSpec, D, result: RefitResult,
                       best_observed_s: float,
                       val_b: SearchBudget) -> dict | None:
        """Probe-off between the searched and the refitted-driver configs.

        Returns the config to pin as a per-shape override, or None when the
        driver's own choice is measured at least as fast (no override needed
        -- the model is trusted where it demonstrably works).
        """
        searched, chosen = result.searched_config, result.driver_config
        if searched is None:
            return None
        if chosen is None or chosen == searched:
            # No (usable) re-fit: the searched config is the only measured
            # evidence; identical choice needs no pin at all.
            return None if chosen == searched else dict(searched)
        # How many validation repeats fit the budget?  Estimated from the
        # search's best observed time (both rows cost about that much).
        reps = 3
        if val_b.max_executions is not None:
            reps = min(reps, val_b.max_executions // 2)
        if val_b.max_device_seconds is not None and best_observed_s > 0:
            reps = min(reps, int(val_b.max_device_seconds
                                 / (2.0 * best_observed_s)))
        if reps < 1:
            # Cannot afford the probe-off: pin the measured config -- the
            # driver's choice has no observed evidence at this shape.
            return dict(searched)
        try:
            pair = CandidateTable.from_rows(spec.program_params,
                                            [searched, chosen])
            tt = spec.traffic_table(D, pair, self.kl.hw)
            probe = self.kl.oracle.probe_rows(tt, self._rng, repeats=reps)
            result.validation_device_seconds = float(
                np.sum(probe.device_seconds))
            result.validation_executions = int(probe.n_executions)
            if probe.total_time_s[1] <= probe.total_time_s[0]:
                return None                   # model's choice measured fine
            return dict(searched)
        except Exception:
            return dict(searched)
