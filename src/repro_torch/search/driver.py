"""The budget-enforcing search driver.

``run_search`` is the single entry point every consumer goes through
(Kernel Tuner's ``tune``/``minimize`` shape): enumerate the full feasible
``CandidateTable`` at the data size, then loop the strategy's ask/tell
against the batched device oracle until the budget is spent or the strategy
is done.  Strategies propose *row indices*; the driver evaluates them with
one ``traffic_table``/``probe_rows`` pass per proposal -- no scalar config
ever reaches a strategy or leaves the columnar path.  Without ``hw`` the
search takes the oracle's own hardware parameters (``device.hw``): the
card's for ``CudaEventTimer``, the model's for ``HopperModel``.

Budget enforcement models a deadline-checking sequential runner: within a
proposal, rows are charged in the order the strategy asked for them and the
batch is cut at the last row that still fits the remaining executions and
device-seconds, so the *accounted* spend never exceeds either limit.  A
pre-probe cut by **predicted** per-row spend (the analytic roofline hint,
calibrated online against observed spend) keeps a real oracle from
physically running rows the budget cannot pay for; a post-probe cut by
observed spend makes the accounting exact.  On a card-timed oracle the
rows the post-probe cut drops were run all the same: the physically
probed but discarded tail is bounded by the calibration error of a single
batch.

``search_table`` is the per-table inner loop; ``collect``
(core/collect.py) drives it once per probe size with a shared strategy and
an observer that records the probe metrics for the fitter.  Its
``prober_factory`` hook lets ``collect`` hand probe execution to a
``ChunkedProber`` or to the tuning farm's row-shard jobs.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Callable, Mapping

import numpy as np

from ..core.device_model import (DeviceModel, HardwareParams, RowProbe,
                                 TrafficTable, roofline_times)
from ..core.kernel_spec import CandidateTable, KernelSpec
from .budget import BudgetLedger, SearchBudget
from .strategy import Ask, SearchContext, Strategy, resolve_strategy

__all__ = ["SearchResult", "TableSearchStats", "analytic_cost_hint",
           "default_budget", "run_search", "search_table"]

Dims = Mapping[str, int]

# observer(indices, probe): collect() hooks this to record fit targets.
Observer = Callable[[np.ndarray, RowProbe], None]
# prober(indices, repeats) -> RowProbe: an alternative probe executor (the
# farm's chunk-seeded / remote row-shard path); None probes directly.
Prober = Callable[[np.ndarray, np.ndarray], RowProbe]


@dataclass
class TableSearchStats:
    """Per-table outcome of one strategy pass (run_search aggregates these)."""

    best_index: int | None = None
    best_observed_time_s: float = float("inf")
    n_rounds: int = 0
    n_probed_rows: int = 0


@dataclass
class SearchResult:
    """What a budgeted online search found, and what it cost."""

    kernel: str
    D: dict
    strategy: dict                      # strategy fingerprint
    budget: dict                        # budget fingerprint
    best_index: int | None
    best_config: dict | None
    best_observed_time_s: float
    n_candidates: int
    n_probed_rows: int
    n_probe_executions: int
    probe_device_seconds: float
    n_rounds: int
    wall_seconds: float


def default_budget(n_candidates: int) -> SearchBudget:
    """Default online budget: ~25% of a one-repeat exhaustive pass."""
    return SearchBudget(max_executions=max(8, n_candidates // 4))


def analytic_cost_hint(tt: TrafficTable, hw: HardwareParams) -> np.ndarray:
    """Per-row roofline time estimate from the traffic table alone.

    bytes/bandwidth + flops/peak + a generic per-step guess -- purely
    analytic (spec-derived), never probed, so handing it to strategies
    costs no budget and leaks nothing about the oracle.
    """
    t_mem, t_cmp = roofline_times(tt, hw)
    return t_mem + t_cmp + np.asarray(tt.grid_steps, dtype=np.float64) * 1e-6


def _slice_probe(probe: RowProbe, keep: np.ndarray) -> RowProbe:
    return RowProbe(**{f.name: getattr(probe, f.name)[keep]
                       for f in dataclasses.fields(RowProbe)})


class _CostCalibration:
    """Online scale from the analytic cost hint to observed device-seconds."""

    def __init__(self) -> None:
        self.predicted = 0.0
        self.observed = 0.0

    def scale(self) -> float:
        return self.observed / self.predicted if self.predicted > 0 else 1.0

    def update(self, predicted: float, observed: float) -> None:
        self.predicted += float(predicted)
        self.observed += float(observed)


def _evaluate(ask: Ask, tt: TrafficTable, device: DeviceModel,
              rng: np.random.RandomState, ledger: BudgetLedger,
              cost_hint: np.ndarray, calib: _CostCalibration,
              prober: Prober | None = None,
              ) -> tuple[np.ndarray, RowProbe] | None:
    """Probe one proposal under the budget; None if nothing fit at all."""
    idx = np.asarray(ask.indices, dtype=np.int64)
    if idx.size == 0:
        return None
    reps = np.broadcast_to(
        np.maximum(np.asarray(ask.repeats, dtype=np.int64), 1),
        idx.shape).copy()
    re = ledger.remaining_executions
    if re is not None:
        keep = np.cumsum(reps) <= re
        idx, reps = idx[keep], reps[keep]
        if idx.size == 0:
            ledger.exhaust()
            return None
    hard = ledger.remaining_device_seconds
    soft = ask.device_seconds_cap
    cap = hard if soft is None else (soft if hard is None
                                     else min(hard, soft))
    if cap is not None:
        # Pre-probe cut by *predicted* spend; always attempt the first row.
        pred = np.cumsum(cost_hint[idx] * reps) * calib.scale()
        keep = pred <= cap
        keep[0] = True
        idx, reps = idx[keep], reps[keep]
    if prober is not None:
        probe = prober(idx, reps)
    else:
        probe = device.probe_rows(tt.select(idx), rng, reps)
    calib.update(np.sum(cost_hint[idx] * reps), np.sum(probe.device_seconds))
    if cap is not None:
        spend = np.cumsum(probe.device_seconds)
        keep = spend <= cap
        if not np.any(keep) and soft is not None and \
                (hard is None or soft < hard):
            # The strategy's *advisory* cap starved the whole batch: only
            # the hard budget may stop probes.
            keep = spend <= hard if hard is not None \
                else np.ones(idx.shape, dtype=bool)
        if not np.any(keep):
            ledger.exhaust()
            return None
        if not np.all(keep):
            idx = idx[keep]
            probe = _slice_probe(probe, keep)
    ledger.charge(probe.n_executions, float(np.sum(probe.device_seconds)))
    return idx, probe


def search_table(
    spec: KernelSpec,
    device: DeviceModel,
    D: Dims,
    table: CandidateTable,
    strategy: Strategy,
    ledger: BudgetLedger,
    rng: np.random.RandomState,
    hw: HardwareParams | None = None,
    default_repeats: int = 1,
    observer: Observer | None = None,
    prober_factory: Callable[[TrafficTable], Prober] | None = None,
) -> TableSearchStats:
    """Run one strategy pass over one candidate table under ``ledger``
    (``hw``: default the oracle's).

    ``prober_factory(tt)`` (optional) builds the probe executor for this
    table; by default rows go straight to ``device.probe_rows`` with the
    shared ``rng``, in the draw order of a run without the hook.
    """
    stats = TableSearchStats()
    if not len(table):
        return stats
    hw = hw if hw is not None else device.hw
    tt = spec.traffic_table(D, table, hw)
    prober = prober_factory(tt) if prober_factory is not None else None
    cost_hint = analytic_cost_hint(tt, hw)
    calib = _CostCalibration()
    # Upper bound on one-repeat rows the remaining budget could ever probe
    # (4x slack on a device-seconds budget for the hint's optimism).
    max_rows = ledger.remaining_executions
    rs = ledger.remaining_device_seconds
    if rs is not None:
        afford = int(np.searchsorted(
            np.cumsum(np.sort(cost_hint)), rs * 4.0)) + 1
        max_rows = afford if max_rows is None else min(max_rows, afford)
    strategy.start(SearchContext(table=table, rng=rng, D=dict(D),
                                 default_repeats=default_repeats,
                                 cost_hint=cost_hint,
                                 max_rows=max_rows))
    while not ledger.exhausted():
        ask = strategy.ask(ledger)
        if ask is None:
            break
        out = _evaluate(ask, tt, device, rng, ledger, cost_hint, calib,
                        prober)
        if out is None:
            break
        idx, probe = out
        if observer is not None:
            observer(idx, probe)
        strategy.tell(idx, probe.total_time_s)
        best = int(np.argmin(probe.total_time_s))
        if probe.total_time_s[best] < stats.best_observed_time_s:
            stats.best_observed_time_s = float(probe.total_time_s[best])
            stats.best_index = int(idx[best])
        stats.n_rounds += 1
        stats.n_probed_rows += int(idx.size)
    return stats


def run_search(
    spec: KernelSpec,
    device: DeviceModel,
    D: Dims,
    strategy: "str | Strategy | None" = None,
    budget: SearchBudget | None = None,
    hw: HardwareParams | None = None,
    seed: int = 0,
    default_repeats: int = 1,
    observer: Observer | None = None,
) -> SearchResult:
    """Budgeted search for the best launch parameters at one data size.

    The cheap online alternative to ``exhaustive_search``: same argmin
    contract, but probe spend is capped by ``budget`` (default: ~25% of a
    one-repeat exhaustive pass over the feasible set).  ``hw`` defaults to
    the oracle's (``device.hw``).
    """
    t0 = time.perf_counter()
    strategy = resolve_strategy(strategy)
    strategy.begin_run()
    if budget is not None and not isinstance(budget, SearchBudget):
        raise TypeError(
            f"budget must be a repro_torch.search.SearchBudget, got "
            f"{type(budget).__name__}")
    hw = hw if hw is not None else device.hw
    table = spec.candidates(D, hw)
    if not len(table):
        raise ValueError(f"no feasible configuration for {spec.name} at {D}")
    budget = budget if budget is not None else default_budget(len(table))
    ledger = budget.ledger()
    rng = np.random.RandomState(seed)
    stats = search_table(spec, device, D, table, strategy, ledger, rng,
                         hw=hw, default_repeats=default_repeats,
                         observer=observer)
    return SearchResult(
        kernel=spec.name,
        D=dict(D),
        strategy=strategy.fingerprint(),
        budget=budget.fingerprint(),
        best_index=stats.best_index,
        best_config=(table.row(stats.best_index)
                     if stats.best_index is not None else None),
        best_observed_time_s=stats.best_observed_time_s,
        n_candidates=len(table),
        n_probed_rows=stats.n_probed_rows,
        n_probe_executions=ledger.spent_executions,
        probe_device_seconds=ledger.spent_device_seconds,
        n_rounds=stats.n_rounds,
        wall_seconds=time.perf_counter() - t0,
    )
