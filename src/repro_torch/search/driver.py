"""The budget-enforcing search loop over one candidate table.

``search_table`` enumerates nothing itself: given the full feasible
``CandidateTable`` at one data size, it loops the strategy's ask/tell
against the batched device oracle until the budget is spent or the strategy
is done.  Strategies propose *row indices*; the loop evaluates them with
one ``traffic_table``/``probe_rows`` pass per proposal.

Budget enforcement models a deadline-checking sequential runner: within a
proposal, rows are charged in the order the strategy asked for them and the
batch is cut at the last row that still fits the remaining executions and
device-seconds, so the *accounted* spend never exceeds either limit.  A
pre-probe cut by **predicted** per-row spend (the analytic roofline hint,
calibrated online against observed spend) keeps a real oracle from
physically running rows the budget cannot pay for; a post-probe cut by
observed spend makes the accounting exact.

``collect`` (core/collect.py) drives it once per probe size with a shared
strategy and an observer that records the probe metrics for the fitter.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import numpy as np

from ..core.device_model import (H100, DeviceModel, HardwareParams, RowProbe,
                                 TrafficTable, roofline_times)
from ..core.kernel_spec import CandidateTable, KernelSpec
from .budget import BudgetLedger
from .strategy import Ask, SearchContext, Strategy

__all__ = ["analytic_cost_hint", "search_table"]

Dims = Mapping[str, int]

# observer(indices, probe): collect() hooks this to record fit targets.
Observer = Callable[[np.ndarray, RowProbe], None]


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
    hw: HardwareParams = H100,
    default_repeats: int = 1,
    observer: Observer | None = None,
) -> None:
    """Run one strategy pass over one candidate table under ``ledger``."""
    if not len(table):
        return
    tt = spec.traffic_table(D, table, hw)
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
        out = _evaluate(ask, tt, device, rng, ledger, cost_hint, calib)
        if out is None:
            break
        idx, probe = out
        if observer is not None:
            observer(idx, probe)
        strategy.tell(idx, probe.total_time_s)
