"""Surrogate-guided search: spend the tail of the budget on the model's
predicted frontier.

Phase 1 explores with the stratified coverage order.  Once an exploration
fraction of the budget is spent (or a fixed row count, if the budget is
unbounded), phase 2 fits the *existing* rational model machinery
(``fit_auto``, the paper's SVD rational fit) on the probes so far --
observed median time over the program-parameter columns -- and asks for the
unvisited rows the surrogate predicts fastest, refitting after every batch.
This is KLARAPTOR's own modeling loop turned inward: the same fitter that
powers compile-time drivers prices the not-yet-probed configurations.

The fit is "unavailable" -- and the strategy keeps exploring -- when fewer
than four rows are probed, every row is, or the fit or its evaluation
raises one of ``FIT_ERRORS``: an SVD that does not converge
(``np.linalg.LinAlgError``, from the fit's rank checks, its SVD or the
polynomial fallback's least squares) or a floating-point fault in the
monomials or the quotient where the caller has numpy raise on them
(``FloatingPointError``).  Any other exception is a fault and propagates.
"""

from __future__ import annotations

import numpy as np

from ..core.fitting import fit_auto

from .budget import BudgetLedger
from .strategies import _cost_banded, _coverage_order
from .strategy import Ask, SearchContext, Strategy, register_strategy

__all__ = ["FIT_ERRORS", "SurrogateStrategy"]

FIT_ERRORS = (np.linalg.LinAlgError, FloatingPointError)


@register_strategy
class SurrogateStrategy(Strategy):
    name = "surrogate"

    def __init__(self, explore_fraction: float = 0.4, batch_size: int = 8,
                 explore_rows: int = 32, max_num_degree: int = 2,
                 max_den_degree: int = 1):
        self.explore_fraction = float(explore_fraction)
        self.batch_size = int(batch_size)
        self.explore_rows = int(explore_rows)   # cap when budget is unbounded
        self.max_num_degree = int(max_num_degree)
        self.max_den_degree = int(max_den_degree)
        self._ctx: SearchContext | None = None
        self._order: np.ndarray | None = None
        self._cursor = 0
        self._times: np.ndarray | None = None      # nan where unprobed
        self._repeats = 1

    def fingerprint(self) -> dict:
        return {"name": self.name,
                "explore_fraction": self.explore_fraction,
                "batch_size": self.batch_size,
                "explore_rows": self.explore_rows,
                "max_num_degree": self.max_num_degree,
                "max_den_degree": self.max_den_degree}

    def start(self, ctx: SearchContext) -> None:
        self._ctx = ctx
        self._repeats = ctx.default_repeats
        self._order = _cost_banded(_coverage_order(ctx, self._repeats), ctx)
        self._cursor = 0
        self._times = np.full(len(ctx), np.nan)

    # -- phase switch ---------------------------------------------------------
    def _exploring(self, ledger: BudgetLedger) -> bool:
        b = ledger.budget
        fracs = []
        if b.max_executions is not None:
            fracs.append(ledger.spent_executions / max(b.max_executions, 1))
        if b.max_device_seconds is not None:
            fracs.append(
                ledger.spent_device_seconds / max(b.max_device_seconds, 1e-300))
        if fracs:
            return max(fracs) < self.explore_fraction
        return int(np.sum(~np.isnan(self._times))) < \
            min(len(self._ctx), self.explore_rows)

    # -- surrogate ------------------------------------------------------------
    def _frontier(self) -> np.ndarray | None:
        """Unvisited rows ordered by predicted time (best first)."""
        seen = ~np.isnan(self._times)
        if int(np.sum(seen)) < 4 or np.all(seen):
            return None
        params = self._ctx.program_params
        X = np.stack([self._ctx.table[p][seen].astype(np.float64)
                      for p in params], axis=1)
        y = self._times[seen]
        try:
            fit = fit_auto(X, y, params,
                           max_num_degree=self.max_num_degree,
                           max_den_degree=self.max_den_degree)
            X_all = np.stack([self._ctx.table[p].astype(np.float64)
                              for p in params], axis=1)
            pred = np.asarray(fit.function(X_all), dtype=np.float64)
        except FIT_ERRORS:
            return None
        pred = np.where(np.isfinite(pred) & (pred > 0), pred, np.inf)
        pred = np.where(seen, np.inf, pred)       # only unvisited rows
        order = np.argsort(pred, kind="stable")
        return order[np.isfinite(pred[order])]

    def _next_explore_batch(self) -> np.ndarray | None:
        """Next unvisited slice of the coverage order (exploit rounds may
        have visited rows ahead of the cursor)."""
        while self._cursor < len(self._order):
            batch = self._order[self._cursor: self._cursor + self.batch_size]
            self._cursor += len(batch)
            batch = batch[np.isnan(self._times[batch])]
            if len(batch):
                return batch
        return None

    def ask(self, ledger: BudgetLedger) -> Ask | None:
        if self._ctx is None:
            return None
        if self._exploring(ledger):
            batch = self._next_explore_batch()
            return Ask(indices=batch, repeats=self._repeats) \
                if batch is not None else None
        frontier = self._frontier()
        if frontier is None or frontier.size == 0:
            # Fit unavailable (too few probes / degenerate): keep exploring.
            batch = self._next_explore_batch()
            return Ask(indices=batch, repeats=self._repeats) \
                if batch is not None else None
        return Ask(indices=frontier[: self.batch_size],
                   repeats=self._repeats)

    def tell(self, indices: np.ndarray, times: np.ndarray) -> None:
        if len(indices):
            self._times[np.asarray(indices, dtype=np.int64)] = times
