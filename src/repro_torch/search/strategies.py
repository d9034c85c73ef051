"""Model-free strategies: stratified random and latin-hypercube sampling.

Both are pure space-fillers over the columnar candidate table -- no feedback
from ``tell``.  They are the cheap baselines every budget-aware search needs
(Kernel Tuner ships the same pair for the same reason) and the exploration
phase other strategies build on.  ``random`` is the default way ``collect``
picks which configurations to probe at each size.
"""

from __future__ import annotations

import numpy as np

from .budget import BudgetLedger
from .strategy import Ask, SearchContext, Strategy, register_strategy

__all__ = ["RandomStrategy", "LHSStrategy"]


def _rank_coords(ctx: SearchContext) -> np.ndarray:
    """(n, p) per-param value ranks, normalized to [0, 1].

    Program params are powers of two on a log2 lattice, so the rank of a
    value among its column's sorted unique values IS its log2 position --
    uniform coverage in rank space is uniform coverage of the lattice.
    """
    cols = []
    for p in ctx.program_params:
        uniq, inv = np.unique(ctx.table[p], return_inverse=True)
        denom = max(len(uniq) - 1, 1)
        cols.append(inv.astype(np.float64) / denom)
    return np.stack(cols, axis=1) if cols else np.zeros((len(ctx), 0))


def _cost_banded(order: np.ndarray, ctx: SearchContext,
                 n_bands: int = 4) -> np.ndarray:
    """Stable-sort an ordering into analytic-cost bands, cheapest band first.

    Coarse bands (quartiles by default) keep the stratified coverage *within*
    each band while letting cost-aware strategies probe the cheap region
    first -- more rows fit the device-second budget, and for a time-argmin
    the cheap region is where the answer is.
    """
    if ctx.cost_hint is None or order.size == 0:
        return order
    ranks = np.argsort(np.argsort(ctx.cost_hint, kind="stable"),
                       kind="stable")
    band = (ranks * n_bands) // max(len(ranks), 1)
    return order[np.argsort(band[order], kind="stable")]


def _coverage_order(ctx: SearchContext, repeats: int = 1) -> np.ndarray:
    """Stratified visiting order: greedily pick the row whose (param, value)
    pairs have been visited least, random tiebreak.  Every value of every
    program parameter is covered as early as possible -- the property the
    old even-stride head-cut only had by accident.

    Only the first ``ctx.max_rows / repeats`` picks are materialized
    (``max_rows`` bounds one-repeat rows; a strategy probing each row
    ``repeats`` times affords proportionally fewer): the greedy loop is
    O(rows_ordered * n * p), so a budget that can afford k rows pays for k
    picks, not for ordering the whole table.
    """
    n = len(ctx)
    if ctx.max_rows is None:
        k_total = n
    else:
        r = max(int(repeats), 1)
        k_total = min(n, max((int(ctx.max_rows) + r - 1) // r, 1))
    inv_cols, counts = [], []
    for p in ctx.program_params:
        _, inv = np.unique(ctx.table[p], return_inverse=True)
        inv_cols.append(inv)
        counts.append(np.zeros(int(inv.max()) + 1 if n else 1))
    order = np.empty(k_total, dtype=np.int64)
    remaining = np.ones(n, dtype=bool)
    jitter = ctx.rng.uniform(0.0, 0.5, size=n)   # random, stable tiebreak
    for k in range(k_total):
        score = np.zeros(n)
        for inv, cnt in zip(inv_cols, counts):
            score += cnt[inv]
        score = np.where(remaining, score + jitter, np.inf)
        pick = int(np.argmin(score))
        order[k] = pick
        remaining[pick] = False
        for inv, cnt in zip(inv_cols, counts):
            cnt[inv[pick]] += 1.0
    return order


@register_strategy
class RandomStrategy(Strategy):
    """Seeded random sampling, stratified over the program parameters.

    Rows count as consumed only when ``tell`` confirms them: a batch tail
    the budget enforcer trims is re-proposed by the next ask instead of
    being silently skipped.
    """

    name = "random"

    def __init__(self, batch_size: int = 16):
        self.batch_size = int(batch_size)
        self._order: np.ndarray | None = None
        self._done: np.ndarray | None = None      # aligned with _order
        self._repeats = 1

    def fingerprint(self) -> dict:
        return {"name": self.name, "batch_size": self.batch_size}

    def start(self, ctx: SearchContext) -> None:
        self._repeats = ctx.default_repeats
        self._order = _coverage_order(ctx, self._repeats)
        self._done = np.zeros(len(ctx), dtype=bool)

    def ask(self, ledger: BudgetLedger) -> Ask | None:
        if self._order is None:
            return None
        batch = self._order[~self._done[self._order]][: self.batch_size]
        if not len(batch):
            return None
        return Ask(indices=batch, repeats=self._repeats)

    def tell(self, indices: np.ndarray, times: np.ndarray) -> None:
        if len(indices):
            self._done[np.asarray(indices, dtype=np.int64)] = True


@register_strategy
class LHSStrategy(Strategy):
    """Latin-hypercube sampling over the log2 tile lattice.

    Each ask draws one LHS design of ``batch_size`` points in normalized
    rank space (one stratum per point per parameter, randomly paired across
    parameters) and snaps every point to the nearest still-unvisited row.
    """

    name = "lhs"

    def __init__(self, batch_size: int = 16):
        self.batch_size = int(batch_size)
        self._ctx: SearchContext | None = None
        self._coords: np.ndarray | None = None
        self._unvisited: np.ndarray | None = None
        self._repeats = 1

    def fingerprint(self) -> dict:
        return {"name": self.name, "batch_size": self.batch_size}

    def start(self, ctx: SearchContext) -> None:
        self._ctx = ctx
        self._coords = _rank_coords(ctx)
        self._unvisited = np.ones(len(ctx), dtype=bool)
        self._repeats = ctx.default_repeats

    def ask(self, ledger: BudgetLedger) -> Ask | None:
        if self._ctx is None or not np.any(self._unvisited):
            return None
        rng = self._ctx.rng
        n_left = int(np.sum(self._unvisited))
        m = min(self.batch_size, n_left)
        p = self._coords.shape[1]
        # One LHS design: per param, m strata in random pairing.
        design = np.empty((m, max(p, 1)))
        for j in range(max(p, 1)):
            design[:, j] = (rng.permutation(m) + rng.uniform(0, 1, m)) / m
        design = design[:, :p]
        # Snap against a local copy: rows only count as visited once ``tell``
        # confirms them, so a budget-trimmed tail is re-proposed later.
        free = self._unvisited.copy()
        picked = []
        for s in range(m):
            cand = np.flatnonzero(free)
            d = np.sum((self._coords[cand] - design[s][None, :]) ** 2, axis=1)
            pick = int(cand[np.argmin(d)])
            picked.append(pick)
            free[pick] = False
        return Ask(indices=np.asarray(picked, dtype=np.int64),
                   repeats=self._repeats)

    def tell(self, indices: np.ndarray, times: np.ndarray) -> None:
        if len(indices):
            self._unvisited[np.asarray(indices, dtype=np.int64)] = False
