"""Model-free strategy: seeded random sampling, stratified over the
program parameters.

A pure space-filler over the columnar candidate table -- no feedback from
``tell`` -- and the default way ``collect`` picks which configurations to
probe at each size.
"""

from __future__ import annotations

import numpy as np

from .budget import BudgetLedger
from .strategy import Ask, SearchContext, Strategy, register_strategy

__all__ = ["RandomStrategy"]


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
