"""Successive halving: probe wide and cheap, refine narrow and confident.

Round 0 probes the (stratified) candidate set once per row; each following
rung keeps the top ``1/eta`` fraction and re-probes it with ``eta`` times
the repeats, so measurement noise shrinks exactly where the decision gets
hard.  Every rung caps its own device-second spend at a fraction of what
remains, keeping headroom for refinement -- the ledger still enforces the
hard budget on top.

Across probe sizes (the collect() use), the survivors of one size seed the
next: the strategy remembers surviving *parameter tuples* and restricts the
next table to matching rows -- "probe everything at 1 repeat on the smallest
probe size, keep the top fraction for larger sizes/repeats".
"""

from __future__ import annotations

import numpy as np

from .budget import BudgetLedger
from .strategies import _cost_banded, _coverage_order
from .strategy import Ask, SearchContext, Strategy, register_strategy

__all__ = ["SuccessiveHalvingStrategy"]


@register_strategy
class SuccessiveHalvingStrategy(Strategy):
    name = "successive_halving"
    cross_size_state = True     # survivors flow between sizes: no per-size shards

    def __init__(self, eta: int = 3, initial_repeats: int = 1,
                 max_repeats: int = 8, max_rounds: int = 4,
                 round_fraction: float = 0.5):
        self.eta = max(int(eta), 2)
        self.initial_repeats = int(initial_repeats)
        self.max_repeats = int(max_repeats)
        self.max_rounds = int(max_rounds)
        self.round_fraction = float(round_fraction)
        self._ctx: SearchContext | None = None
        self._pending: np.ndarray | None = None
        self._repeats = self.initial_repeats
        self._round = 0
        # Cross-size survivors: parameter tuples (columnar bookkeeping, not
        # configs handed to any oracle), None before the first size finishes.
        self._survivor_keys: set[tuple[int, ...]] | None = None

    def fingerprint(self) -> dict:
        return {"name": self.name, "eta": self.eta,
                "initial_repeats": self.initial_repeats,
                "max_repeats": self.max_repeats,
                "max_rounds": self.max_rounds,
                "round_fraction": self.round_fraction}

    def begin_run(self) -> None:
        self._survivor_keys = None

    def _keys(self, indices: np.ndarray) -> list[tuple[int, ...]]:
        t = self._ctx.table
        cols = [t[p] for p in self._ctx.program_params]
        return [tuple(int(c[i]) for c in cols) for i in indices]

    def start(self, ctx: SearchContext) -> None:
        self._ctx = ctx
        self._round = 0
        self._repeats = self.initial_repeats
        order = None
        if self._survivor_keys:
            # Match survivors against the *full* table (the coverage order
            # may be truncated to the execution budget and miss them).
            keys = self._keys(np.arange(len(ctx), dtype=np.int64))
            match = np.flatnonzero(np.asarray(
                [k in self._survivor_keys for k in keys], dtype=bool))
            if match.size:   # lattices may differ across sizes
                if ctx.cost_hint is not None:
                    match = match[np.argsort(ctx.cost_hint[match],
                                             kind="stable")]
                order = match
        if order is None:
            order = _cost_banded(
                _coverage_order(ctx, self.initial_repeats), ctx)
        self._pending = order

    def ask(self, ledger: BudgetLedger) -> Ask | None:
        if self._pending is None or self._pending.size == 0:
            return None
        idx, self._pending = self._pending, None
        cap = None
        rs = ledger.remaining_device_seconds
        if rs is not None:
            cap = rs * self.round_fraction
        return Ask(indices=idx, repeats=self._repeats,
                   device_seconds_cap=cap)

    def tell(self, indices: np.ndarray, times: np.ndarray) -> None:
        if len(indices) == 0:
            return
        order = np.argsort(times, kind="stable")
        keep = max(1, int(np.ceil(len(indices) / self.eta)))
        survivors = np.asarray(indices)[order[:keep]]
        self._survivor_keys = set(self._keys(survivors))
        self._round += 1
        if keep <= 1 or self._round >= self.max_rounds:
            return   # rung collapsed: this size is done
        self._repeats = min(self._repeats * self.eta, self.max_repeats)
        self._pending = survivors
