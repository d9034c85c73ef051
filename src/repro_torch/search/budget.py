"""Search budgets: hard caps on probe executions and device-seconds.

The paper's compile-time step must pick probe points "so that the
compile-time analysis cannot overwhelm the compilation time" (Section IV);
the runtime alternative to exhaustive search must likewise be bounded by how
much device time it may burn.  A ``SearchBudget`` carries both limits; a
``BudgetLedger`` is the mutable account one search run charges against.

Both limits are *never exceeded* in the accounting: the search driver
charges a probe batch row by row (in the order the strategy asked for them)
and stops at the last row that still fits -- the deadline-checking runner
model.  Rows past the cut are discarded uncharged; a calibrated
estimate-based pre-cut (see repro/search/driver.py) keeps real oracles from
physically running rows the budget cannot pay for in the first place.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["SearchBudget", "BudgetLedger"]


@dataclass(frozen=True)
class SearchBudget:
    """Immutable search limits.  ``None`` means unbounded on that axis.

    ``max_executions`` counts individual kernel executions (a row probed with
    r repeats costs r); ``max_device_seconds`` counts simulated device time
    actually spent running probes.
    """

    max_executions: int | None = None
    max_device_seconds: float | None = None

    def fingerprint(self) -> dict:
        """JSON-able identity, folded into driver-cache keys: collecting
        under a different budget produces different probe data."""
        return {"max_executions": self.max_executions,
                "max_device_seconds": self.max_device_seconds}

    def ledger(self) -> "BudgetLedger":
        return BudgetLedger(self)

    def split(self, n: int) -> list["SearchBudget"]:
        """Divide the budget evenly into ``n`` sub-budgets (per probe size).

        Floor division on executions; any remainder goes to the first
        sub-budgets so the total never exceeds this budget.
        """
        n = max(int(n), 1)
        execs = [None] * n
        if self.max_executions is not None:
            base, rem = divmod(int(self.max_executions), n)
            execs = [base + (1 if i < rem else 0) for i in range(n)]
        secs = None if self.max_device_seconds is None \
            else self.max_device_seconds / n
        return [SearchBudget(e, secs) for e in execs]


class BudgetLedger:
    """Mutable spend account for one search run."""

    def __init__(self, budget: SearchBudget):
        self.budget = budget
        self.spent_executions = 0
        self.spent_device_seconds = 0.0
        self._exhausted = False

    # -- remaining headroom (None = unbounded) -------------------------------
    @property
    def remaining_executions(self) -> int | None:
        if self.budget.max_executions is None:
            return None
        return max(self.budget.max_executions - self.spent_executions, 0)

    @property
    def remaining_device_seconds(self) -> float | None:
        if self.budget.max_device_seconds is None:
            return None
        return max(
            self.budget.max_device_seconds - self.spent_device_seconds, 0.0)

    def exhausted(self) -> bool:
        if self._exhausted:
            return True
        re, rs = self.remaining_executions, self.remaining_device_seconds
        return (re is not None and re <= 0) or (rs is not None and rs <= 0.0)

    def exhaust(self) -> None:
        """Force-terminate: the next batch did not fit at all."""
        self._exhausted = True

    def charge(self, n_executions: int, device_seconds: float) -> None:
        self.spent_executions += int(n_executions)
        self.spent_device_seconds += float(device_seconds)
