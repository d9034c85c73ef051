"""The Strategy protocol: ask/tell over a columnar candidate table.

A strategy proposes *row indices* of the feasible ``CandidateTable`` to
probe next (``ask``) and learns from the observed median execution times
(``tell``).  Strategies never see scalar configs or the device oracle --
the search driver (search/driver.py) evaluates every proposal through
the batched ``traffic_table``/``probe_batch`` path and enforces the budget.

One strategy instance drives one search *run*, which may span several probe
data sizes (``start`` is called once per size): cross-size state is what
lets successive halving probe everything at the smallest size and carry only
the top fraction forward.  Strategies carry a ``fingerprint()`` so driver
builds collected under different strategies content-address to different
cache artifacts.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping

import numpy as np

from ..core.kernel_spec import CandidateTable

from .budget import BudgetLedger

__all__ = ["Ask", "SearchContext", "Strategy", "STRATEGIES",
           "register_strategy", "make_strategy", "resolve_strategy"]


@dataclass
class Ask:
    """One probe proposal: table row indices plus a repeat count per row.

    ``device_seconds_cap`` optionally limits how much of the remaining
    device-second budget this batch may consume (successive halving keeps
    headroom for its refinement rungs); None means "whatever remains".
    """

    indices: np.ndarray                     # (m,) int64 rows to probe
    repeats: np.ndarray | int = 1           # scalar or (m,) per-row repeats
    device_seconds_cap: float | None = None


@dataclass
class SearchContext:
    """Everything a strategy may look at for one probe size.

    ``table`` is the *full* feasible candidate set (columnar; no head-cut).
    ``rng`` is the run's seeded generator -- strategies must draw all
    randomness from it so fixed-seed runs are deterministic.
    ``cost_hint`` is a per-row *analytic* roofline time estimate derived
    from the spec's traffic table alone (never from the oracle): since the
    search minimizes execution time, cheap-first probing both stretches the
    device-second budget and concentrates samples where the argmin lives.
    """

    table: CandidateTable
    rng: np.random.RandomState
    D: Mapping[str, int] = field(default_factory=dict)
    default_repeats: int = 1
    cost_hint: np.ndarray | None = None
    # Upper bound on rows the remaining execution budget could ever probe
    # (None = unbounded): lets ordering work stop at budget-many rows.
    max_rows: int | None = None

    @property
    def program_params(self) -> tuple[str, ...]:
        return tuple(self.table.params)

    def __len__(self) -> int:
        return len(self.table)


class Strategy:
    """Base class: subclasses implement ``start``/``ask`` (and ``tell``)."""

    name = "base"

    # True when the strategy carries decisions *across* probe sizes within
    # one run (halving survivors, surrogate training data).  Such a run
    # cannot be sharded per-size: fleet coordinators schedule it as one
    # whole-kernel job, while stateless-per-size strategies (random, lhs)
    # shard into independent per-size jobs.
    cross_size_state = False

    def fingerprint(self) -> dict:
        """JSON-able identity folded into driver-cache keys."""
        return {"name": self.name}

    def begin_run(self) -> None:
        """Reset cross-size state.  Called once at the start of every run
        (a multi-size collect or a single-size search) so a reused strategy
        instance cannot leak survivors from a previous kernel or size."""

    def start(self, ctx: SearchContext) -> None:
        """Begin a new probe size/table.  Called once per size per run."""
        raise NotImplementedError

    def ask(self, ledger: BudgetLedger) -> Ask | None:
        """Next probe proposal, or None when the strategy is done."""
        raise NotImplementedError

    def tell(self, indices: np.ndarray, times: np.ndarray) -> None:
        """Observed median execution times for (a budget-truncated prefix of)
        the last proposal.  ``indices`` are table rows, ``times`` seconds."""


# -- registry ----------------------------------------------------------------

STRATEGIES: dict[str, type] = {}


def register_strategy(cls: type) -> type:
    """Class decorator: make a strategy constructible by name."""
    STRATEGIES[cls.name] = cls
    return cls


def make_strategy(name: str, **kwargs) -> Strategy:
    try:
        cls = STRATEGIES[name]
    except KeyError:
        raise ValueError(
            f"unknown search strategy {name!r}; "
            f"available: {sorted(STRATEGIES)}") from None
    return cls(**kwargs)


def resolve_strategy(strategy: "str | Strategy | None",
                     default: str = "random") -> Strategy:
    """Name, instance, or None (-> ``default``) to a fresh-enough instance."""
    if strategy is None:
        return make_strategy(default)
    if isinstance(strategy, str):
        return make_strategy(strategy)
    return strategy
