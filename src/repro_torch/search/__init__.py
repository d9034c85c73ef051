"""repro_torch.search: pluggable budget-aware search over candidate tables.

One strategy interface (``ask(budget) -> table indices`` / ``tell(times)``)
behind one driver (``run_search``), with hard caps on probe executions and
device-seconds (``SearchBudget``).  Consumers:

  * ``core.collect`` selects compile-time probe points through a strategy
    instead of head-cutting the candidate table;
  * ``core.tuner.search_best`` is the cheap online alternative to
    ``exhaustive_search`` for untuned kernels.

Shipped strategies: ``random`` (seeded, stratified over program params),
``lhs`` (latin hypercube over the log2 tile lattice), ``successive_halving``
(wide at 1 repeat, top fraction refined with more repeats / carried to
larger sizes), ``surrogate`` (fit the rational model on probes-so-far and
spend the tail of the budget on its predicted frontier).  Importing the
package registers all four.
"""

from .budget import BudgetLedger, SearchBudget
from .driver import (SearchResult, TableSearchStats, analytic_cost_hint,
                     default_budget, run_search, search_table)
from .halving import SuccessiveHalvingStrategy
from .strategies import LHSStrategy, RandomStrategy
from .strategy import (Ask, STRATEGIES, SearchContext, Strategy,
                       make_strategy, register_strategy, resolve_strategy)
from .surrogate import SurrogateStrategy

__all__ = [
    "BudgetLedger", "SearchBudget",
    "SearchResult", "TableSearchStats", "analytic_cost_hint",
    "default_budget", "run_search", "search_table",
    "Ask", "STRATEGIES", "SearchContext", "Strategy", "make_strategy",
    "register_strategy", "resolve_strategy",
    "RandomStrategy", "LHSStrategy", "SuccessiveHalvingStrategy",
    "SurrogateStrategy",
]
