"""Budget-aware search over candidate tables: what ``collect`` needs.

One strategy interface (``ask(budget) -> table indices`` / ``tell(times)``)
behind one loop (``search_table``), with hard caps on probe executions and
device-seconds (``SearchBudget``).  ``core.collect`` selects its probe points
through a strategy; the shipped strategy is ``random`` (seeded, stratified
over the program parameters).
"""

from .budget import BudgetLedger, SearchBudget
from .driver import analytic_cost_hint, search_table
from .strategies import RandomStrategy
from .strategy import (Ask, STRATEGIES, SearchContext, Strategy,
                       make_strategy, register_strategy, resolve_strategy)

__all__ = [
    "BudgetLedger", "SearchBudget",
    "analytic_cost_hint", "search_table",
    "RandomStrategy",
    "Ask", "STRATEGIES", "SearchContext", "Strategy", "make_strategy",
    "register_strategy", "resolve_strategy",
]
