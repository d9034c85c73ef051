"""Serving: the continuous-batching engine and token sampling."""

from .engine import Request, ServingEngine
from .sampling import greedy, sample

__all__ = ["Request", "ServingEngine", "greedy", "sample"]
