"""Data pipeline: deterministic synthetic streams + prefetch."""

from .pipeline import Prefetcher
from .synthetic import SyntheticConfig, SyntheticStream

__all__ = ["Prefetcher", "SyntheticConfig", "SyntheticStream"]
