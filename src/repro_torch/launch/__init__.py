"""Launch helpers: the prefill step and the serving-engine builder."""

from .serve import build_engine
from .steps import make_prefill_step

__all__ = ["build_engine", "make_prefill_step"]
