"""Launch helpers: the prefill step and the serving-engine builder."""

from .serve import build_auto_kernels, build_engine
from .steps import make_prefill_step

__all__ = ["build_auto_kernels", "build_engine", "make_prefill_step"]
