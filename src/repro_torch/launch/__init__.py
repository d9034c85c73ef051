"""Launch helpers: the prefill step and the serving-engine builder."""

from .serve import (build_auto_kernels, build_engine, default_bucket_lattices,
                    default_plan_envelope)
from .steps import make_prefill_step

__all__ = ["build_auto_kernels", "build_engine", "default_bucket_lattices",
           "default_plan_envelope", "make_prefill_step"]
