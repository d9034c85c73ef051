"""Launch helpers: the prefill and train steps and the serving-engine
builder (the trainer is ``launch.train``)."""

from .serve import (build_auto_kernels, build_engine, default_bucket_lattices,
                    default_plan_envelope)
from .steps import make_prefill_step, make_train_step

__all__ = ["build_auto_kernels", "build_engine", "default_bucket_lattices",
           "default_plan_envelope", "make_prefill_step", "make_train_step"]
