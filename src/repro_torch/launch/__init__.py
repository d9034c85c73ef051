"""Launch helpers: meshes, the prefill and train steps and the serving-engine
builder (the trainer is ``launch.train``)."""

from .mesh import make_mesh, make_production_mesh, mesh_chips
from .serve import (build_auto_kernels, build_engine, default_bucket_lattices,
                    default_plan_envelope)
from .steps import build_sharder, make_prefill_step, make_train_step

__all__ = ["build_auto_kernels", "build_engine", "build_sharder",
           "default_bucket_lattices", "default_plan_envelope", "make_mesh",
           "make_prefill_step", "make_production_mesh", "make_train_step",
           "mesh_chips"]
