"""Meshes: named ``torch.distributed`` device meshes, as the JAX package's
``launch/mesh.py`` builds named jax meshes.

``make_mesh(shape, axes)`` returns a ``DeviceMesh`` whose dims are named
``axes``.  If this process has no process group yet, it starts one: NCCL
for ``device="cuda"`` (the default), gloo for ``"cpu"``.  The rank and the
world size come from ``RANK`` / ``WORLD_SIZE`` (and the card from
``LOCAL_RANK``), as ``torchrun --nproc-per-node N`` sets them, with the
rendezvous at ``MASTER_ADDR`` / ``MASTER_PORT``; without them the world
is this one process.  A process group that fails to start raises: there is
no quiet single-process fallback.

``AbstractMesh(shape, axes)`` is a mesh's shape and names alone, as
``jax.sharding.AbstractMesh``: ``Sharder`` computes shardings over it
(any size, no processes), and nothing can run on it.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..core.device_model import resolve_device

__all__ = ["AbstractMesh", "make_mesh", "make_production_mesh", "mesh_chips"]


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's dim sizes and names, with no processes behind it."""

    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.mesh_dim_names):
            raise ValueError(f"mesh shape {self.shape} and names "
                             f"{self.mesh_dim_names} differ in length")


def mesh_chips(mesh) -> int:
    return math.prod(tuple(mesh.shape))


def _init_process_group(device: torch.device) -> None:
    if dist.is_initialized():
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    card = None                          # the card NCCL binds this rank to
    if device.type == "cuda":
        card = torch.device("cuda", int(os.environ.get(
            "LOCAL_RANK", torch.cuda.current_device())))
        torch.cuda.set_device(card)
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]),
                                device_id=card)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, device_id=card)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device: str | torch.device = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the world's ranks, its dims named
    ``axes`` (rank-major: the last axis varies fastest, as in a jax mesh)."""
    device = resolve_device(device)
    shape, axes = tuple(shape), tuple(axes)
    _init_process_group(device)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {shape} {axes} needs "
                         f"{math.prod(shape)} ranks; the world has {world}")
    return init_device_mesh(device.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device = "cuda"):
    """16 x 16 ranks ("data", "model"); 2 pods add an outer "pod" axis.
    Raises unless the world has that many ranks (256 or 512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)
