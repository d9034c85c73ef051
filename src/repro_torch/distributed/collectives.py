"""Collective helpers: hierarchical and compressed data-parallel means.

The JAX package's ``distributed/collectives.py`` over ``torch.distributed``:
each stage is an ``all_reduce`` over the sub-group of one mesh axis
(``mesh.get_group(axis)``), where the reference runs ``lax.pmean`` inside
``shard_map``.  A stage whose axis the mesh lacks is skipped, as the
reference's docstring says its functions degrade on meshes without a "pod"
axis.

``hierarchical_pmean``: reduce over the fast axis ("data") first, then the
slow cross-pod axis ("pod") -- the two-level schedule that keeps cross-pod
traffic at 1/pod_size of a flat all-reduce.

``compressed_pmean``: the same full-precision mean over "data", then an
int8-quantized mean over "pod" with per-tensor scales; the quantization
residual goes back to the caller, who folds it into the error feedback of
``optim/compression.py``.

The reference's ``shard_map_compat`` is a shim over jax versions and has
no counterpart.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..tree import tree_leaves, tree_unflatten

__all__ = ["hierarchical_pmean", "compressed_pmean"]

f32 = torch.float32


def _group(mesh, axis: str):
    """(the axis's process group, its size), or None if the mesh lacks
    the axis."""
    if axis not in mesh.mesh_dim_names:
        return None
    return mesh.get_group(axis), mesh.size(mesh.mesh_dim_names.index(axis))


def _pmean_(t: torch.Tensor, stage) -> torch.Tensor:
    if stage is not None:
        group, n = stage
        dist.all_reduce(t, group=group)
        t.div_(n)
    return t


def hierarchical_pmean(mesh, tree, ici_axis: str = "data",
                       dcn_axis: str = "pod"):
    """Mean over (ici_axis, dcn_axis) as two stages, ici first.  Each leaf
    is reduced in place (gradients are the step's own: no second copy of
    them is held) and the tree is returned."""
    stages = (_group(mesh, ici_axis), _group(mesh, dcn_axis))
    for g in tree_leaves(tree):
        for stage in stages:
            _pmean_(g, stage)
    return tree


def compressed_pmean(mesh, tree, ici_axis: str = "data",
                     dcn_axis: str = "pod"):
    """Full-precision mean over ``ici_axis`` (in place, as
    ``hierarchical_pmean``), then an int8 mean over ``dcn_axis``: per rank
    and leaf, scale = max |g| / 127 + 1e-30 and q = clip(round(g / scale),
    -127, 127); the pod stage sums q * scale in f32 and divides by the pod
    size.  Returns (mean tree, in each leaf's dtype; residual tree, f32 g -
    q * scale)."""
    ici, dcn = _group(mesh, ici_axis), _group(mesh, dcn_axis)
    means, residuals = [], []
    for g in tree_leaves(tree):
        g32 = _pmean_(g, ici).to(f32)
        scale = torch.max(torch.abs(g32)) / 127.0 + 1e-30
        q = torch.clamp(torch.round(g32 / scale), -127, 127)
        # summed as q * scale in f32, as the reference sums it; a real
        # cross-pod transport would send q (int8) and the scale
        deq = q * scale
        residuals.append(g32 - deq)
        means.append(_pmean_(deq, dcn).to(g.dtype))
    return tree_unflatten(tree, means), tree_unflatten(tree, residuals)
