"""Pipeline parallelism: a GPipe microbatch schedule over a mesh axis.

The JAX package's ``distributed/pipeline_parallel.py``: with M microbatches
and S stages, tick t in [0, M + S - 1) runs stage s on microbatch t - s,
and each stage's output goes to stage s + 1 for the next tick; the bubble
fraction is (S - 1) / (M + S - 1).  Rank i of the axis's process group
holds stage i; the hand-over is ``dist.batch_isend_irecv`` (the
reference's ``ppermute``), and the outputs the last stage banks reach
every rank as a sum over the group (the reference's ``psum``).

One difference in what runs: the reference's traced loop also computes on
a stage's invalid ticks (t - s outside [0, M)) and discards the result;
the port skips them, so each stage calls ``stage_fn`` exactly M times.

``send`` / ``recv`` carry no autograd, so inputs and stage parameters that
require grad are refused: a backward through this schedule would silently
stop at the first hand-over.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..tree import tree_leaves, tree_map

__all__ = ["gpipe_forward", "bubble_fraction"]


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)


def gpipe_forward(stage_fn: Callable, stage_params, x: torch.Tensor, mesh,
                  axis: str = "pipe") -> torch.Tensor:
    """Run x (n_micro, micro_batch, ...) through the stages on mesh axis
    ``axis``; ``stage_fn(stage_params, h) -> h`` keeps the shape, and
    ``stage_params``'s leaves have a leading n_stages dim.  Every rank
    passes the same ``x`` and gets the stacked outputs (n_micro,
    micro_batch, ...)."""
    if x.requires_grad or any(t.requires_grad
                              for t in tree_leaves(stage_params)):
        raise NotImplementedError(
            "gpipe_forward carries no gradient (send / recv are not "
            "differentiable): pass inputs and stage parameters that do not "
            "require grad")
    group = mesh.get_group(axis)
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    stage = mesh.get_local_rank(axis)
    params = tree_map(lambda p: p[stage], stage_params)
    n_micro = x.shape[0]
    nxt = dist.get_global_rank(group, stage + 1) \
        if stage < n_stages - 1 else None
    prv = dist.get_global_rank(group, stage - 1) if stage > 0 else None
    buf = torch.zeros_like(x)                      # the last stage's outputs
    carry = None
    for t in range(n_micro + n_stages - 1):
        m = t - stage                              # this stage's microbatch
        ops, out, incoming = [], None, None
        if 0 <= m < n_micro:
            out = stage_fn(params, x[m] if stage == 0 else carry)
            if nxt is None:
                buf[m] = out
            else:
                out = out.contiguous()
                ops.append(dist.P2POp(dist.isend, out, nxt, group))
        if prv is not None and 0 <= m + 1 < n_micro:   # stage - 1's output
            incoming = torch.empty_like(x[0])
            ops.append(dist.P2POp(dist.irecv, incoming, prv, group))
        for req in dist.batch_isend_irecv(ops) if ops else ():
            req.wait()
        carry = incoming
    dist.all_reduce(buf, group=group)              # only the last is nonzero
    return buf
