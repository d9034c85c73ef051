"""Tensor and sequence parallelism over "model" and FSDP over "data" in the
train step, as Megatron-style local tensors.

The JAX package shards its train step by constraints alone
(``sharder.act``) and lets XLA place the collectives.  The port holds each
rank's block of every parameter (``TensorSharding.local``) and calls the
collectives where the reference's constraints name them, each a
``torch.autograd.Function`` whose backward is written out, over the process
group of one mesh axis (``DeviceMesh.get_group``):

* ``gather_seq`` / ``scatter_seq``: the sequence-parallel pair around every
  attention and MLP layer.  With the residual split by sequence (the spec
  of ("batch", "act_seq", "act_embed") splits dim 1 over "model"),
  gather-seq all-gathers dim 1 (backward: reduce-scatter) and scatter-seq
  reduce-scatters the row-parallel product's partial sums into the
  residual's rows (backward: all-gather).  Where the sequence does not
  divide by "model" the reference drops ``act_seq`` and the residual is
  replicated: gather-seq is then the identity and scatter-seq the
  all-reduce of ``copy_to_model(reduce_from_model(y))``.
* ``reduce_from_model`` (forward all-reduce, backward identity) and
  ``copy_to_model`` (forward identity, backward all-reduce).
* ``fsdp_gather``: a leaf's "embed" blocks all-gathered over "data" before
  its layer uses it (backward: the gradient reduce-scattered over "data",
  summed).

Gradients.  Outside the layers' tensor-parallel regions each rank's
gradient is a part of the whole, which the sum over "model" restores: the
exact gradient of its own rows under sequence parallelism; without it, a
share, since the backward of scatter-seq all-reduces the shares before a
region needs the whole.  Inside a region a parameter that "model" does not
split (qk-norm's scale, the dropped kv projections) gets the part its heads
give.  So every leaf that "model" does not split is summed over "model",
whether or not the residual is split by sequence, and no leaf that it
splits is: the step decides from each leaf's partition spec alone
(``launch.steps``).

Every rank issues the same collectives in the same order: the layers call
them in program order, the backward runs the graph every rank built, and
remat "full" recomputes a block's gathers and scatters inside the block.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
import torch.distributed as dist

from ..models.module import spec_leaves
from ..tree import tree_map, tree_paths
from .sharding import (PartitionSpec, Sharder, _names, mesh_shape,
                       tp_refusal)

__all__ = ["Axis", "TensorParallel", "copy_to_model", "fsdp_gather",
           "gather_full", "local_tree", "mesh_axis", "reduce_from_model",
           "same_on_replicas", "sharded_step"]


@dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its process group, its size
    and this rank's index along it."""

    name: str
    group: object
    size: int
    index: int


def mesh_axis(mesh, name: str) -> Axis | None:
    """``name``'s ``Axis`` on a ``DeviceMesh``; None if the mesh lacks
    it."""
    if mesh is None or name not in mesh.mesh_dim_names:
        return None
    return Axis(name, mesh.get_group(name), mesh_shape(mesh)[name],
                mesh.get_local_rank(name))


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

def _all_gather(x: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
    """The ranks' blocks of ``ax`` concatenated along ``dim``, in rank
    order."""
    # both collectives take the rank axis folded into dim 0
    x = x.contiguous()
    buf = x.new_empty((ax.size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(buf, x, group=ax.group)
    shape = list(x.shape)
    shape[dim] *= ax.size
    return buf.unflatten(0, (ax.size, x.shape[0])).movedim(0, dim
                                                           ).reshape(shape)


def _reduce_scatter(x: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``x`` over ``ax``."""
    parts = x.unflatten(dim, (ax.size, x.shape[dim] // ax.size))
    parts = parts.movedim(dim, 0).contiguous()
    out = parts.new_empty(parts.shape[1:])
    dist.reduce_scatter_tensor(out, parts.flatten(0, 1), group=ax.group)
    return out


def _all_reduce(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=ax.group)
    return out


class _Gather(torch.autograd.Function):
    """Forward all-gather along ``dim``, backward reduce-scatter."""

    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return _all_gather(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.ax), None, None


class _Scatter(torch.autograd.Function):
    """Forward reduce-scatter along ``dim``, backward all-gather."""

    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return _reduce_scatter(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.ax), None, None


class _Reduce(torch.autograd.Function):
    """Forward all-reduce, backward identity."""

    @staticmethod
    def forward(ctx, x, ax):
        return _all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    """Forward identity, backward all-reduce."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.ax), None


def reduce_from_model(x: torch.Tensor, ax: Axis | None) -> torch.Tensor:
    """The sum of ``x`` over ``ax`` (forward all-reduce, backward
    identity); ``x`` without the axis."""
    return x if ax is None else _Reduce.apply(x, ax)


def copy_to_model(x: torch.Tensor, ax: Axis | None) -> torch.Tensor:
    """``x`` (forward identity, backward all-reduce over ``ax``)."""
    return x if ax is None else _Copy.apply(x, ax)


def fsdp_gather(x: torch.Tensor, spec: PartitionSpec, mesh) -> torch.Tensor:
    """A leaf's block with every dim that an axis other than "model"
    splits gathered whole (the minor axis first), the "model" split kept:
    forward all-gather, backward reduce-scatter of the gradient."""
    for dim, assign in enumerate(spec):
        for name in reversed(_names(assign)):
            if name != "model":
                x = _Gather.apply(x, dim, mesh_axis(mesh, name))
    return x


@torch.no_grad()
def gather_full(x: torch.Tensor, spec: PartitionSpec, mesh) -> torch.Tensor:
    """The whole tensor of which ``x`` is this rank's block under ``spec``
    (every rank gets it; no autograd)."""
    for dim, assign in enumerate(spec):
        for name in reversed(_names(assign)):
            x = _all_gather(x, dim, mesh_axis(mesh, name))
    return x


# ---------------------------------------------------------------------------
# a train step's layout
# ---------------------------------------------------------------------------

def sharded_step(sharder: Sharder | None, specs, cfg) -> bool:
    """Whether a train step of ``cfg`` over ``sharder`` runs the
    tensor-parallel layers: its mesh has a "model" axis larger than 1 or
    shards a leaf of ``specs`` over an axis larger than 1 (where
    ``Sharder.check_runnable`` admits only the dense attention decoders),
    or it is such a decoder on a mesh with a "model" axis of size 1 (the
    layers' collectives then move nothing, and a one-card mesh runs
    them).  Otherwise every leaf is replicated, the layers are the
    one-process ones and the step is data parallel."""
    if sharder is None or sharder.mesh is None:
        return False
    sizes = mesh_shape(sharder.mesh)
    if sizes.get("model", 1) > 1 or any(
            sizes[a] > 1
            for _, s in spec_leaves(specs)
            for assign in sharder.pspec(s.shape, s.axes or
                                        (None,) * len(s.shape), record=False)
            for a in _names(assign)):
        return True
    return "model" in sizes and tp_refusal(cfg) is None


class TensorParallel:
    """One train step's layout on a ``Sharder``'s mesh: the "model" axis,
    whether the residual is split by sequence, every parameter's partition
    spec, and the collectives the layers call.

    ``shardings`` is the parameters' tree of ``TensorSharding``; ``rows``
    and ``seq`` are the global batch's rows and the sequence length of the
    model's inputs."""

    def __init__(self, sharder: Sharder, shardings, rows: int, seq: int,
                 d_model: int):
        self.sharder = sharder
        self.mesh = sharder.mesh
        self.model = mesh_axis(self.mesh, "model")
        self.rows, self.seq = rows, seq
        self.residual = (rows, seq, d_model)
        spec = sharder.pspec(self.residual,
                             ("batch", "act_seq", "act_embed"), record=False)
        self.seq_split = "model" in _names(spec[1])
        self.specs = tree_map(lambda sh: sh.spec, shardings)

    @property
    def m(self) -> int:
        return self.model.size if self.model is not None else 1

    @property
    def r(self) -> int:
        return self.model.index if self.model is not None else 0

    def check(self, x: torch.Tensor, axes: Sequence[str | None],
              shape: Sequence[int]) -> torch.Tensor:
        """``Sharder.act``: ``x`` must be this rank's block of ``shape``."""
        return self.sharder.act(x, axes, shape)

    def check_residual(self, x: torch.Tensor) -> torch.Tensor:
        return self.check(x, ("batch", "act_seq", "act_embed"),
                          self.residual)

    # -- the sequence-parallel pair --------------------------------------
    def gather_seq(self, x: torch.Tensor) -> torch.Tensor:
        """The residual's rows (B, S / m, d) -> the whole sequence."""
        if not self.seq_split:
            return x
        return _Gather.apply(x, 1, self.model)

    def scatter_seq(self, y: torch.Tensor) -> torch.Tensor:
        """A row-parallel layer's partial sums (B, S, d) -> the sum, in
        the residual's layout."""
        if self.model is None:
            return y
        if self.seq_split:
            return _Scatter.apply(y, 1, self.model)
        return copy_to_model(reduce_from_model(y, self.model), self.model)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return reduce_from_model(x, self.model)

    @torch.no_grad()
    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max over "model" (no gradient)."""
        out = x.detach().clone()
        if self.model is not None:
            dist.all_reduce(out, op=dist.ReduceOp.MAX,
                            group=self.model.group)
        return out

    # -- parameters ---------------------------------------------------------
    def gather(self, leaf: torch.Tensor, spec: PartitionSpec
               ) -> torch.Tensor:
        """FSDP: the leaf with its "data" blocks gathered (a no-op where no
        such axis splits it)."""
        return fsdp_gather(leaf, spec, self.mesh)

    def block(self, p: dict, key: str) -> dict:
        """Layer group ``p`` (views of the stacked leaves of block
        ``key``) with each leaf's FSDP blocks gathered."""
        specs = self.specs["blocks"][key]
        return {k: self.gather(v, specs[k][1:]) for k, v in p.items()}

    def vocab(self, cfg) -> tuple[int, int]:
        """(first global vocab row of this rank's shard, rows a rank)."""
        n = cfg.padded_vocab // self.m
        return self.r * n, n

    def heads(self, cfg, p: dict, prefix: str = ""):
        """(wq, wk, wv, local q heads, local kv heads) of this rank: the
        column blocks of the q / k / v projections, this rank's q heads.

        Where the kv heads split whole over "model", wk and wv are this
        rank's kv heads.  Otherwise the rank takes the kv heads its q heads
        read: from the whole wk and wv where "model" does not split them
        (``dropped``; their gradient is then a part, summed by the step),
        or, where it splits their columns mid-head, from wk and wv gathered
        over "model" (backward: each rank's block of the summed gradient)."""
        m, hl = self.m, cfg.n_heads // self.m
        wq, wk, wv = (p[f"{prefix}{w}"] for w in ("wq", "wk", "wv"))
        if m == 1 or (wk.shape[-1] != cfg.kv_dim and cfg.n_kv_heads % m == 0):
            return wq, wk, wv, hl, cfg.n_kv_heads // m
        if wk.shape[-1] != cfg.kv_dim:
            wk, wv = (_Gather.apply(w, w.ndim - 1, self.model)
                      for w in (wk, wv))
        group = cfg.n_heads // cfg.n_kv_heads
        lo = self.r * hl // group
        hi = ((self.r + 1) * hl - 1) // group + 1
        dh = cfg.head_dim
        return (wq, wk[..., lo * dh:hi * dh], wv[..., lo * dh:hi * dh], hl,
                hi - lo)


def same_on_replicas(tree, shardings) -> bool | list:
    """Whether every leaf of ``tree`` (this rank's blocks under
    ``shardings``) is bit-equal on the ranks that replicate it: for each
    mesh axis of size > 1 that does not split the leaf, the exact sum of
    its elements' bit patterns is gathered over that axis and compared.
    True, or the paths and axes that differ (the same on every rank)."""
    bad = []
    for (path, t), (_, sh) in zip(tree_paths(tree), tree_paths(shardings),
                                  strict=True):
        bits = t.detach().contiguous().view(
            torch.int16 if t.element_size() == 2 else torch.int32
        ).long().sum().reshape(1)
        split = {a for assign in sh.spec for a in _names(assign)}
        for name in sh.mesh.mesh_dim_names:
            ax = mesh_axis(sh.mesh, name)
            if name in split or ax.size == 1:
                continue
            every = _all_gather(bits, 0, ax)
            if not bool((every == bits).all()):
                bad.append((path, name))
    return True if not bad else bad


def local_tree(tree, shardings):
    """This rank's block of each leaf of a whole tree (contiguous copies:
    the whole leaves can be freed)."""
    return tree_map(lambda t, sh: sh.local(t).clone(
        memory_format=torch.contiguous_format), tree, shardings)
