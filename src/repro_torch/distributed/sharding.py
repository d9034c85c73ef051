"""Logical-axis sharding rules: DP / FSDP / TP / EP / SP on named meshes.

The JAX package's ``distributed/sharding.py``.  Parameters and activations
carry *logical* axis names ("embed", "heads", "vocab", "batch", ...).  A
``Sharder`` maps those names onto mesh axes through a rules table, checking
divisibility: a dimension that does not divide by its mesh axes is
replicated instead (recorded in ``dropped``), and no mesh axis shards two
dims of one tensor.  The rule tables are the reference's.

A partition spec is a tuple with one entry per tensor dim: None, a mesh
axis name, or a tuple of names (the jax ``PartitionSpec``'s entries).
``named`` / ``param_sharding`` return a ``TensorSharding``: the mesh, the
spec and the ``torch.distributed.tensor`` placements, one per mesh dim.  A
dim sharded over ("pod", "data") is ``Shard(d)`` on both mesh dims,
pod-major, as in JAX.

The port *computes* shardings on any mesh (a ``DeviceMesh`` or an
``AbstractMesh``).  It *runs* data parallelism over the batch axes and, in
the train step of the dense attention decoders, tensor and sequence
parallelism over "model" and FSDP over "data" (``distributed.
tensor_parallel``).  ``check_runnable`` raises ``NotImplementedError`` for
the rest, each refusal naming the ROADMAP item that ports it (``LEFT``).
``act`` checks that a rank's local tensor is the block that the spec's split
of the global shape gives.

One divergence: ``dp_size`` counts a batch axis the mesh lacks as size 1
(the reference's ``_axes_size`` raises ``KeyError`` there, while its own
``_assign`` skips such axes).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Sequence

import torch

from ..models.module import ParamSpec, spec_leaves

__all__ = ["LEFT", "Sharder", "TensorSharding", "train_rules",
           "decode_rules", "mesh_shape", "tp_refusal"]

AxisAssign = str | tuple[str, ...] | None
PartitionSpec = tuple[AxisAssign, ...]

# what is left of ROADMAP Queue A item 6.4, in the order it is to be ported
LEFT = {
    "moe": "ROADMAP Queue A item 6.4.1 (experts over 'model', and MoE "
           "under data parallelism) is not ported",
    "mamba": "ROADMAP Queue A item 6.4.2 (mamba_inner / mamba_bh over "
             "'model') is not ported",
    "prefix": "ROADMAP Queue A item 6.4.3 (whisper's and internvl2's paths "
              "over 'model' and FSDP) is not ported",
    "serving": "ROADMAP Queue A item 6.4.4 (serving on a 'model' mesh with "
               "decode_rules) is not ported",
    "pipe": "ROADMAP Queue A item 6.4.6 (GPipe inside a train step) is not "
            "ported",
    "layout": "the port holds activations in the Sharder's layout only "
              "(ROADMAP Queue A item 6.4)",
}
# logical axes whose split over "model" the train step's layers take: a
# leaf where one of them is dropped would have to run replicated
_TP_AXES = ("heads", "mlp", "vocab")


def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a ``launch.mesh.
    AbstractMesh`` (the jax mesh's ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _names(assign: AxisAssign) -> tuple[str, ...]:
    if assign is None:
        return ()
    return (assign,) if isinstance(assign, str) else tuple(assign)


def _axes_size(mesh, assign: AxisAssign) -> int:
    """The product of the sizes of ``assign``'s axes; an axis the mesh
    lacks counts 1 (the divergence named in the module docstring)."""
    sizes = mesh_shape(mesh)
    return math.prod(sizes.get(a, 1) for a in _names(assign))


@dataclass(frozen=True)
class TensorSharding:
    """One tensor's layout on a mesh: the partition spec and, per mesh dim,
    its ``Shard(d)`` / ``Replicate()`` placement (the jax
    ``NamedSharding``)."""

    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard

        names = list(self.mesh.mesh_dim_names)
        out = [Replicate()] * len(names)
        for d, assign in enumerate(self.spec):
            axes = _names(assign)
            # DTensor splits a dim over its mesh dims in mesh order, JAX
            # in the spec's order: the rules list them in mesh order
            if [names.index(a) for a in axes] != \
                    sorted(names.index(a) for a in axes):
                raise ValueError(f"{assign} is not in the mesh's axis order "
                                 f"{tuple(names)}")
            for a in axes:
                out[names.index(a)] = Shard(d)
        return tuple(out)

    def sharded_over(self) -> tuple[str, ...]:
        """The mesh axes of size > 1 that split this tensor."""
        sizes = mesh_shape(self.mesh)
        return tuple(a for assign in self.spec for a in _names(assign)
                     if sizes[a] > 1)

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full`` (a ``DeviceMesh`` only)."""
        coord = dict(zip(self.mesh.mesh_dim_names,
                         self.mesh.get_coordinate()))
        sizes = mesh_shape(self.mesh)
        out = full
        for d, assign in enumerate(self.spec):
            axes = _names(assign)
            n = math.prod(sizes[a] for a in axes)
            if n == 1:
                continue
            index = 0
            for a in axes:                    # the first axis is major
                index = index * sizes[a] + coord[a]
            block = full.shape[d] // n
            out = out.narrow(d, index * block, block)
        return out

    def distribute(self, full: torch.Tensor):
        """``full`` (the same on every rank) as a ``DTensor`` on the mesh's
        device, each rank holding its own block: no collective runs."""
        from torch.distributed.tensor import DTensor

        local = self.local(full).to(self.mesh.device_type).contiguous()
        return DTensor.from_local(local, self.mesh, self.placements,
                                  run_check=False, shape=full.shape,
                                  stride=torch.empty(full.shape,
                                                     device="meta").stride())


@dataclass
class Sharder:
    """Maps logical axis names to mesh axes; None mesh = single-device noop."""

    mesh: object | None
    rules: dict[str, AxisAssign] = field(default_factory=dict)
    dropped: list[tuple[str, str, int]] = field(default_factory=list)

    def _assign(self, dim: int, name: str | None, taken: set[str],
                record: bool = True) -> AxisAssign:
        if name is None or self.mesh is None:
            return None
        assign = self.rules.get(name)
        if assign is None:
            return None
        sizes = mesh_shape(self.mesh)
        axes = tuple(a for a in _names(assign)
                     if a in sizes and a not in taken)
        if not axes:
            return None
        size = math.prod(sizes[a] for a in axes)
        if dim % size != 0:
            if record:
                self.dropped.append((name, "x".join(axes), dim))
            return None
        return axes if len(axes) > 1 else axes[0]

    def pspec(self, shape: Sequence[int], axes: Sequence[str | None],
              record: bool = True) -> PartitionSpec:
        """``record=False`` leaves ``dropped`` (the reference's record of
        its calls) as it is: the port's own layout checks ask too."""
        taken: set[str] = set()
        parts: list[AxisAssign] = []
        for dim, name in zip(shape, axes):
            a = self._assign(dim, name, taken, record)
            taken.update(_names(a))
            parts.append(a)
        return tuple(parts)

    def named(self, shape: Sequence[int],
              axes: Sequence[str | None]) -> TensorSharding | None:
        if self.mesh is None:
            return None
        return TensorSharding(self.mesh, self.pspec(shape, axes))

    def param_sharding(self, spec: ParamSpec) -> TensorSharding | None:
        axes = spec.axes if spec.axes else tuple(None for _ in spec.shape)
        return self.named(spec.shape, axes)

    def act(self, x: torch.Tensor, axes: Sequence[str | None],
            shape: Sequence[int] | None = None) -> torch.Tensor:
        """The reference's sharding constraint on an activation, as a
        layout check: ``x`` is this rank's block of a tensor of global
        ``shape`` (default ``x.shape``, a tensor held whole), and must have
        the shape that the spec of ``axes`` splits ``shape`` into.  Returns
        ``x``; raises ``ValueError`` on another shape (the port moves no
        data here: its collectives sit where the layers call them)."""
        if self.mesh is None:
            return x
        shape = tuple(x.shape) if shape is None else tuple(shape)
        spec = self.pspec(shape, axes, record=False)
        want = _local_shape(self.mesh, shape, spec)
        if tuple(x.shape) != want:
            raise ValueError(f"a local {tuple(x.shape)} is not the block "
                             f"{want} of {shape} under {spec} on "
                             f"{mesh_shape(self.mesh)}: {LEFT['layout']}")
        return x

    def dp_size(self) -> int:
        if self.mesh is None:
            return 1
        return _axes_size(self.mesh, self.rules.get("batch"))

    def dp_rank(self) -> int:
        """This rank's index among the batch shards (pod-major)."""
        if self.mesh is None:
            return 0
        coord = dict(zip(self.mesh.mesh_dim_names,
                         self.mesh.get_coordinate()))
        sizes = mesh_shape(self.mesh)
        index = 0
        for a in self.batch_axes():
            index = index * sizes[a] + coord[a]
        return index

    def batch_axes(self) -> tuple[str, ...]:
        """The batch rule's axes that the mesh has, in the rule's order."""
        if self.mesh is None:
            return ()
        sizes = mesh_shape(self.mesh)
        return tuple(a for a in _names(self.rules.get("batch"))
                     if a in sizes)

    def check_runnable(self, specs, what: str, cfg=None) -> None:
        """Raise ``NotImplementedError`` unless the port can run ``what``
        on the mesh.

        Without ``cfg`` (serving), every axis but the batch axes must have
        size 1 and no leaf of ``specs`` (a ParamSpec tree) may be sharded
        over an axis of size > 1.  With ``cfg`` (a train step's model
        config), "model" may be larger than 1 and leaves may be sharded
        over it and over "data" (FSDP), for a decoder of dense attention
        blocks (``tp_refusal``) whose heads, MLP and vocab split over
        "model" (kv heads may be dropped: each rank then takes the kv
        heads its q heads read, as where "model" splits their columns
        mid-head)."""
        if self.mesh is None:
            return
        sizes = mesh_shape(self.mesh)
        batch = self.batch_axes()
        if cfg is None:
            big = {a: n for a, n in sizes.items() if n > 1 and a not in batch}
            if big:
                raise NotImplementedError(f"{what} on a mesh with {big}: "
                                          f"{LEFT['serving']}")
            for path, spec in spec_leaves(specs):
                over = self.param_sharding(spec).sharded_over()
                if over:
                    raise NotImplementedError(
                        f"{what}: parameter {path} {spec.shape} would be "
                        f"sharded over {over}: {LEFT['serving']}")
            return
        big = {a: n for a, n in sizes.items()
               if n > 1 and a not in batch + ("model",)}
        if big:
            raise NotImplementedError(
                f"{what} on a mesh with {big}: the step splits over the "
                f"batch axes and 'model' only; {LEFT['pipe']}")
        leaves = spec_leaves(specs)
        if sizes.get("model", 1) == 1 and not any(
                self.param_sharding(s).sharded_over() for _, s in leaves):
            return                  # data parallel, every leaf replicated
        reason = tp_refusal(cfg)
        if reason is not None:
            raise NotImplementedError(
                f"{what} of {cfg.name} ({cfg.arch_kind}) over "
                f"{mesh_shape(self.mesh)} with its parameters sharded: "
                f"{reason}")
        m = sizes.get("model", 1)
        for path, spec in leaves:
            if not spec.axes:
                continue
            got = self.pspec(spec.shape, spec.axes, record=False)
            for dim, name, a in zip(spec.shape, spec.axes, got):
                if name in _TP_AXES and self.rules.get(name) == "model" \
                        and m > 1 and a != "model":
                    raise NotImplementedError(
                        f"{what}: {path}'s {name} ({dim}) does not split "
                        f"over 'model' ({m}), so its layer would run "
                        f"replicated: {LEFT['layout']}")
        H, KV = cfg.n_heads, cfg.n_kv_heads
        hl, group = H // m, H // KV
        if H % m:
            raise NotImplementedError(
                f"{what}: {H} q heads do not split whole over 'model' "
                f"({m}): {LEFT['layout']}")
        if KV % m and hl % group and group % hl:
            raise NotImplementedError(
                f"{what}: {H} q heads over {m} ranks ({hl} each) do not map "
                f"onto whole kv heads (GQA {group}): {LEFT['layout']}")


def tp_refusal(cfg) -> str | None:
    """Why the train step's tensor-parallel layers cannot run ``cfg``
    (the ``LEFT`` item that ports it), or None for a decoder of dense
    attention blocks: "lm", no MoE, no Mamba-2, no cross-attention."""
    if any(d.moe for d in cfg.block_pattern):
        return LEFT["moe"]
    if {d.kind for d in cfg.block_pattern} != {"attn"}:
        return LEFT["mamba"]
    if cfg.arch_kind != "lm" or any(d.cross_attn for d in cfg.block_pattern):
        return LEFT["prefix"]
    return None


def _local_shape(mesh, shape: Sequence[int], spec: PartitionSpec
                ) -> tuple[int, ...]:
    """The shape of one rank's block of a ``shape`` tensor under
    ``spec``."""
    sizes = mesh_shape(mesh)
    return tuple(n // math.prod(sizes[a] for a in _names(assign))
                 for n, assign in zip(shape, spec))


def train_rules(fsdp: bool = True) -> dict[str, AxisAssign]:
    """DP + TP (+ optional FSDP over the data axis for params)."""
    return {
        # activations
        "batch": ("pod", "data"),
        # Sequence parallelism: the residual stream is seq-sharded over the
        # model axis at layer-group boundaries.
        "act_seq": "model",
        "act_embed": None,
        "act_heads": "model",
        "act_mlp": "model",
        "act_vocab": "model",
        "moe_groups": ("pod", "data"),
        # token-side dispatch tensors (G, g*k, d): the d column dim shards
        # over "model"
        "moe_token_d": "model",
        # parameters
        "embed": "data" if fsdp else None,     # FSDP shard dim
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "experts": "model",
        "vocab": "model",
        "mamba_inner": "model",
        "ssm_state": None,
        "conv_k": None,
        "layers": None,
        # the SSD's flattened (B*Hm) dim over every mesh axis
        "mamba_bh": ("pod", "data", "model"),
    }


def decode_rules(cache_seq_mode: str = "heads") -> dict[str, AxisAssign]:
    """Serving: DP over request batch, TP over model.

    ``cache_seq_mode`` selects what the "model" axis shards in the KV cache:
      * "heads": kv heads over model (best when kv_heads % model == 0),
      * "seq":   cache sequence over model (archs with few kv heads),
      * "long":  batch=1 long-context: cache sequence over (data, model),
                 batch axes released.
    """
    rules = train_rules(fsdp=False)
    rules.update({
        "cache_batch": ("pod", "data"),
        "cache_seq": None,
        "cache_heads": "model",
        "mamba_heads": "model",
    })
    if cache_seq_mode == "seq":
        rules["cache_seq"] = "model"
        rules["cache_heads"] = None
    elif cache_seq_mode == "long":
        rules["cache_seq"] = ("data", "model")
        rules["cache_heads"] = None
        rules["batch"] = None
        rules["cache_batch"] = None
    return rules
