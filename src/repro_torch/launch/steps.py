"""The prefill step: tokens (and a vlm's patches or an encdec's frames) ->
logits of the last position.

The JAX package builds it as the closure ``prefill_step`` in its
``launch/steps.py``: embed the tokens; for a vlm prepend the patch
embeddings; for an encdec run the encoder stack, non-causal, over the frame
embeddings (the closure adds no positional encoding to them) and give its
output to the decoder's cross-attention; then the block stack and the
unembedding of the last position.  The JAX step is traced and sharded over
a mesh; the port's runs eagerly on the model's one device, and it takes the
prompt tokens themselves, where the JAX step drops the last column of a
(B, S + 1) training batch.

The train step (``make_train_step``) is the JAX package's: the model's
training loss, its gradient over every parameter leaf, then AdamW.  The JAX
step is ``jax.value_and_grad`` under ``jit``; the port's runs eagerly, its
gradient from ``torch.autograd.grad`` -- on the card through the
hand-written backward kernels (``ops.flash_attention``, ``ops.ssd_scan``,
``ops.moe_gmm``).  As the JAX step is lowered with its parameters and
optimizer state donated, the port's writes the update into them.

With a ``Sharder`` over a mesh (``build_sharder``), each rank holds its
rows of the global batch, and each gradient leaf is reduced over the mesh
by its partition spec before AdamW (``_over_mesh``), so clipping and the
update see the global gradient.  Where every parameter is replicated and
the layers are the one-process ones, that is the data-parallel mean over
the batch axes.  For a dense attention decoder on a mesh with a "model"
axis, or where FSDP shards parameters over "data", each rank holds its
blocks of the parameters and the moments, the loss runs tensor and
sequence parallel (``distributed.tensor_parallel``), and the clip's global
norm is taken over the blocks (``adamw_update_(shardings=)``).  The port
refuses the meshes and models it cannot run (``Sharder.check_runnable``),
and MoE models on more than one batch shard (see ``make_train_step``).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..configs.base import ShapePreset
from ..distributed.collectives import hierarchical_pmean
from ..distributed.sharding import (LEFT, Sharder, _names, decode_rules,
                                     mesh_shape, train_rules)
from ..distributed.tensor_parallel import (TensorParallel, mesh_axis,
                                           sharded_step)
from ..models import transformer as T
from ..models.api import Model
from ..models.config import ModelConfig
from ..models.layers import AttnOp, GmmOp, SsdOp
from ..models.module import spec_tree_map
from ..optim import AdamWConfig, adamw_update_
from ..tree import tree_leaves, tree_unflatten

__all__ = ["build_sharder", "make_prefill_step", "make_train_step"]


def build_sharder(cfg: ModelConfig, preset: ShapePreset, mesh) -> Sharder:
    """The reference's rules for a cell: decode rules (the cache's sequence
    or heads over "model", by the kv heads; "long" at batch 1) for a decode
    preset, train rules otherwise; FSDP over "data" for d_model >= 4096."""
    if preset.kind == "decode":
        model_size = mesh_shape(mesh).get("model", 1) \
            if mesh is not None else 1
        if preset.global_batch == 1:
            mode = "long"
        elif cfg.n_kv_heads % max(model_size, 1) == 0:
            mode = "heads"
        else:
            # few kv heads on a wide model axis: shard the cache's sequence
            # axis instead of replicating the cache across the model axis
            mode = "seq"
        rules = decode_rules(cache_seq_mode=mode)
        if cfg.d_model >= 4096:
            # big archs: parameters FSDP-shard over "data" in serving too
            rules["embed"] = "data"
    else:
        rules = train_rules(fsdp=cfg.d_model >= 4096)
    return Sharder(mesh=mesh, rules=rules)


def make_prefill_step(model: Model, attn_op: AttnOp | None = None,
                      ssd_op: SsdOp | None = None,
                      gmm_op: GmmOp | None = None
                      ) -> Callable[..., torch.Tensor]:
    """``step(params, tokens (B, S), patches=None, frames=None) -> logits
    (B, V)`` of the last position.

    A vlm takes ``patches`` (B, P, d_model), an encdec ``frames`` (B,
    encoder_seq, d_model); both are cast to the activations' dtype, and a
    model of another kind refuses them.  Every attention layer (the
    encoder's and the cross-attention included) calls
    ``ops.flash_attention``, every Mamba-2 layer ``ops.ssd_scan`` and every
    MoE layer ``ops.moe_gmm`` (the tuned kernels on the card) unless
    ``attn_op`` / ``ssd_op`` / ``gmm_op`` names another function of its
    signature.
    """
    cfg = model.cfg
    kind = cfg.arch_kind

    def prefill_step(params: dict, tokens: torch.Tensor,
                     patches: torch.Tensor | None = None,
                     frames: torch.Tensor | None = None) -> torch.Tensor:
        if (patches is not None) != (kind == "vlm") \
                or (frames is not None) != (kind == "encdec"):
            raise ValueError(f"a vlm prefill takes patches and an encdec "
                             f"prefill frames; this {kind} prefill got "
                             f"patches={patches is not None}, "
                             f"frames={frames is not None}")
        x = T.embed_tokens(cfg, params, tokens)
        if patches is not None:
            x = torch.cat([patches.to(x.dtype), x], dim=1)
        enc_out = None
        if frames is not None:
            enc_out, _ = T.forward(model.encoder_cfg(), params["encoder"],
                                   frames.to(x.dtype), causal=False,
                                   attn_op=attn_op)
        hidden, _ = T.forward(cfg, params, x, enc_out=enc_out,
                              attn_op=attn_op, ssd_op=ssd_op, gmm_op=gmm_op)
        return T.unembed(cfg, params, hidden[:, -1])

    return prefill_step


def loss_and_grads(model: Model, params: dict, batch: dict,
                   attn_op: AttnOp | None = None,
                   ssd_op: SsdOp | None = None,
                   gmm_op: GmmOp | None = None,
                   weight: torch.Tensor | None = None,
                   tp: TensorParallel | None = None) -> tuple[dict, dict]:
    """(metrics of ``model.train_loss``, the gradient of its loss as a tree
    like ``params``).  A leaf the loss does not reach gets a zero
    gradient, as under ``jax.grad``.  ``attn_op``, ``ssd_op`` and
    ``gmm_op`` replace ``ops.flash_attention``, ``ops.ssd_scan`` and
    ``ops.moe_gmm`` (a check's autograd through their plain versions).
    ``weight`` (a 0-d tensor) multiplies the loss the gradient is taken
    of, not the metrics.  ``tp`` goes to ``model.train_loss``."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = model.train_loss(tree_unflatten(params, leaves),
                                         batch, attn_op=attn_op,
                                         ssd_op=ssd_op, gmm_op=gmm_op,
                                         tp=tp)
        if weight is not None:
            loss = loss * weight
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return ({k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, grads))


def _token_weight(model: Model, sharder: Sharder, batch: dict
                  ) -> torch.Tensor:
    """This rank's share of the global batch's tokens times the number of
    batch shards (n_rank * dp / N; exactly 1 when the ranks hold as many
    rows): the weight of its mean loss in the data-parallel mean."""
    tokens = batch["tokens"]
    n = torch.tensor(float(tokens.shape[0] * (tokens.shape[1] - 1)),
                     dtype=torch.float32, device=model.device)
    return n / hierarchical_pmean(sharder.mesh, {"n": n.clone()})["n"]


def _mean_metrics(sharder: Sharder, metrics: dict, weight: torch.Tensor
                  ) -> dict:
    keys = sorted(metrics)
    mean = hierarchical_pmean(sharder.mesh, {"m": torch.stack(
        [metrics[k] for k in keys]) * weight})["m"]
    return dict(zip(keys, mean.unbind()))


def _over_mesh(model: Model, sharder: Sharder, shardings, layers: bool
               ) -> Callable:
    """``loss_and_grads`` over ``sharder``'s mesh: the mean over the global
    batch's tokens.  ``shardings`` is the parameters' tree of
    ``TensorSharding``; ``layers``: the loss runs tensor parallel on this
    rank's blocks (``TensorParallel``, one a batch shape), else the
    one-process layers on whole leaves.

    The loss is a mean over a rank's tokens, so each rank's loss is
    weighted by its share of the global token count (``_token_weight``).
    Each gradient leaf is then reduced by its partition spec, skipping the
    axes of size 1:

    * a leaf that "model" does not split is summed over "model": every
      rank's gradient of it is a part (``distributed.tensor_parallel``);
    * over "data", then "pod" (the stages of ``hierarchical_pmean``), a
      leaf that the axis splits arrives summed (FSDP: the backward of its
      gather reduce-scatters) and is divided by the axis's size; any other
      leaf is all-reduced and divided, the data-parallel mean."""
    mesh = sharder.mesh
    over = [{a for assign in sh.spec for a in _names(assign)}
            for sh in tree_leaves(shardings)]
    layouts: dict[tuple[int, int], TensorParallel] = {}

    def step(params: dict, batch: dict) -> tuple[dict, dict]:
        # the axes of size > 1: "model", then the stages of
        # ``hierarchical_pmean``, "data" first
        model_ax, *stages = (
            ax if ax is not None and ax.size > 1 else None
            for ax in (mesh_axis(mesh, a) for a in ("model", "data", "pod")))
        stages = [ax for ax in stages if ax is not None]
        tp = None
        if layers:
            rows, cols = batch["tokens"].shape
            tp = layouts.get((rows, cols))
            if tp is None:
                tp = layouts[rows, cols] = TensorParallel(
                    sharder, shardings, rows * sharder.dp_size(), cols - 1,
                    model.cfg.d_model)
        weight = _token_weight(model, sharder, batch)
        metrics, grads = loss_and_grads(model, params, batch, weight=weight,
                                        tp=tp)
        for g, axes in zip(tree_leaves(grads), over):
            if model_ax is not None and "model" not in axes:
                dist.all_reduce(g, group=model_ax.group)
            for ax in stages:
                if ax.name not in axes:
                    dist.all_reduce(g, group=ax.group)
                g.div_(ax.size)
        return _mean_metrics(sharder, metrics, weight), grads

    return step


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    sharder: Sharder | None = None) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    metrics are ``loss``, ``ce`` and ``router_aux`` from the loss and
    ``grad_norm`` (with clipping) and ``lr`` from AdamW, 0-d tensors.

    The step updates ``params`` and ``opt_state`` in place
    (``adamw_update_``, bit-equal to the functional ``adamw_update``) and
    returns those same trees: the JAX package lowers its train step with
    both donated (``src/repro/launch/steps.py:42-50``, ``StepBundle.lower``:
    "train steps update (params, opt_state) in place"), so no step holds an
    old and a new copy of them.  A caller that needs the trees from before
    a step clones them first.  The gradients are freed when the step
    returns.  The update runs inside a profiler range named
    ``adamw_update``, so a ``torch.profiler`` trace of a step tells the
    optimizer's kernels from the rest.

    With ``sharder`` over a mesh, ``batch`` holds this rank's rows of the
    global batch, and the step equals the one-process step on the global
    batch (``_over_mesh``).  Where ``distributed.tensor_parallel.
    sharded_step`` holds, ``params`` and ``opt_state`` are this rank's
    blocks (``TensorSharding.local``) and the loss runs tensor parallel;
    elsewhere they are whole and the step is data parallel.  It raises
    ``NotImplementedError`` on a mesh or model the port cannot run
    (``Sharder.check_runnable``) and for a MoE model on more than one
    batch shard: the router's aux loss and the capacity of the reference's
    step are taken over the global batch's tokens, which no rank holds
    (ROADMAP Queue A item 6.4.1)."""
    def grads_of(params: dict, batch: dict) -> tuple[dict, dict]:
        return loss_and_grads(model, params, batch)

    shardings = None
    if sharder is not None and sharder.mesh is not None:
        specs = model.specs()
        sharder.check_runnable(specs, "a train step", model.cfg)
        if sharder.dp_size() > 1 and any(
                d.moe for d in model.cfg.block_pattern):
            raise NotImplementedError(
                f"{model.cfg.name} is a MoE model: its aux loss and expert "
                f"capacity are over the global batch, which a data-parallel "
                f"step over {sharder.dp_size()} shards does not hold: "
                f"{LEFT['moe']}")
        shardings = spec_tree_map(sharder.param_sharding, specs)
        grads_of = _over_mesh(model, sharder, shardings,
                              sharded_step(sharder, specs, model.cfg))

    def train_step(params: dict, opt_state: dict, batch: dict):
        metrics, grads = grads_of(params, batch)
        with torch.profiler.record_function("adamw_update"):
            _, _, om = adamw_update_(opt_cfg, grads, opt_state, params,
                                     shardings=shardings)
        return params, opt_state, {**metrics, **om}

    return train_step
