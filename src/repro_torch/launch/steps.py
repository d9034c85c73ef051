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

With a ``Sharder`` over a mesh (``build_sharder``), the train step is data
parallel: each rank holds its rows of the global batch, and the gradient
tree is averaged over the batch axes (``hierarchical_pmean``, over
``torch.distributed``) before AdamW, so clipping and the update see the
global gradient.  The port runs only meshes whose parameters are all
replicated (``Sharder.check_runnable``), and no MoE model on more than one
batch shard (see ``make_train_step``).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..configs.base import ShapePreset
from ..distributed.collectives import hierarchical_pmean
from ..distributed.sharding import (Sharder, decode_rules, mesh_shape,
                                     train_rules)
from ..models import transformer as T
from ..models.api import Model
from ..models.config import ModelConfig
from ..models.layers import AttnOp, GmmOp, SsdOp
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
                   weight: torch.Tensor | None = None) -> tuple[dict, dict]:
    """(metrics of ``model.train_loss``, the gradient of its loss as a tree
    like ``params``).  A leaf the loss does not reach gets a zero
    gradient, as under ``jax.grad``.  ``attn_op``, ``ssd_op`` and
    ``gmm_op`` replace ``ops.flash_attention``, ``ops.ssd_scan`` and
    ``ops.moe_gmm`` (a check's autograd through their plain versions).
    ``weight`` (a 0-d tensor) multiplies the loss the gradient is taken
    of, not the metrics."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = model.train_loss(tree_unflatten(params, leaves),
                                         batch, attn_op=attn_op,
                                         ssd_op=ssd_op, gmm_op=gmm_op)
        if weight is not None:
            loss = loss * weight
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return ({k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, grads))


def _data_parallel(model: Model, sharder: Sharder) -> Callable:
    """``loss_and_grads`` over the batch axes of ``sharder``'s mesh: the
    mean over the global batch's tokens.

    The loss is a mean over a rank's tokens, so each rank's loss is
    weighted by its share of the global token count (n_rank * dp / N,
    exactly 1 when the ranks hold as many rows) before the gradients and
    the metrics are averaged over the ranks (``hierarchical_pmean``)."""
    mesh = sharder.mesh

    def step(params: dict, batch: dict) -> tuple[dict, dict]:
        tokens = batch["tokens"]
        n = torch.tensor(float(tokens.shape[0] * (tokens.shape[1] - 1)),
                         dtype=torch.float32, device=model.device)
        weight = n / hierarchical_pmean(mesh, {"n": n.clone()})["n"]
        metrics, grads = loss_and_grads(model, params, batch, weight=weight)
        hierarchical_pmean(mesh, grads)
        keys = sorted(metrics)
        mean = hierarchical_pmean(mesh, {"m": torch.stack(
            [metrics[k] for k in keys]) * weight})["m"]
        return dict(zip(keys, mean.unbind())), grads

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
    batch (``_data_parallel``).  It raises ``NotImplementedError`` on a mesh
    the port cannot run (``Sharder.check_runnable``) and for a MoE model on
    more than one batch shard: the router's aux loss and the capacity of
    the reference's step are taken over the global batch's tokens, which
    no rank holds (ROADMAP Queue A item 6.4)."""
    def grads_of(params: dict, batch: dict) -> tuple[dict, dict]:
        return loss_and_grads(model, params, batch)

    if sharder is not None and sharder.mesh is not None:
        sharder.check_runnable(model.specs(), "a train step")
        if sharder.dp_size() > 1 and any(
                d.moe for d in model.cfg.block_pattern):
            raise NotImplementedError(
                f"{model.cfg.name} is a MoE model: its aux loss and expert "
                f"capacity are over the global batch, which a data-parallel "
                f"step over {sharder.dp_size()} shards does not hold "
                f"(ROADMAP Queue A item 6.4)")
        grads_of = _data_parallel(model, sharder)

    def train_step(params: dict, opt_state: dict, batch: dict):
        metrics, grads = grads_of(params, batch)
        with torch.profiler.record_function("adamw_update"):
            _, _, om = adamw_update_(opt_cfg, grads, opt_state, params)
        return params, opt_state, {**metrics, **om}

    return train_step
