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
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models import transformer as T
from ..models.api import Model
from ..models.layers import AttnOp, GmmOp, SsdOp
from ..optim import AdamWConfig, adamw_update_
from ..tree import tree_leaves, tree_unflatten

__all__ = ["make_prefill_step", "make_train_step"]


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
                   gmm_op: GmmOp | None = None) -> tuple[dict, dict]:
    """(metrics of ``model.train_loss``, the gradient of its loss as a tree
    like ``params``).  A leaf the loss does not reach gets a zero
    gradient, as under ``jax.grad``.  ``attn_op``, ``ssd_op`` and
    ``gmm_op`` replace ``ops.flash_attention``, ``ops.ssd_scan`` and
    ``ops.moe_gmm`` (a check's autograd through their plain versions)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = model.train_loss(tree_unflatten(params, leaves),
                                         batch, attn_op=attn_op,
                                         ssd_op=ssd_op, gmm_op=gmm_op)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return ({k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, grads))


def make_train_step(model: Model, opt_cfg: AdamWConfig) -> Callable:
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
    optimizer's kernels from the rest."""

    def train_step(params: dict, opt_state: dict, batch: dict):
        metrics, grads = loss_and_grads(model, params, batch)
        with torch.profiler.record_function("adamw_update"):
            _, _, om = adamw_update_(opt_cfg, grads, opt_state, params)
        return params, opt_state, {**metrics, **om}

    return train_step
