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
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models import transformer as T
from ..models.api import Model
from ..models.layers import AttnOp, GmmOp, SsdOp

__all__ = ["make_prefill_step"]


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
