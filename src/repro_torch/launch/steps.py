"""The prefill step: tokens -> logits of the last position.

The JAX package builds it as the closure ``prefill_step`` in its
``launch/steps.py`` (embed, the block stack, unembed of the last position),
traced and sharded over a mesh.  The port's step runs eagerly on the model's
one device; it takes the prompt tokens themselves, where the JAX step drops
the last column of a (B, S + 1) training batch.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models import transformer as T
from ..models.api import Model
from ..models.layers import AttnOp

__all__ = ["make_prefill_step"]


def make_prefill_step(model: Model, attn_op: AttnOp | None = None
                      ) -> Callable[[dict, torch.Tensor], torch.Tensor]:
    """``step(params, tokens (B, S)) -> logits (B, V)`` of the last position.

    Every attention layer calls ``ops.flash_attention`` (the tuned kernel on
    the card) unless ``attn_op`` names another function of its signature.
    """
    cfg = model.cfg

    def prefill_step(params: dict, tokens: torch.Tensor) -> torch.Tensor:
        x = T.embed_tokens(cfg, params, tokens)
        hidden, _ = T.forward(cfg, params, x, attn_op=attn_op)
        return T.unembed(cfg, params, hidden[:, -1])

    return prefill_step
