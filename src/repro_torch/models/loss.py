"""Losses: cross-entropy over large vocabularies in sequence chunks.

The JAX package's ``models/loss.py``.  The logits of a 128k-256k vocab at
training batch sizes are gigabytes, so the head product and the softmax run
in chunks of ``min(cfg.logits_chunk, S)`` positions (the last may be
short), and each chunk is recomputed in the backward
(``torch.utils.checkpoint``, as ``jax.checkpoint`` there): live memory is
one chunk's logits.  The JAX function's ``sharder`` is dropped: the port
runs on one device.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .config import ModelConfig

__all__ = ["chunked_cross_entropy", "lm_loss"]

f32 = torch.float32


def _chunk_ce(cfg: ModelConfig, head: torch.Tensor, x: torch.Tensor,
              labels: torch.Tensor, mask: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """CE over one chunk.  x (B, C, d), labels (B, C) -> (sum of the masked
    NLL, sum of the mask)."""
    z = x.to(f32) @ head.to(f32)
    if cfg.final_softcap is not None:
        z = cfg.final_softcap * torch.tanh(z / cfg.final_softcap)
    if cfg.padded_vocab != cfg.vocab_size:
        col = torch.arange(cfg.padded_vocab, device=z.device)
        z = z.masked_fill(col >= cfg.vocab_size, -1e30)
    lse = torch.logsumexp(z, dim=-1)                               # (B, C)
    gold = torch.gather(z, -1, labels[..., None].long())[..., 0]
    nll = (lse - gold) * mask
    return torch.sum(nll), torch.sum(mask)


def chunked_cross_entropy(cfg: ModelConfig, params: dict,
                          hidden: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token NLL with the head product chunked over sequence."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    B, S, _ = hidden.shape
    if mask is None:
        mask = torch.ones((B, S), dtype=f32, device=hidden.device)
    mask = mask.to(f32)
    chunk = min(cfg.logits_chunk, S)
    total = torch.zeros((), dtype=f32, device=hidden.device)
    count = torch.zeros((), dtype=f32, device=hidden.device)
    for lo in range(0, S, chunk):
        hi = min(lo + chunk, S)
        args = (cfg, head, hidden[:, lo:hi], labels[:, lo:hi],
                mask[:, lo:hi])
        if torch.is_grad_enabled():
            t, c = checkpoint(_chunk_ce, *args, use_reentrant=False)
        else:
            t, c = _chunk_ce(*args)
        total, count = total + t, count + c
    return total / torch.clamp(count, min=1.0)


def lm_loss(cfg: ModelConfig, params: dict, hidden: torch.Tensor,
            labels: torch.Tensor, aux: torch.Tensor,
            mask: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, dict]:
    ce = chunked_cross_entropy(cfg, params, hidden, labels, mask)
    loss = ce + cfg.router_aux_coef * aux
    return loss, {"loss": loss, "ce": ce, "router_aux": aux}
