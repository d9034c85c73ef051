"""Losses: cross-entropy over large vocabularies in sequence chunks.

The JAX package's ``models/loss.py``.  The logits of a 128k-256k vocab at
training batch sizes are gigabytes, so the head product and the softmax run
in chunks of ``min(cfg.logits_chunk, S)`` positions (the last may be
short), and each chunk is recomputed in the backward
(``torch.utils.checkpoint``, as ``jax.checkpoint`` there): live memory is
one chunk's logits.  The JAX function's ``sharder`` becomes ``tp`` (a
``distributed.tensor_parallel.TensorParallel``): the hidden states are
gathered over the sequence (the reference's ``loss.py:32``) and the
cross-entropy is vocab-parallel -- each rank's logits are its vocab shard's
("batch", None, "act_vocab"), the max and the sum of exps are reduced over
"model", and the gold logit comes from the shard that owns it.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from . import transformer as T
from .config import ModelConfig

__all__ = ["chunked_cross_entropy", "lm_loss"]

f32 = torch.float32


def _chunk_ce(cfg: ModelConfig, head: torch.Tensor, x: torch.Tensor,
              labels: torch.Tensor, mask: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """CE over one chunk.  x (B, C, d), labels (B, C) -> (sum of the masked
    NLL, sum of the mask)."""
    z = T.mask_logits(cfg, x.to(f32) @ head.to(f32))
    lse = torch.logsumexp(z, dim=-1)                               # (B, C)
    gold = torch.gather(z, -1, labels[..., None].long())[..., 0]
    nll = (lse - gold) * mask
    return torch.sum(nll), torch.sum(mask)


def _chunk_ce_vocab_parallel(cfg: ModelConfig, tp, col0: int,
                             head: torch.Tensor, x: torch.Tensor,
                             labels: torch.Tensor, mask: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """``_chunk_ce`` on this rank's vocab shard (global columns from
    ``col0``) of the same logits: each rank's logsumexp of its shard, the
    shards' combined over "model" about their max (on one rank exactly
    the shard's), and the gold logit summed from the shard that owns it."""
    z = T.mask_logits(cfg, x.to(f32) @ head.to(f32), col0)
    tp.check(z, ("batch", None, "act_vocab"),
             (tp.rows, z.shape[1], cfg.padded_vocab))
    part = torch.logsumexp(z, dim=-1)                              # (B, C)
    top = tp.max(part)                                 # no gradient
    lse = top + torch.log(tp.reduce(torch.exp(part - top)))
    n = z.shape[-1]
    ids = labels.long() - col0
    own = (ids >= 0) & (ids < n)
    gold = torch.gather(z, -1, torch.where(own, ids, 0)[..., None])[..., 0]
    gold = tp.reduce(torch.where(own, gold, 0.0))
    nll = (lse - gold) * mask
    return torch.sum(nll), torch.sum(mask)


def chunked_cross_entropy(cfg: ModelConfig, params: dict,
                          hidden: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor | None = None, tp=None
                          ) -> torch.Tensor:
    """Mean next-token NLL with the head product chunked over sequence
    (with ``tp``, ``hidden`` in the residual's layout and the CE
    vocab-parallel)."""
    head, col0 = T.lm_head(cfg, params, tp)
    if tp is not None:
        hidden = tp.gather_seq(hidden)
        chunk_ce = functools.partial(_chunk_ce_vocab_parallel, cfg, tp,
                                     col0)
    else:
        chunk_ce = functools.partial(_chunk_ce, cfg)
    B, S, _ = hidden.shape
    if mask is None:
        mask = torch.ones((B, S), dtype=f32, device=hidden.device)
    mask = mask.to(f32)
    chunk = min(cfg.logits_chunk, S)
    total = torch.zeros((), dtype=f32, device=hidden.device)
    count = torch.zeros((), dtype=f32, device=hidden.device)
    for lo in range(0, S, chunk):
        hi = min(lo + chunk, S)
        args = (head, hidden[:, lo:hi], labels[:, lo:hi], mask[:, lo:hi])
        if torch.is_grad_enabled():
            t, c = checkpoint(chunk_ce, *args, use_reentrant=False)
        else:
            t, c = chunk_ce(*args)
        total, count = total + t, count + c
    return total / torch.clamp(count, min=1.0)


def lm_loss(cfg: ModelConfig, params: dict, hidden: torch.Tensor,
            labels: torch.Tensor, aux: torch.Tensor,
            mask: torch.Tensor | None = None, tp=None
            ) -> tuple[torch.Tensor, dict]:
    ce = chunked_cross_entropy(cfg, params, hidden, labels, mask, tp)
    loss = ce + cfg.router_aux_coef * aux
    return loss, {"loss": loss, "ce": ce, "router_aux": aux}
