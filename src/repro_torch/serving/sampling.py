"""Token sampling for the serving engine.

``greedy`` is the JAX package's.  ``sample`` draws from a ``torch.Generator``:
the draws cannot match JAX's PRNG for the same seed, only the distribution.
"""

from __future__ import annotations

import torch

__all__ = ["greedy", "sample"]


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample(logits: torch.Tensor, generator: torch.Generator,
           temperature: float = 1.0, top_k: int | None = None
           ) -> torch.Tensor:
    if temperature <= 0.0:
        return greedy(logits)
    z = logits.float() / temperature
    if top_k is not None:
        cutoff = torch.topk(z, top_k, dim=-1).values[..., -1:]
        z = z.masked_fill(z < cutoff, -1e30)
    probs = torch.softmax(z, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[..., 0].to(
        torch.int32)
