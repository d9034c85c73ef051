"""AdamW, as the JAX package writes it: f32 arithmetic per leaf, the same
bias correction, clipping by the global norm before the moments.

``adamw_update`` returns new trees, as the reference does.  The moments'
dtype is ``AdamWConfig.state_dtype`` (f32 by default).  The reference can round a bf16 parameter
stochastically from a ``jax.random`` key (``sr_key``); the port draws the
rounding noise from a ``torch.Generator`` (``sr_gen``), leaf by leaf in
tree order, so its bits differ from the reference's by design.  The train
step passes neither, so it rounds to nearest in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "clip_by_global_norm",
           "global_norm", "stochastic_round"]

f32 = torch.float32


@dataclass(frozen=True)
class AdamWConfig:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: Any = f32
    clip_norm: float | None = 1.0


def adamw_init(cfg: AdamWConfig, params) -> dict:
    """Zero moments in ``cfg.state_dtype`` and an int32 step of 0, on the
    parameters' device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)
    device = tree_leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(l.to(f32)))
                          for l in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled by min(1, max_norm / its global norm), the norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(f32) * scale).to(g.dtype), tree), norm


def stochastic_round(x: torch.Tensor, generator: torch.Generator
                     ) -> torch.Tensor:
    """Unbiased rounding of f32 ``x`` to bf16: 16 random low bits added to
    its bit pattern before truncation (the reference's rule, with noise
    from ``generator`` instead of a ``jax.random`` key)."""
    bits = x.to(f32).contiguous().view(torch.int32).to(torch.int64) \
        & 0xFFFFFFFF
    noise = torch.randint(0, 1 << 16, x.shape, generator=generator,
                          device=x.device, dtype=torch.int64)
    hi = ((bits + noise) >> 16) & 0xFFFF
    return torch.where(hi >= 1 << 15, hi - (1 << 16), hi).to(
        torch.int16).view(torch.bfloat16)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state: dict, params,
                 sr_gen: torch.Generator | None = None):
    """One AdamW step.  Returns (new_params, new_state, metrics): metrics
    holds ``lr`` and, when clipping, ``grad_norm`` (before the clip)."""
    step = state["step"] + 1
    lr = cfg.lr(step) if callable(cfg.lr) else torch.full(
        (), cfg.lr, dtype=f32, device=step.device)

    metrics = {}
    if cfg.clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
        metrics["grad_norm"] = gnorm

    sf = step.to(f32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=f32, device=sf.device),
                          sf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=f32, device=sf.device),
                          sf)

    new_p, new_mu, new_nu = [], [], []
    for g, p, mu, nu in zip(tree_leaves(grads), tree_leaves(params),
                            tree_leaves(state["mu"]),
                            tree_leaves(state["nu"])):
        g32 = g.to(f32)
        mu32 = cfg.b1 * mu.to(f32) + (1.0 - cfg.b1) * g32
        nu32 = cfg.b2 * nu.to(f32) + (1.0 - cfg.b2) * g32 * g32
        upd = (mu32 / b1c) / (torch.sqrt(nu32 / b2c) + cfg.eps)
        p32 = p.to(f32) * (1.0 - lr * cfg.weight_decay) - lr * upd
        if sr_gen is not None and p.dtype == torch.bfloat16:
            new_p.append(stochastic_round(p32, sr_gen))
        else:
            new_p.append(p32.to(p.dtype))
        new_mu.append(mu32.to(cfg.state_dtype))
        new_nu.append(nu32.to(cfg.state_dtype))

    metrics["lr"] = lr
    return (tree_unflatten(params, new_p),
            {"mu": tree_unflatten(params, new_mu),
             "nu": tree_unflatten(params, new_nu), "step": step},
            metrics)
