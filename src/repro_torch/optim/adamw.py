"""AdamW, as the JAX package writes it: f32 arithmetic per leaf, the same
bias correction, clipping by the global norm before the moments.

``adamw_update`` returns new trees, as the reference does.  It updates each
leaf in flat chunks of at most ``UPDATE_CHUNK`` elements, applying the
clip's scale chunk by chunk: the bits are those of one whole-leaf pass, but
the f32 temporaries stay at a chunk's size and no scaled copy of the
gradients is made (a 3.7 B-parameter model's 805 M-element expert leaves
would otherwise need ~20 GB of them).  The moments'
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

__all__ = ["AdamWConfig", "UPDATE_CHUNK", "adamw_init", "adamw_update",
           "clip_by_global_norm", "global_norm", "stochastic_round"]

f32 = torch.float32
UPDATE_CHUNK = 1 << 26      # elements of a leaf updated at a time


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


def _clip_scale(tree, max_norm: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(min(1, max_norm / the tree's global norm), the norm)."""
    norm = global_norm(tree)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0), norm


def _scaled(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (g.to(f32) * scale).to(g.dtype)


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled by min(1, max_norm / its global norm), the norm)."""
    scale, norm = _clip_scale(tree, max_norm)
    return tree_map(lambda g: _scaled(g, scale), tree), norm


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
    scale = None
    if cfg.clip_norm is not None:
        scale, metrics["grad_norm"] = _clip_scale(grads, cfg.clip_norm)

    sf = step.to(f32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=f32, device=sf.device),
                          sf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=f32, device=sf.device),
                          sf)

    new_p, new_mu, new_nu = [], [], []
    for g, p, mu, nu in zip(tree_leaves(grads), tree_leaves(params),
                            tree_leaves(state["mu"]),
                            tree_leaves(state["nu"])):
        out_p = torch.empty_like(p, memory_format=torch.contiguous_format)
        out_mu, out_nu = (torch.empty(p.shape, dtype=cfg.state_dtype,
                                      device=p.device) for _ in range(2))
        # stochastic rounding draws the leaf's noise in one piece
        whole = sr_gen is not None and p.dtype == torch.bfloat16
        n = p.numel()
        chunk = max(n, 1) if whole else UPDATE_CHUNK
        flat = [t.reshape(-1) for t in (g, p, mu, nu, out_p, out_mu, out_nu)]
        for a in range(0, n, chunk):
            gc, pc, muc, nuc, op, om, on = (t[a:a + chunk] for t in flat)
            if scale is not None:
                gc = _scaled(gc, scale)
            g32 = gc.to(f32)
            mu32 = cfg.b1 * muc.to(f32) + (1.0 - cfg.b1) * g32
            nu32 = cfg.b2 * nuc.to(f32) + (1.0 - cfg.b2) * g32 * g32
            upd = (mu32 / b1c) / (torch.sqrt(nu32 / b2c) + cfg.eps)
            p32 = pc.to(f32) * (1.0 - lr * cfg.weight_decay) - lr * upd
            if whole:
                op.copy_(stochastic_round(p32.view(p.shape), sr_gen)
                         .reshape(-1))
            else:
                op.copy_(p32.to(p.dtype))
            om.copy_(mu32.to(cfg.state_dtype))
            on.copy_(nu32.to(cfg.state_dtype))
        new_p.append(out_p)
        new_mu.append(out_mu)
        new_nu.append(out_nu)

    metrics["lr"] = lr
    return (tree_unflatten(params, new_p),
            {"mu": tree_unflatten(params, new_mu),
             "nu": tree_unflatten(params, new_nu), "step": step},
            metrics)
