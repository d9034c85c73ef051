"""AdamW, as the JAX package writes it: f32 arithmetic per leaf, the same
bias correction, clipping by the global norm before the moments.

``adamw_update_`` writes the step into the parameter and moment tensors it
is given (and the step counter), as the reference's train step does under
donation; ``adamw_update`` returns new trees, as the reference does, by
running it on fresh copies, so their bits agree.  It updates each leaf in
flat chunks of at most ``UPDATE_CHUNK`` elements, applying the clip's scale
chunk by chunk: the bits are those of one whole-leaf pass, but the f32
temporaries stay at a chunk's size and no scaled copy of the gradients is
made (a 3.7 B-parameter model's 805 M-element expert leaves would otherwise
need ~20 GB of them).  A chunk's new values are computed from its old ones
before they are written, so writing in place is safe.  The global norm
squares a leaf of more than ``NORM_CHUNK`` elements in chunks too, which
changes the order of its f32 sum, not the arithmetic; it is a constant of
its own so that the update's chunk can change without moving the norm's
bits.  The moments' dtype is ``AdamWConfig.state_dtype`` (f32 by
default).  The reference can round a bf16 parameter stochastically from a
``jax.random`` key (``sr_key``); the port draws the rounding noise from a
``torch.Generator`` (``sr_gen``), leaf by leaf in tree order, so its bits
differ from the reference's by design.  The train step passes neither, so
it rounds to nearest in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..tree import tree_leaves, tree_map, tree_paths

__all__ = ["AdamWConfig", "NORM_CHUNK", "UPDATE_CHUNK", "adamw_init",
           "adamw_update", "adamw_update_", "clip_by_global_norm",
           "global_norm", "stochastic_round"]

f32 = torch.float32
UPDATE_CHUNK = 1 << 26      # elements of a leaf updated at a time
NORM_CHUNK = 1 << 26        # elements of a leaf squared at a time


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


def _sum_of_squares(leaf: torch.Tensor) -> torch.Tensor:
    """The f32 sum of a leaf's squares; a leaf of more than ``NORM_CHUNK``
    elements is summed chunk by chunk, so its f32 copy and square stay at
    a chunk's size."""
    if leaf.numel() <= NORM_CHUNK:
        return torch.sum(torch.square(leaf.to(f32)))
    return sum(torch.sum(torch.square(c.to(f32)))
               for c in leaf.reshape(-1).split(NORM_CHUNK))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32."""
    return torch.sqrt(sum(_sum_of_squares(l) for l in tree_leaves(tree)))


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


def _check_in_place(cfg: AdamWConfig, params, state: dict) -> None:
    """Refuse trees that an in-place step would corrupt: a leaf that is not
    contiguous (its flat view would be a copy), a moment not in
    ``cfg.state_dtype``, or two leaves on one storage (the step would apply
    twice to it)."""
    moments = tree_paths({"mu": state["mu"], "nu": state["nu"]})
    for path, t in moments:
        if t.dtype != cfg.state_dtype:
            raise ValueError(f"{path} is {t.dtype}, not the config's "
                             f"state dtype {cfg.state_dtype}")
    seen = {}
    for path, t in tree_paths({"params": params}) + moments:
        if not t.is_contiguous():
            raise ValueError(f"{path} is not contiguous: an in-place AdamW "
                             f"step cannot write it")
        if t.numel() == 0:
            continue
        key = (t.device, t.untyped_storage().data_ptr())
        if key in seen:
            raise ValueError(f"{path} shares its storage with {seen[key]}: "
                             f"an in-place AdamW step would apply twice to it")
        seen[key] = path


@torch.no_grad()
def adamw_update_(cfg: AdamWConfig, grads, state: dict, params,
                  sr_gen: torch.Generator | None = None):
    """One AdamW step written into ``params``' and ``state``'s own tensors
    (the step counter too).  Returns (params, state, metrics), the trees it
    was given: metrics holds ``lr`` and, when clipping, ``grad_norm``
    (before the clip)."""
    _check_in_place(cfg, params, state)
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

    for g, p, mu, nu in zip(tree_leaves(grads), tree_leaves(params),
                            tree_leaves(state["mu"]),
                            tree_leaves(state["nu"])):
        # stochastic rounding draws the leaf's noise in one piece
        whole = sr_gen is not None and p.dtype == torch.bfloat16
        n = p.numel()
        chunk = max(n, 1) if whole else UPDATE_CHUNK
        flat = [t.reshape(-1) for t in (g, p, mu, nu)]
        for a in range(0, n, chunk):
            gc, pc, muc, nuc = (t[a:a + chunk] for t in flat)
            if scale is not None:
                gc = _scaled(gc, scale)
            g32 = gc.to(f32)
            mu32 = cfg.b1 * muc.to(f32) + (1.0 - cfg.b1) * g32
            nu32 = cfg.b2 * nuc.to(f32) + (1.0 - cfg.b2) * g32 * g32
            upd = (mu32 / b1c) / (torch.sqrt(nu32 / b2c) + cfg.eps)
            p32 = pc.to(f32) * (1.0 - lr * cfg.weight_decay) - lr * upd
            if whole:
                pc.copy_(stochastic_round(p32.view(p.shape), sr_gen)
                         .reshape(-1))
            else:
                pc.copy_(p32.to(p.dtype))
            muc.copy_(mu32.to(cfg.state_dtype))
            nuc.copy_(nu32.to(cfg.state_dtype))
    state["step"].copy_(step)
    metrics["lr"] = lr
    return params, state, metrics


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state: dict, params,
                 sr_gen: torch.Generator | None = None):
    """One AdamW step into new tensors, as the reference returns it:
    ``adamw_update_`` on fresh contiguous copies of the parameters, of the
    moments (in ``cfg.state_dtype``) and of the step.  Returns (new_params,
    new_state, metrics)."""
    def moment(m):
        return m.to(cfg.state_dtype, memory_format=torch.contiguous_format,
                    copy=True)
    new_p = tree_map(lambda p: p.clone(
        memory_format=torch.contiguous_format), params)
    new_state = {"mu": tree_map(moment, state["mu"]),
                 "nu": tree_map(moment, state["nu"]),
                 "step": state["step"].clone()}
    return adamw_update_(cfg, grads, new_state, new_p, sr_gen)
