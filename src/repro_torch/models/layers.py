"""Model layers: RMS norm, RoPE, GQA attention and the dense MLP.

The JAX package's ``models/layers.py`` as plain functions over dicts of
tensors.  Full-sequence attention (prefill) routes through
``kernels.ops.flash_attention`` -- the tuned CUDA kernel for CUDA tensors,
its plain version for CPU tensors -- unless the caller passes another
``attn_op`` of the same signature (a reference run does).  One-token decode
attention is plain PyTorch over the KV cache, as the JAX package computes it
outside any kernel.  The projections are ``@`` (``torch.matmul``), as they
are ``@`` in JAX.  The JAX functions' ``sharder`` argument is dropped: the
port runs on one device.

The MoE MLP and the Mamba-2 mixer are not ported yet: their spec and layer
functions raise and name their ROADMAP item.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import BlockDesc, ModelConfig
from .module import ParamSpec

__all__ = [
    "AttnOp", "attention", "attention_decode", "mamba", "mlp", "moe", "rmsnorm",
    "rope", "spec_attention", "spec_mamba", "spec_mlp", "spec_moe",
]

f32 = torch.float32
AttnOp = Callable[..., torch.Tensor]

MOE_TODO = ("MoE layers are not ported yet (ROADMAP Queue A, 'Other "
            "architectures')")
MAMBA_TODO = ("Mamba-2 layers are not ported yet (ROADMAP Queue A, "
              "'Mamba-2 slice')")


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * (1.0 + w.float())).to(x.dtype)


def _rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=f32, device=device)
                            / half))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding.  x: (..., S, H, dh); positions: (..., S)."""
    half = x.shape[-1] // 2
    freqs = _rope_freqs(x.shape[-1], theta, x.device)          # (half,)
    angles = positions[..., :, None].float() * freqs            # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                       # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA + window + softcap + qk-norm; self and cross)
# ---------------------------------------------------------------------------

def spec_attention(cfg: ModelConfig, prefix: str = "") -> dict:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    p = {
        f"{prefix}norm": ParamSpec((d,), f32, (None,), "zeros"),
        f"{prefix}wq": ParamSpec((d, qd), cfg.dtype, ("embed", "heads"),
                                 "scaled"),
        f"{prefix}wk": ParamSpec((d, kvd), cfg.dtype, ("embed", "kv_heads"),
                                 "scaled"),
        f"{prefix}wv": ParamSpec((d, kvd), cfg.dtype, ("embed", "kv_heads"),
                                 "scaled"),
        f"{prefix}wo": ParamSpec((qd, d), cfg.dtype, ("heads", "embed"),
                                 "scaled"),
    }
    if cfg.qk_norm:
        p[f"{prefix}q_norm"] = ParamSpec((cfg.head_dim,), f32, (None,),
                                         "zeros")
        p[f"{prefix}k_norm"] = ParamSpec((cfg.head_dim,), f32, (None,),
                                         "zeros")
    return p


def _project_qkv(cfg: ModelConfig, p: dict, xq: torch.Tensor,
                 xkv: torch.Tensor, prefix: str = ""):
    B, Sq, _ = xq.shape
    Skv = xkv.shape[1]
    q = (xq @ p[f"{prefix}wq"]).reshape(B, Sq, cfg.n_heads, cfg.head_dim)
    k = (xkv @ p[f"{prefix}wk"]).reshape(B, Skv, cfg.n_kv_heads,
                                         cfg.head_dim)
    v = (xkv @ p[f"{prefix}wv"]).reshape(B, Skv, cfg.n_kv_heads,
                                         cfg.head_dim)
    if cfg.qk_norm and f"{prefix}q_norm" in p:
        q = rmsnorm(q, p[f"{prefix}q_norm"], cfg.rms_eps)
        k = rmsnorm(k, p[f"{prefix}k_norm"], cfg.rms_eps)
    return q, k, v


def _heads_first(t: torch.Tensor) -> torch.Tensor:
    """(B, S, H, dh) -> contiguous (B * H, S, dh), the kernel's layout."""
    B, S, H, dh = t.shape
    return t.transpose(1, 2).reshape(B * H, S, dh).contiguous()


def attention(cfg: ModelConfig, p: dict, xq: torch.Tensor, desc: BlockDesc,
              positions: torch.Tensor, xkv: torch.Tensor | None = None,
              causal: bool | None = None, prefix: str = "",
              attn_op: AttnOp | None = None) -> torch.Tensor:
    """Full-sequence attention (prefill).  Self unless xkv given.

    ``attn_op`` defaults to ``ops.flash_attention``; it takes and returns
    the kernel layout (b * heads, s, head_dim).
    """
    attn_op = attn_op or ops.flash_attention
    cross = xkv is not None
    xkv = xq if xkv is None else xkv
    B, Sq, _ = xq.shape
    q, k, v = _project_qkv(cfg, p, xq, xkv, prefix)
    if not cross:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    causal = cfg.causal if causal is None else causal
    causal = causal and not cross
    out = attn_op(
        _heads_first(q), _heads_first(k), _heads_first(v),
        num_q_heads=cfg.n_heads, num_kv_heads=cfg.n_kv_heads, causal=causal,
        window=desc.window, softcap=cfg.attn_softcap, q_chunk=cfg.attn_chunk)
    out = out.reshape(B, cfg.n_heads, Sq, cfg.head_dim).transpose(1, 2)
    return out.reshape(B, Sq, cfg.q_dim) @ p[f"{prefix}wo"]


def attention_decode(cfg: ModelConfig, p: dict, x1: torch.Tensor,
                     desc: BlockDesc, pos: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     cross: bool = False, prefix: str = ""):
    """One-token decode against a (B, S_cache, KV, dh) KV cache.

    For self-attention the new token's k/v are written at position ``pos``
    -- in place, where the JAX function returns new arrays; the caches it
    returns are the ones it was given.  Scores and the weighted sum are
    f32, from the cache's dtype, as JAX's ``preferred_element_type=f32``.
    Returns (y, cache_k, cache_v).
    """
    B = x1.shape[0]
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    group = H // KV
    S = cache_k.shape[1]

    q = (x1 @ p[f"{prefix}wq"]).reshape(B, 1, H, dh)
    if cfg.qk_norm and f"{prefix}q_norm" in p:
        q = rmsnorm(q, p[f"{prefix}q_norm"], cfg.rms_eps)
    if not cross:
        k1 = (x1 @ p[f"{prefix}wk"]).reshape(B, 1, KV, dh)
        v1 = (x1 @ p[f"{prefix}wv"]).reshape(B, 1, KV, dh)
        if cfg.qk_norm and f"{prefix}k_norm" in p:
            k1 = rmsnorm(k1, p[f"{prefix}k_norm"], cfg.rms_eps)
        q = rope(q, pos[:, None], cfg.rope_theta)
        k1 = rope(k1, pos[:, None], cfg.rope_theta)
        _write_cache(cache_k, k1, pos)
        _write_cache(cache_v, v1, pos)

    qf = q.reshape(B, KV, group, dh).to(cache_k.dtype)
    scale = dh ** -0.5
    s = torch.einsum("bkgd,bskd->bkgs", qf.float(),
                     cache_k.float()) * scale                 # (B, KV, g, S)
    if cfg.attn_softcap is not None:
        s = cfg.attn_softcap * torch.tanh(s / cfg.attn_softcap)
    kpos = torch.arange(S, device=x1.device)[None, None, None, :]
    mask = kpos <= pos[:, None, None, None]
    if desc.window is not None and not cross:
        mask &= kpos > (pos[:, None, None, None] - desc.window)
    if cross:
        mask = torch.ones_like(mask)
    w = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w.to(cache_v.dtype).float(),
                       cache_v.float())                       # (B, KV, g, dh)
    out = out.reshape(B, 1, H * dh).to(x1.dtype)
    return out @ p[f"{prefix}wo"], cache_k, cache_v


def _write_cache(cache: torch.Tensor, new: torch.Tensor,
                 pos: torch.Tensor) -> None:
    """Write (B, 1, KV, dh) ``new`` into (B, S, KV, dh) ``cache`` at pos,
    in place; a position outside [0, S) writes nothing (as JAX's one-hot
    blend does)."""
    B, S = cache.shape[:2]
    valid = ((pos >= 0) & (pos < S))[:, None, None]
    rows = torch.arange(B, device=cache.device)
    at = pos.long().clamp(0, S - 1)
    cache[rows, at] = torch.where(valid, new[:, 0].to(cache.dtype),
                                  cache[rows, at])


# ---------------------------------------------------------------------------
# dense MLP
# ---------------------------------------------------------------------------

def spec_mlp(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mlp_norm": ParamSpec((d,), f32, (None,), "zeros"),
        "w_gate": ParamSpec((d, f), cfg.dtype, ("embed", "mlp"), "scaled"),
        "w_up": ParamSpec((d, f), cfg.dtype, ("embed", "mlp"), "scaled"),
        "w_down": ParamSpec((f, d), cfg.dtype, ("mlp", "embed"), "scaled"),
    }


def _act(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "gelu":
        return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default
    return F.silu(x)


def mlp(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    h = _act(cfg, x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# not ported yet
# ---------------------------------------------------------------------------

def spec_moe(cfg: ModelConfig) -> dict:
    raise NotImplementedError(MOE_TODO)


def moe(cfg: ModelConfig, p: dict, x: torch.Tensor):
    raise NotImplementedError(MOE_TODO)


def spec_mamba(cfg: ModelConfig) -> dict:
    raise NotImplementedError(MAMBA_TODO)


def mamba(cfg: ModelConfig, p: dict, x: torch.Tensor):
    raise NotImplementedError(MAMBA_TODO)
