"""Model layers: RMS norm, RoPE, GQA attention, the dense MLP and the
Mamba-2 (SSD) mixer.

The JAX package's ``models/layers.py`` as plain functions over dicts of
tensors.  Full-sequence attention (prefill) routes through
``kernels.ops.flash_attention`` and the full-sequence Mamba-2 mixer through
``kernels.ops.ssd_scan`` -- the tuned CUDA kernels for CUDA tensors, their
plain versions for CPU tensors -- unless the caller passes another
``attn_op`` / ``ssd_op`` of the same signature (a reference run does).
One-token decode (attention over the KV cache, the Mamba-2 recurrence on its
conv and SSM states) is plain PyTorch, as the JAX package computes it outside
any kernel.  The projections are ``@`` (``torch.matmul``), as they are ``@``
in JAX.  The JAX functions' ``sharder`` argument is dropped: the port runs on
one device.

The MoE MLP is not ported yet: its spec and layer functions raise and name
their ROADMAP item.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import BlockDesc, ModelConfig
from .module import ParamSpec

__all__ = [
    "AttnOp", "SsdOp", "attention", "attention_decode", "mamba",
    "mamba_decode", "mlp", "moe", "rmsnorm", "rope", "spec_attention",
    "spec_mamba", "spec_mlp", "spec_moe",
]

f32 = torch.float32
AttnOp = Callable[..., torch.Tensor]
SsdOp = Callable[..., torch.Tensor]

MOE_TODO = ("MoE layers are not ported yet (ROADMAP Queue A, 'Other "
            "architectures')")


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
# Mamba-2 (SSD) mixer
# ---------------------------------------------------------------------------

def spec_mamba(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di, n, Hm = cfg.mamba_d_inner, cfg.ssm_state, cfg.mamba_heads
    proj_out = 2 * di + 2 * n + Hm
    return {
        "norm": ParamSpec((d,), f32, (None,), "zeros"),
        "in_proj": ParamSpec((d, proj_out), cfg.dtype,
                             ("embed", "mamba_inner"), "scaled"),
        "conv_w": ParamSpec((cfg.conv_kernel, di + 2 * n), cfg.dtype,
                            ("conv_k", "mamba_inner"), "scaled"),
        "conv_b": ParamSpec((di + 2 * n,), f32, ("mamba_inner",), "zeros"),
        "A_log": ParamSpec((Hm,), f32, (None,), "zeros"),
        "D": ParamSpec((Hm,), f32, (None,), "ones"),
        "dt_bias": ParamSpec((Hm,), f32, (None,), "zeros"),
        "ssm_norm": ParamSpec((di,), f32, (None,), "zeros"),
        "out_proj": ParamSpec((di, d), cfg.dtype, ("mamba_inner", "embed"),
                              "scaled"),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv over seq: xbc (B, S, Cc), w (K, Cc); f32 sums,
    the result in xbc's dtype."""
    K = w.shape[0]
    S = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = torch.zeros(xbc.shape, dtype=f32, device=xbc.device)
    for i in range(K):
        out = out + pad[:, i:i + S].float() * w[i].float()
    return (out + b.float()).to(xbc.dtype)


def mamba(cfg: ModelConfig, p: dict, x: torch.Tensor,
          ssd_op: SsdOp | None = None) -> torch.Tensor:
    """Full-sequence Mamba-2 mixer (prefill).  x (B, S, d) -> (B, S, d).

    ``ssd_op`` defaults to ``ops.ssd_scan``; it takes x (B * Hm, S, dh), dt
    (B * Hm, S) and A (B * Hm,) as the JAX layer hands them to its SSD, and
    B and C as (B, S, n), each shared by the Hm heads of a batch row, where
    the JAX layer copies them per head.
    """
    ssd_op = ssd_op or ops.ssd_scan
    B, S, _ = x.shape
    di, n, Hm = cfg.mamba_d_inner, cfg.ssm_state, cfg.mamba_heads
    dh = cfg.mamba_head_dim

    proj = x @ p["in_proj"]                                 # (B,S,2di+2n+Hm)
    z, xin, Bc, Cc, dt = torch.split(proj, [di, di, n, n, Hm], dim=-1)
    xbc = _causal_conv(torch.cat([xin, Bc, Cc], dim=-1), p["conv_w"],
                       p["conv_b"])
    xbc = F.silu(xbc.float()).to(x.dtype)
    xin, Bc, Cc = torch.split(xbc, [di, n, n], dim=-1)

    dtv = F.softplus(dt.float() + p["dt_bias"])             # (B,S,Hm)
    A = -torch.exp(p["A_log"])                              # (Hm,)

    xh = xin.reshape(B, S, Hm, dh).transpose(1, 2).reshape(B * Hm, S, dh)
    dth = dtv.transpose(1, 2).reshape(B * Hm, S)
    # B and C are shared by the heads: the kernel reads them once per group
    Ah = A[None, :].expand(B, Hm).reshape(B * Hm).contiguous()
    y = ssd_op(xh.contiguous(), dth.contiguous(), Bc.contiguous(),
               Cc.contiguous(), Ah)
    y = y.reshape(B, Hm, S, dh).transpose(1, 2).reshape(B, S, di)
    y = y + (p["D"][None, None, :, None]
             * xin.reshape(B, S, Hm, dh).float()).reshape(B, S, di
                                                          ).to(y.dtype)
    y = y * F.silu(z.float()).to(y.dtype)
    y = rmsnorm(y, p["ssm_norm"], cfg.rms_eps)
    return y @ p["out_proj"]


def mamba_decode(cfg: ModelConfig, p: dict, x1: torch.Tensor,
                 conv_state: torch.Tensor, ssm_state: torch.Tensor):
    """Single-token Mamba-2 step.

    conv_state: (B, K-1, di+2n) trailing inputs; ssm_state: (B, Hm, n, dh).
    Both are updated in place, where the JAX function returns new arrays;
    the states it returns are the ones it was given.
    Returns (y, conv_state, ssm_state).
    """
    B = x1.shape[0]
    di, n, Hm = cfg.mamba_d_inner, cfg.ssm_state, cfg.mamba_heads
    dh = cfg.mamba_head_dim

    proj = x1[:, 0] @ p["in_proj"]                          # (B, ...)
    z, xin, Bc, Cc, dt = torch.split(proj, [di, di, n, n, Hm], dim=-1)
    xbc_new = torch.cat([xin, Bc, Cc], dim=-1)              # (B, di+2n)

    full = torch.cat([conv_state, xbc_new[:, None]], dim=1)  # (B, K, .)
    conv = torch.einsum("bkc,kc->bc", full.float(),
                        p["conv_w"].float()) + p["conv_b"]
    conv = F.silu(conv)
    xin, Bc, Cc = torch.split(conv, [di, n, n], dim=-1)     # f32

    dtv = F.softplus(dt.float() + p["dt_bias"])             # (B,Hm)
    A = -torch.exp(p["A_log"])                              # (Hm,)
    decay = torch.exp(A[None] * dtv)                        # (B,Hm)
    xh = xin.reshape(B, Hm, dh)
    new_state = decay[..., None, None] * ssm_state + \
        (dtv[..., None, None] * Bc[:, None, :, None] * xh[:, :, None, :])
    y = torch.einsum("bn,bhnd->bhd", Cc, new_state)         # (B,Hm,dh)
    y = y + p["D"][None, :, None] * xh
    y = y.reshape(B, 1, di)
    y = y * F.silu(z.float())[:, None]
    y = rmsnorm(y.to(x1.dtype), p["ssm_norm"], cfg.rms_eps)
    conv_state.copy_(full[:, 1:])
    ssm_state.copy_(new_state)
    return y @ p["out_proj"], conv_state, ssm_state


# ---------------------------------------------------------------------------
# not ported yet
# ---------------------------------------------------------------------------

def spec_moe(cfg: ModelConfig) -> dict:
    raise NotImplementedError(MOE_TODO)


def moe(cfg: ModelConfig, p: dict, x: torch.Tensor):
    raise NotImplementedError(MOE_TODO)
