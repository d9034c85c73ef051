"""Model layers: RMS norm, RoPE, GQA attention, the dense MLP, the MoE MLP
and the Mamba-2 (SSD) mixer.

The JAX package's ``models/layers.py`` as plain functions over dicts of
tensors.  Full-sequence attention (prefill) routes through
``kernels.ops.flash_attention``, the full-sequence Mamba-2 mixer through
``kernels.ops.ssd_scan`` and the MoE layer's three expert products (in
prefill and decode alike) through ``kernels.ops.moe_gmm`` -- the tuned CUDA
kernels for CUDA tensors, their plain versions for CPU tensors -- unless the
caller passes another ``attn_op`` / ``ssd_op`` / ``gmm_op`` of the same
signature (a reference run does).  The JAX MoE layer computes its expert
products with ``einsum``; the port's goes through the tuned grouped matmul,
which the JAX package tunes for serving but calls from no layer.  One-token
decode attention and the Mamba-2 recurrence are plain PyTorch, as the JAX
package computes them outside any kernel.  The projections and the router
are ``@`` (``torch.matmul``), as they are ``@`` / ``einsum`` in JAX.  The
JAX functions' ``sharder`` argument is dropped: the port runs on one device.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import BlockDesc, ModelConfig
from .module import ParamSpec

__all__ = [
    "AttnOp", "GmmOp", "SsdOp", "attention", "attention_decode", "mamba",
    "mamba_decode", "mlp", "moe", "moe_capacity", "moe_groups", "moe_route",
    "rmsnorm", "rope", "spec_attention", "spec_mamba", "spec_mlp",
    "spec_moe",
]

f32 = torch.float32
AttnOp = Callable[..., torch.Tensor]
SsdOp = Callable[..., torch.Tensor]
GmmOp = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


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
# MoE MLP (top-k router, sort-based capacity dispatch, grouped expert FFN)
# ---------------------------------------------------------------------------

def spec_moe(cfg: ModelConfig) -> dict:
    d, f, E = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.n_experts
    return {
        "mlp_norm": ParamSpec((d,), f32, (None,), "zeros"),
        "router": ParamSpec((d, E), f32, ("embed", None), "scaled"),
        "we_gate": ParamSpec((E, d, f), cfg.dtype,
                             ("experts", "embed", "mlp"), "scaled"),
        "we_up": ParamSpec((E, d, f), cfg.dtype,
                           ("experts", "embed", "mlp"), "scaled"),
        "we_down": ParamSpec((E, f, d), cfg.dtype,
                             ("experts", "mlp", "embed"), "scaled"),
    }


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots per expert for a group of ``n_tokens``: the capacity factor's
    share, rounded up to a multiple of 8, at least 8."""
    cap = math.ceil(n_tokens * cfg.top_k * cfg.capacity_factor
                    / cfg.n_experts)
    return max(8, ((cap + 7) // 8) * 8)


def moe_groups(cfg: ModelConfig, n_tokens: int) -> tuple[int, int, int]:
    """(groups G, tokens per group, slots per expert per group C) of a MoE
    layer over ``n_tokens``: the expert products run at G * C rows per
    expert."""
    size = min(cfg.moe_group, n_tokens)
    if n_tokens % size:
        raise ValueError(f"{n_tokens} tokens do not split into MoE groups "
                         f"of {size}")
    return n_tokens // size, size, moe_capacity(cfg, size)


def moe_route(cfg: ModelConfig, p: dict, xg: torch.Tensor):
    """The router over token groups xg (G, g, d): logits of xg and the
    router in xg's dtype, summed in f32; softmax; the top-k experts and
    their gates renormalised to sum 1 (floor 1e-9).  Returns (probs (G, g,
    E), gate (G, g, k), expert (G, g, k)), f32, f32 and int64."""
    logits = xg.float() @ p["router"].to(xg.dtype).float()
    probs = torch.softmax(logits, dim=-1)
    gate, expert = torch.topk(probs, cfg.top_k, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, expert


def moe(cfg: ModelConfig, p: dict, x: torch.Tensor,
        gmm_op: GmmOp | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k MoE over x (B, S, d): grouped local dispatch into capacity
    slots, the expert FFN as three grouped matmuls, the gated combine.

    Tokens are split into groups of ``moe_group``.  Each group sorts its
    (token, choice) pairs stably by expert; a pair's rank among its
    expert's pairs picks its slot ``expert * C + rank``, and pairs of rank
    >= C are dropped (their token keeps only its other choices, and the
    residual).  The slots of every group are gathered into (E, G * C, d),
    and ``gmm_op`` (default ``ops.moe_gmm``, the tuned grouped matmul) runs
    the gate, up and down products on it.

    The combine gathers each token's k slot outputs into (T, k, d),
    multiplies each by its gate in x's dtype (as JAX does), and sums the k
    terms in f32 before one cast.  The JAX layer scatter-adds the terms in
    x's dtype instead; in bf16 that rounds after every add, so the two sit
    up to k - 1 bf16 roundings apart, and in f32 they differ by the order
    of the sum.  The gather form needs no atomics and gives the same bits
    on every run.  Dispatch writes each kept pair into its own slot (the
    slots are unique) and reads zeros for empty slots, so it equals the
    JAX scatter-add exactly.

    Returns (y (B, S, d), the Switch load-balance aux loss of the top-1
    choices, f32).
    """
    gmm_op = gmm_op or ops.moe_gmm
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    G, g_size, C = moe_groups(cfg, T)
    dev = x.device
    xg = x.reshape(G, g_size, d)
    probs, gate, expert = moe_route(cfg, p, xg)

    gk = g_size * k
    flat_e = expert.reshape(G, gk)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = flat_e.gather(1, order)                        # sorted experts
    st = order // k                                     # their tokens
    starts = torch.searchsorted(
        se, torch.arange(E, device=dev).expand(G, E).contiguous())
    rank = torch.arange(gk, device=dev) - starts.gather(1, se)
    keep = rank < C
    slot = se * C + torch.where(keep, rank, 0)

    # dispatch: the token of every slot (g_size, a zero row, where none)
    rows = torch.arange(G, device=dev)[:, None]
    src = torch.full((G, E * C + 1), g_size, dtype=torch.long, device=dev)
    src.scatter_(1, torch.where(keep, slot, E * C), st)   # drops -> spare
    xz = torch.cat([xg, xg.new_zeros(G, 1, d)], dim=1)
    buf = xz[rows, src[:, :E * C]]                      # (G, E * C, d)

    # the expert FFN: (G, E, C, d) -> (E, G * C, d), three grouped matmuls
    xe = buf.view(G, E, C, d).transpose(0, 1).reshape(E, G * C, d)
    h = _act(cfg, gmm_op(xe, p["we_gate"])) * gmm_op(xe, p["we_up"])
    out = gmm_op(h.to(x.dtype), p["we_down"])
    out = out.view(E, G, C, d).transpose(0, 1).reshape(G, E * C, d)

    # combine: each pair's slot, back in (token, choice) order
    pair_slot = torch.empty_like(slot).scatter_(1, order, slot)
    pair_keep = torch.empty_like(keep).scatter_(1, order, keep)
    w = gate.reshape(G, gk).to(out.dtype)[..., None]
    terms = torch.where(pair_keep[..., None], out[rows, pair_slot] * w,
                        torch.zeros((), dtype=out.dtype, device=dev))
    y = terms.view(G, g_size, k, d).float().sum(2).to(x.dtype)

    top1 = expert[..., 0].reshape(T)        # counts of whole tokens: exact
    frac_tokens = torch.zeros(E, device=dev).index_add_(
        0, top1, torch.ones(T, device=dev)) / T
    mean_prob = probs.mean(dim=(0, 1))
    aux = E * torch.sum(frac_tokens * mean_prob)
    return y.reshape(B, S, d), aux


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
