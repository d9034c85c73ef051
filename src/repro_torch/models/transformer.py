"""Decoder stack over block patterns: specs, forward, decode step, cache.

The JAX package's ``models/transformer.py`` for the dense attention stack
and the attention-free Mamba-2 stack.  Parameters for one pattern period are
stacked along a leading "layers" axis (the same tree as JAX's, so weights
convert one to one); where JAX ``lax.scan``s over the groups, the port loops
over them in Python and runs each layer on views of the stacked leaves.  The
decode cache carries the same leading axis and is updated in place.
"""

from __future__ import annotations

import math

import torch

from . import layers as L
from .config import BlockDesc, ModelConfig
from .module import ParamSpec, spec_tree_map

__all__ = [
    "decode_kernel_requests", "decode_step", "embed_tokens",
    "forward", "init_cache_specs", "model_specs", "stack_specs", "unembed",
]

f32 = torch.float32


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

def _block_specs(cfg: ModelConfig, desc: BlockDesc) -> dict:
    sub: dict = {}
    if desc.kind == "attn":
        sub.update(L.spec_attention(cfg))
    elif desc.kind == "mamba":
        sub.update(L.spec_mamba(cfg))
    else:
        raise ValueError(f"unknown block kind {desc.kind}")
    if desc.cross_attn:
        sub.update(L.spec_attention(cfg, prefix="x_"))
    if desc.mlp:
        sub.update(L.spec_moe(cfg) if desc.moe else L.spec_mlp(cfg))
    return sub


def stack_specs(cfg: ModelConfig) -> dict:
    """Per-period block specs, stacked over n_groups on a 'layers' axis."""
    period_specs = {f"pos{i}": _block_specs(cfg, d)
                    for i, d in enumerate(cfg.block_pattern)}
    g = cfg.n_groups

    def stack(s: ParamSpec) -> ParamSpec:
        axes = s.axes if s.axes else tuple(None for _ in s.shape)
        return ParamSpec((g,) + s.shape, s.dtype, ("layers",) + axes, s.init,
                         s.init_scale)

    return spec_tree_map(stack, period_specs)


def model_specs(cfg: ModelConfig) -> dict:
    d, v = cfg.d_model, cfg.padded_vocab
    specs: dict = {
        "embed": ParamSpec((v, d), cfg.dtype, ("vocab", "embed"), "normal",
                           0.02),
        "final_norm": ParamSpec((d,), f32, (None,), "zeros"),
        "blocks": stack_specs(cfg),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, v), cfg.dtype, ("embed", "vocab"),
                                     "scaled")
    return specs


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def embed_tokens(cfg: ModelConfig, params: dict, tokens: torch.Tensor
                 ) -> torch.Tensor:
    x = params["embed"][tokens]
    if cfg.scale_embed:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def unembed(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Hidden states -> (softcapped) f32 logits over the padded vocab."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    z = x.float() @ head.float()
    if cfg.final_softcap is not None:
        z = cfg.final_softcap * torch.tanh(z / cfg.final_softcap)
    if cfg.padded_vocab != cfg.vocab_size:
        col = torch.arange(cfg.padded_vocab, device=z.device)
        z = z.masked_fill(col >= cfg.vocab_size, -1e30)
    return z


def _group(tree: dict, g: int) -> dict:
    """Layer group ``g`` of a stacked leaf dict (views, no copies)."""
    return {k: v[g] for k, v in tree.items()}


def _apply_block(cfg: ModelConfig, desc: BlockDesc, p: dict, x: torch.Tensor,
                 positions: torch.Tensor, enc_out: torch.Tensor | None,
                 causal: bool, attn_op, ssd_op) -> torch.Tensor:
    h = L.rmsnorm(x, p["norm"], cfg.rms_eps)
    if desc.kind == "attn":
        x = x + L.attention(cfg, p, h, desc, positions, causal=causal,
                            attn_op=attn_op)
    else:
        x = x + L.mamba(cfg, p, h, ssd_op=ssd_op)
    if desc.cross_attn:
        if enc_out is None:
            raise ValueError("a cross-attention block needs enc_out")
        h = L.rmsnorm(x, p["x_norm"], cfg.rms_eps)
        x = x + L.attention(cfg, p, h, desc, positions, xkv=enc_out,
                            prefix="x_", attn_op=attn_op)
    if desc.mlp:
        h = L.rmsnorm(x, p["mlp_norm"], cfg.rms_eps)
        x = x + (L.moe(cfg, p, h) if desc.moe else L.mlp(cfg, p, h))
    return x


def forward(cfg: ModelConfig, params: dict, x: torch.Tensor,
            positions: torch.Tensor | None = None,
            enc_out: torch.Tensor | None = None,
            causal: bool | None = None,
            attn_op: L.AttnOp | None = None,
            ssd_op: L.SsdOp | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the block stack on embedded inputs x (B, S, d).

    Returns (hidden_states, moe_aux_loss); the aux loss is 0 (no MoE block
    is ported).  ``attn_op`` replaces ``ops.flash_attention`` in every
    attention layer (see ``layers.attention``), ``ssd_op`` ``ops.ssd_scan``
    in every Mamba-2 layer (see ``layers.mamba``).
    """
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    causal = cfg.causal if causal is None else causal
    for g in range(cfg.n_groups):
        for i, desc in enumerate(cfg.block_pattern):
            p = _group(params["blocks"][f"pos{i}"], g)
            x = _apply_block(cfg, desc, p, x, positions, enc_out, causal,
                             attn_op, ssd_op)
    x = L.rmsnorm(x, params["final_norm"], cfg.rms_eps)
    return x, torch.zeros((), dtype=f32, device=x.device)


# ---------------------------------------------------------------------------
# kernel-launch manifest
# ---------------------------------------------------------------------------

def decode_kernel_requests(cfg: ModelConfig, batch: int, max_seq: int,
                           seqs: tuple[int, ...] | None = None
                           ) -> list:
    """The tuned-kernel launches this model's forward makes at serving
    shapes, as ``core.step_plan.KernelRequest``s: the flash attention of
    each distinct attention block, or the SSD scan of each distinct Mamba-2
    block, at each sequence length in ``seqs`` (default ``(1, max_seq)``).
    Derived from the config alone, with the key and shape arithmetic the
    layers use when they call ``ops.flash_attention`` (heads folded into
    the batch axis) and ``ops.ssd_scan`` (mamba heads folded into it), so
    ``build_step_plan`` over them resolves the configs the step's ops
    would ask the registry for.
    """
    from ..core.step_plan import KernelRequest
    from ..kernels.ops import (FLASH_DEFAULT, SSD_DEFAULT, flash_kernel_name,
                               ssd_kernel_name)

    if seqs is None:
        seqs = (1, max_seq)
    reqs: list = []
    seen = set()
    for desc in cfg.block_pattern:
        key = (desc.kind, bool(desc.cross_attn))
        if key in seen:
            continue
        seen.add(key)
        for s in seqs:
            if desc.kind == "attn":
                reqs.append(KernelRequest.make(
                    flash_kernel_name(cfg.head_dim, cfg.causal),
                    {"bh": batch * cfg.n_heads, "sq": s, "skv": s},
                    FLASH_DEFAULT))
            else:
                reqs.append(KernelRequest.make(
                    ssd_kernel_name(cfg.mamba_head_dim, cfg.ssm_state),
                    {"bh": batch * cfg.mamba_heads, "s": s, "chunkflops": 1},
                    SSD_DEFAULT))
            if desc.cross_attn:
                skv = cfg.encoder_seq if cfg.encoder_seq else s
                reqs.append(KernelRequest.make(
                    flash_kernel_name(cfg.head_dim, False),
                    {"bh": batch * cfg.n_heads, "sq": s, "skv": skv},
                    FLASH_DEFAULT))
    return reqs


# ---------------------------------------------------------------------------
# decode (one token against the per-group caches)
# ---------------------------------------------------------------------------

def init_cache_specs(cfg: ModelConfig, batch: int, max_seq: int,
                     cross_seq: int = 0) -> dict:
    """ParamSpec tree of the decode cache: (layers, B, S, KV, dh) k and v
    per self-attention block, (layers, B, K-1, di+2n) conv and f32
    (layers, B, Hm, n, dh) ssm states per Mamba-2 block, and static
    cross-attention k/v."""
    g = cfg.n_groups
    cache: dict = {}
    for i, desc in enumerate(cfg.block_pattern):
        sub: dict = {}
        if desc.kind == "attn":
            kv = (g, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
            axes = ("layers", "cache_batch", "cache_seq", "cache_heads", None)
            sub["k"] = ParamSpec(kv, cfg.dtype, axes, "zeros")
            sub["v"] = ParamSpec(kv, cfg.dtype, axes, "zeros")
        else:
            sub["conv"] = ParamSpec(
                (g, batch, cfg.conv_kernel - 1, cfg.mamba_conv_dim),
                cfg.dtype, ("layers", "cache_batch", None, "mamba_inner"),
                "zeros")
            sub["ssm"] = ParamSpec(
                (g, batch, cfg.mamba_heads, cfg.ssm_state, cfg.mamba_head_dim),
                f32, ("layers", "cache_batch", "mamba_heads", None, None),
                "zeros")
        if desc.cross_attn:
            xkv = (g, batch, cross_seq, cfg.n_kv_heads, cfg.head_dim)
            axes = ("layers", "cache_batch", None, "cache_heads", None)
            sub["xk"] = ParamSpec(xkv, cfg.dtype, axes, "zeros")
            sub["xv"] = ParamSpec(xkv, cfg.dtype, axes, "zeros")
        cache[f"pos{i}"] = sub
    return cache


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                pos: torch.Tensor, cache: dict
                ) -> tuple[torch.Tensor, dict]:
    """One decode step: token (B,), pos (B,) -> (logits (B, V), cache).

    The cache is updated in place and returned.
    """
    x = embed_tokens(cfg, params, token[:, None])              # (B, 1, d)
    for g in range(cfg.n_groups):
        for i, desc in enumerate(cfg.block_pattern):
            p = _group(params["blocks"][f"pos{i}"], g)
            c = _group(cache[f"pos{i}"], g)
            h = L.rmsnorm(x, p["norm"], cfg.rms_eps)
            if desc.kind == "attn":
                y, _, _ = L.attention_decode(cfg, p, h, desc, pos, c["k"],
                                             c["v"])
            else:
                y, _, _ = L.mamba_decode(cfg, p, h, c["conv"], c["ssm"])
            x = x + y
            if desc.cross_attn:
                h = L.rmsnorm(x, p["x_norm"], cfg.rms_eps)
                y, _, _ = L.attention_decode(cfg, p, h, desc, pos, c["xk"],
                                             c["xv"], cross=True,
                                             prefix="x_")
                x = x + y
            if desc.mlp:
                h = L.rmsnorm(x, p["mlp_norm"], cfg.rms_eps)
                x = x + (L.moe(cfg, p, h) if desc.moe else L.mlp(cfg, p, h))
    x = L.rmsnorm(x, params["final_norm"], cfg.rms_eps)
    return unembed(cfg, params, x[:, 0]), cache
