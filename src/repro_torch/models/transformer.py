"""Decoder stack over block patterns: specs, forward, decode step, cache.

The JAX package's ``models/transformer.py``: the attention stacks, dense or
MoE, the attention-free Mamba-2 stack, their hybrids (jamba's period of 8),
and decoder blocks with cross-attention onto an encoder's output (whisper;
the encoder is the same stack, run non-causal).  Parameters for one pattern
period are stacked along a leading "layers" axis (the same tree as JAX's,
so weights convert one to one); where JAX ``lax.scan``s over the groups,
the port loops over them in Python and runs each layer on views of the
stacked leaves.  The decode cache carries the same leading axis and is
updated in place; its cross-attention k / v stay as initialised (zeros), as
in the JAX package, where nothing fills them either.

``tp`` (a ``distributed.tensor_parallel.TensorParallel``) runs the train
step's forward on a rank's blocks: the vocab-parallel embedding, the
residual in the ``act_seq`` layout between blocks, each block's FSDP
gathers and sequence-parallel collectives inside the block (so remat
"full" recomputes them in the same order on every rank), and the head's
vocab shard.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..tree import tree_leaves
from . import layers as L
from .config import BlockDesc, ModelConfig
from .module import ParamSpec, spec_tree_map

__all__ = [
    "decode_kernel_requests", "decode_step", "embed_tokens",
    "forward", "init_cache_specs", "lm_head", "mask_logits", "model_specs",
    "stack_specs", "unembed",
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

def embed_tokens(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                 tp=None) -> torch.Tensor:
    """Token embeddings (B, S, d).  With ``tp``, a vocab-parallel lookup in
    this rank's rows of the table (its "embed" columns gathered first),
    out-of-shard ids giving zeros, summed over "model" into the residual's
    layout (``scatter_seq``)."""
    table = params["embed"]
    if tp is not None:
        table = tp.gather(table, tp.specs["embed"])
        lo, n = tp.vocab(cfg)
        ids = tokens.long() - lo
        inside = (ids >= 0) & (ids < n)
        tokens = torch.where(inside, ids, 0)
    # F.embedding, not indexing: its backward accumulates each row in index
    # order on the CPU and the card alike (deterministic, so a resumed
    # training run repeats the uninterrupted one bit for bit)
    x = F.embedding(tokens, table)
    if cfg.scale_embed:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    if tp is not None:
        x = tp.scatter_seq(torch.where(inside[..., None], x, 0))
        tp.check_residual(x)
    return x


def lm_head(cfg: ModelConfig, params: dict, tp=None
            ) -> tuple[torch.Tensor, int]:
    """(the head (d, V) -- the tied embedding's transpose or ``lm_head``
    -- and the global column of its first column).  With ``tp``, this
    rank's vocab shard, its "embed" rows gathered."""
    name = "embed" if cfg.tie_embeddings else "lm_head"
    head, col0 = params[name], 0
    if tp is not None:
        head, col0 = tp.gather(head, tp.specs[name]), tp.vocab(cfg)[0]
    return (head.T if cfg.tie_embeddings else head), col0


def mask_logits(cfg: ModelConfig, z: torch.Tensor, col0: int = 0
                ) -> torch.Tensor:
    """The softcap, then -1e30 in the padded vocab's columns (``z``'s
    last dim holds the global columns from ``col0``)."""
    if cfg.final_softcap is not None:
        z = cfg.final_softcap * torch.tanh(z / cfg.final_softcap)
    if cfg.padded_vocab != cfg.vocab_size:
        col = col0 + torch.arange(z.shape[-1], device=z.device)
        z = z.masked_fill(col >= cfg.vocab_size, -1e30)
    return z


def unembed(cfg: ModelConfig, params: dict, x: torch.Tensor, tp=None
            ) -> torch.Tensor:
    """Hidden states -> (softcapped) f32 logits over the padded vocab
    (with ``tp``, over this rank's vocab shard)."""
    head, col0 = lm_head(cfg, params, tp)
    return mask_logits(cfg, x.float() @ head.float(), col0)


def _group(tree: dict, g: int) -> dict:
    """Layer group ``g`` of a stacked leaf dict (views, no copies)."""
    return {k: v[g] for k, v in tree.items()}


def _apply_block(cfg: ModelConfig, desc: BlockDesc, key: str, blocks: dict,
                 g: int, x: torch.Tensor, positions: torch.Tensor,
                 enc_out: torch.Tensor | None, causal: bool, attn_op, ssd_op,
                 gmm_op, tp=None
                 ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Block ``key`` of layer group ``g``; returns (x, its MoE aux loss,
    None without a MoE MLP).  The group's views of the stacked leaves and,
    with ``tp``, their FSDP gathers are taken here, inside the recomputed
    block."""
    p = _group(blocks, g)
    if tp is not None:
        p = tp.block(p, key)
    aux = None
    h = L.rmsnorm(x, p["norm"], cfg.rms_eps)
    if desc.kind == "attn":
        x = x + L.attention(cfg, p, h, desc, positions, causal=causal,
                            attn_op=attn_op, tp=tp)
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
        if desc.moe:
            y, aux = L.moe(cfg, p, h, gmm_op=gmm_op)
        else:
            y = L.mlp(cfg, p, h, tp=tp)
        x = x + y
    return x, aux


def forward(cfg: ModelConfig, params: dict, x: torch.Tensor,
            positions: torch.Tensor | None = None,
            enc_out: torch.Tensor | None = None,
            causal: bool | None = None,
            attn_op: L.AttnOp | None = None,
            ssd_op: L.SsdOp | None = None,
            gmm_op: L.GmmOp | None = None, tp=None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the block stack on embedded inputs x (B, S, d) (with ``tp``,
    the residual's layout: (B, S / model, d) under sequence parallelism).

    Returns (hidden_states, moe_aux_loss): the f32 sum of every MoE block's
    aux loss (0 without MoE blocks).  When a gradient flows to the block
    parameters (grad enabled and one of them requires it), ``cfg.remat ==
    "full"`` recomputes each block in the backward
    (``torch.utils.checkpoint``, the reference's per-block
    ``jax.checkpoint``), so the backward holds one block's intermediates at
    a time; ``"none"`` keeps them all; ``"dots"`` (save the matrix
    products) is not ported and raises.  ``attn_op`` replaces
    ``ops.flash_attention`` in every attention layer (see
    ``layers.attention``), ``ssd_op`` ``ops.ssd_scan`` in every Mamba-2
    layer (see ``layers.mamba``) and ``gmm_op`` ``ops.moe_gmm`` in every
    MoE layer (see ``layers.moe``).
    """
    B, S, _ = x.shape
    if tp is not None:
        S = tp.seq
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    causal = cfg.causal if causal is None else causal
    remat = cfg.remat != "none" and torch.is_grad_enabled() and any(
        t.requires_grad for t in tree_leaves(params["blocks"]))
    if remat and cfg.remat != "full":
        raise NotImplementedError(f"remat={cfg.remat!r} is not ported; the "
                                  f"port recomputes whole blocks ('full') "
                                  f"or nothing ('none')")
    aux = torch.zeros((), dtype=f32, device=x.device)
    for g in range(cfg.n_groups):
        for i, desc in enumerate(cfg.block_pattern):
            key = f"pos{i}"
            args = (cfg, desc, key, params["blocks"][key], g, x, positions,
                    enc_out, causal, attn_op, ssd_op, gmm_op, tp)
            if remat:
                x, a = checkpoint(_apply_block, *args, use_reentrant=False)
            else:
                x, a = _apply_block(*args)
            if a is not None:
                aux = aux + a
        if tp is not None:
            tp.check_residual(x)
    x = L.rmsnorm(x, params["final_norm"], cfg.rms_eps)
    return x, aux


# ---------------------------------------------------------------------------
# kernel-launch manifest
# ---------------------------------------------------------------------------

def decode_kernel_requests(cfg: ModelConfig, batch: int, max_seq: int,
                           seqs: tuple[int, ...] | None = None
                           ) -> list:
    """The tuned-kernel launches this model's forward makes at serving
    shapes, as ``core.step_plan.KernelRequest``s: the flash attention of
    each distinct attention block, or the SSD scan of each distinct Mamba-2
    block, at each sequence length in ``seqs`` (default ``(1, max_seq)``),
    then, for a model with MoE blocks, the grouped matmul of the expert
    FFN at each of them: one key for the gate and up products (they share
    their shape) and one for the down product, at the rows per expert of
    ``batch * s`` tokens, each distinct key once.  Derived from the config alone, with the key and
    shape arithmetic the layers use when they call ``ops.flash_attention``
    (heads folded into the batch axis), ``ops.ssd_scan`` (mamba heads
    folded into it) and ``ops.moe_gmm`` (``layers.moe_groups``' rows, at
    the granule-padded ``ops.gemm_dims``), so ``build_step_plan`` over them
    resolves the configs the step's ops would ask the registry for.  The
    JAX manifest has no grouped-matmul entries: its MoE layer computes the
    expert products with ``einsum``.
    """
    from ..core.step_plan import KernelRequest
    from ..kernels.ops import (FLASH_DEFAULT, GMM_DEFAULT, GMM_DEFAULT_F32,
                               SSD_DEFAULT, flash_kernel_name, gemm_dims,
                               gmm_kernel_name, ssd_kernel_name)

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
    if any(d.mlp and d.moe for d in cfg.block_pattern):
        kernel = gmm_kernel_name(cfg.dtype)
        default = GMM_DEFAULT if cfg.dtype == torch.bfloat16 \
            else GMM_DEFAULT_F32
        d, f, E = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.n_experts
        shapes = []
        for s in seqs:
            G, _, C = L.moe_groups(cfg, batch * s)
            for k, n in ((d, f), (f, d)):
                D = gemm_dims(kernel, {"e": E, "g": G * C, "k": k, "n": n})
                if D not in shapes:
                    shapes.append(D)
        reqs += [KernelRequest.make(kernel, D, default) for D in shapes]
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
                pos: torch.Tensor, cache: dict, logits: bool = True
                ) -> tuple[torch.Tensor | None, dict]:
    """One decode step: token (B,), pos (B,) -> (logits (B, V), cache).

    The cache is updated in place and returned.  ``logits=False`` stops
    after the block stack and returns (None, cache): a step that only
    advances the cache (a chunk of prefill) skips the final norm and the
    unembedding, as XLA drops them from the JAX engine's prefill scan,
    whose body discards the logits.
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
                x = x + (L.moe(cfg, p, h)[0] if desc.moe
                         else L.mlp(cfg, p, h))
    if not logits:
        return None, cache
    x = L.rmsnorm(x, params["final_norm"], cfg.rms_eps)
    return unembed(cfg, params, x[:, 0]), cache
