"""Tuned kernel dispatch -- the runtime integration point of KLARAPTOR.

Each op consults the driver registry *immediately before launch* (paper
Section V-C: one IO call per kernel call, data parameters in, launch
parameters out) and launches the CUDA kernel with the chosen tiles: the
matmul and the grouped matmul snap them to the shape (f32 with ``fit_tile``
at the granularities the port's kernel spec states, bf16 to the largest
compiled tile size that divides it); flash attention and the SSD scan mask
ragged tails in the kernel and take them as chosen.  With no
driver registered an op uses its static default config.

``layernorm`` and ``blocked_colsum`` have no hand-written spec anywhere: on
first dispatch their kernel is introspected (``repro_torch.introspect``
derives the spec, including the granularities ``fit_config`` snaps to), and
launch parameters flow through the same ``choose_or_default`` chain.

Each op takes its config from a step plan first (``plan=``, else the
ambient one of ``core.step_plan.use_step_plan``): a hit makes no registry
traffic, a miss or a stale plan falls through to ``choose_or_default``.  The
key is the D the op resolves at -- for the matmul and the grouped matmul
the shape padded to the kernel's granule (``gemm_dims``) -- so a step plan
or launch plan must be built at that D to hit.  A resolved config may be
shared (a memo or plan entry): the ops never change it.

``matmul``, ``flash_attention``, ``layernorm`` and ``blocked_colsum`` also
take ``in_graph=`` (a ``core.device_plan.BucketedDispatch``) and ``dims=``
(the raw shape): the operands come padded to the bucket envelope
(``core.buckets.pad_to``), the config is the branch the dispatch takes at
the raw shape, fitted to the envelope shape, and the result has the
envelope's shape (the caller slices it: zero padding is exact for the
matmul and the column sum, causally masked for flash attention, and the
layernorm's padded rows land in the tail).  These calls make no registry
traffic.  The JAX package fetches the branch inside its compiled step
(``lax.switch``); PyTorch launches from the host, so the op takes the
branch from ``host_index``, the decision ``branch_index`` makes on the
device, bit for bit.  Captured once per branch over the padded buffers
(``serving.graphs.BranchGraphs``), a raw shape moves the branch index and
never adds a capture.

A CUDA tensor always goes to the kernel (or raises); only a CPU tensor takes
the kernel's plain PyTorch version.

Gradients.  On the CPU the plain versions are PyTorch, so autograd runs
through them.  On the card ``flash_attention``, ``ssd_scan`` and
``moe_gmm`` are ``torch.autograd.Function``s whenever grad is enabled and
an input requires it: the forward is the tuned kernel (flash attention's
then also writes lse, the SSD scan's each chunk's entering state), and the
backward a hand-written kernel (``flash_attention_backward_kernel``,
``ssd_scan_backward_kernel``, ``moe_gmm_backward_kernel``).  The other ops
have no backward kernel yet: on a tensor that is not on the CPU they raise
``MissingBackwardError`` when grad is enabled and an input requires it,
where the kernel's output would otherwise be silently cut from the graph.
"""

from __future__ import annotations

import functools
import re
from typing import Callable, Mapping

import torch
import torch.nn.functional as F

from ..core.driver import choose_or_default, fit_tile
from ..core.step_plan import StepPlan, active_step_plan
from ..core.kernel_spec import (CandidateTable, flash_attention_spec,
                                matmul_spec, moe_gmm_spec, ssd_scan_spec)
from ..introspect import AutoKernel, auto_register, get_auto
from ..trace import span as _span
from ..trace.span import Span
from .flash_attention import (flash_attention_backward_kernel,
                              flash_attention_kernel, flash_attention_plain)
from .layernorm import LAYERNORM, layernorm_grid_spec, layernorm_kernel
from .matmul import matmul_kernel
from .moe_gmm import moe_gmm_backward_kernel, moe_gmm_kernel
from .reduce import COLSUM, colsum_grid_spec, colsum_kernel
from .ssd_scan import (SMEM_LIMIT, backward_smem_bytes,
                       ssd_scan_backward_kernel, ssd_scan_kernel,
                       ssd_scan_plain)

__all__ = ["FLASH_DEFAULT", "GMM_DEFAULT", "GMM_DEFAULT_F32",
           "MATMUL_DEFAULT", "MATMUL_DEFAULT_F32", "MissingBackwardError",
           "SSD_DEFAULT",
           "blocked_colsum", "flash_attention", "flash_kernel_name",
           "gemm_dims", "gmm_kernel_name", "kernel_spec", "layernorm",
           "matmul", "matmul_kernel_name", "moe_gmm", "probe_launcher",
           "ssd_kernel_name", "ssd_scan"]

# Static heuristic defaults (what a programmer would hard-code).  The bf16
# matmul defaults are compiled wgmma tiles, the f32 ones SIMT tiles; the
# flash default fits the kernel at every head dim and dtype it is built
# for; the SSD default is the reference's.
MATMUL_DEFAULT = {"bm": 128, "bn": 128, "bk": 64}
MATMUL_DEFAULT_F32 = {"bm": 128, "bn": 128, "bk": 32}
GMM_DEFAULT = {"bg": 128, "bn": 128, "bk": 64}
GMM_DEFAULT_F32 = {"bg": 128, "bn": 128, "bk": 32}
FLASH_DEFAULT = {"bq": 64, "bkv": 64}
SSD_DEFAULT = {"chunk": 256}

_FLASH_NAME = re.compile(r"^flash_attn_d(\d+)(_causal)?$")
_SSD_NAME = re.compile(r"^ssd_scan_h(\d+)_n(\d+)$")

_MATMUL_KERNELS = {torch.bfloat16: "matmul_b16", torch.float32: "matmul_b32"}
_GMM_KERNELS = {torch.bfloat16: "moe_gmm_b16", torch.float32: "moe_gmm_b32"}
_DEFAULTS = {"matmul_b16": MATMUL_DEFAULT, "matmul_b32": MATMUL_DEFAULT_F32,
             "moe_gmm_b16": GMM_DEFAULT, "moe_gmm_b32": GMM_DEFAULT_F32}


def matmul_kernel_name(dtype: torch.dtype) -> str:
    """The kernel-spec name the matmul of ``dtype`` inputs is tuned under."""
    try:
        return _MATMUL_KERNELS[dtype]
    except KeyError:
        raise ValueError(f"no matmul kernel for {dtype}; inputs must be "
                         f"one of {tuple(_MATMUL_KERNELS)}") from None


def gmm_kernel_name(dtype: torch.dtype) -> str:
    """The kernel-spec name the grouped matmul of ``dtype`` inputs is tuned
    under."""
    try:
        return _GMM_KERNELS[dtype]
    except KeyError:
        raise ValueError(f"no grouped-matmul kernel for {dtype}; inputs must "
                         f"be one of {tuple(_GMM_KERNELS)}") from None


@functools.lru_cache(maxsize=None)
def _gemm_spec(kernel: str):
    make = moe_gmm_spec if kernel.startswith("moe_gmm") else matmul_spec
    return make(dtype_bytes=2 if kernel.endswith("_b16") else 4)


@functools.lru_cache(maxsize=None)
def _alignments(kernel: str) -> dict[str, int]:
    spec = _gemm_spec(kernel)
    return {p: spec.alignment(p) for p in spec.program_params}


def gemm_dims(kernel: str, D: Mapping[str, int]) -> dict[str, int]:
    """The data parameters ``ops.matmul`` / ``ops.moe_gmm`` resolve their
    tiles at: each tiled extent of D rounded up to the granule of its tile
    (64 in bf16, 8 in f32), in D's key order.  Step plans and launch plans
    of these kernels must be built at these D to hit."""
    spec, align = _gemm_spec(kernel), _alignments(kernel)
    tile_of = {a.data: a.block for a in spec.grid if a.block is not None}
    return {d: _round_up(int(v), align[tile_of[d]]) if d in tile_of
            else int(v) for d, v in D.items()}


def _resolve(kernel: str, D: dict, default: dict, plan: StepPlan | None,
             spec=None) -> dict:
    """The launch config of one op call: the explicit ``plan``, else the
    ambient step plan; on a miss or a stale plan, ``choose_or_default``
    (which reads the driver cache through when given the ``spec``).  A
    pinned override outranks a step plan, since pinning it makes every
    step plan stale."""
    if plan is None:
        plan = active_step_plan()
    if plan is not None:
        cfg = plan.resolve(kernel, D)
        if cfg is not None:
            return cfg
    # Only the fall-through is traced, as in the reference; it runs at
    # every launch a step plan misses, so with no tracer it stays one
    # module-global load and an ``is None`` test.
    tracer = _span._active
    if tracer is None:
        return choose_or_default(kernel, D, default, spec=spec)
    with Span(tracer, "dispatch.choose", {"kernel": kernel}):
        return choose_or_default(kernel, D, default, spec=spec)


def _branch_config(disp, kernel: str, dims,
                   envelope: Mapping[str, int]) -> dict[str, int]:
    """The config of the branch ``disp`` takes at the raw ``dims`` (default
    the envelope shape itself), as ``host_index`` decides it."""
    if disp.table.kernel != kernel:
        raise ValueError(f"a dispatch of {disp.table.kernel!r} cannot "
                         f"launch {kernel!r}")
    idx, _ = disp.host_index(envelope if dims is None else dims)
    return disp.config_dicts()[idx]


def _fit_gemm(kernel: str, cfg: Mapping[str, int],
              sizes: Mapping[str, int]) -> dict[str, int]:
    """Tiles of ``cfg`` snapped to the (padded) shape: the bf16 wgmma
    kernel takes only compiled tile sizes, so each becomes the largest
    candidate <= it that divides its extent (smaller than a compiled tile,
    so still compiled); the f32 SIMT kernel takes ``fit_tile``'s."""
    spec, align = _gemm_spec(kernel), _alignments(kernel)
    if spec.compute_unit != "bf16":
        return {p: fit_tile(sizes[p], int(cfg[p]), align[p]) for p in cfg}
    return {p: max(v for v in spec.default_candidates(p)
                   if v <= tile and sizes[p] % v == 0)
            for p, tile in cfg.items()}


def _round_up(v: int, a: int) -> int:
    return -(-v // a) * a


class MissingBackwardError(RuntimeError):
    """An op on the card was asked for a gradient its kernel cannot give."""


def _wants_grad(*tensors: torch.Tensor) -> bool:
    """Whether grad is enabled and an input that is not on the CPU requires
    it: an op then runs its autograd Function (or, with no backward kernel,
    refuses)."""
    return torch.is_grad_enabled() and any(
        t.requires_grad and t.device.type != "cpu" for t in tensors)


def _refuse_grad(op: str, missing: str, *tensors: torch.Tensor) -> None:
    """Raise ``MissingBackwardError`` when grad is enabled and an input that
    is not on the CPU requires it: the hand-written kernel has no backward,
    and its output would carry none."""
    if _wants_grad(*tensors):
        raise MissingBackwardError(
            f"ops.{op} has no backward on the card: {missing} is not "
            f"written yet; run under torch.no_grad() or on CPU tensors")


def matmul(x: torch.Tensor, y: torch.Tensor, *,
           out_dtype: torch.dtype | None = None,
           plan: StepPlan | None = None, in_graph=None,
           dims=None) -> torch.Tensor:
    """Tuned x @ y over the last two dims of x; leading dims are batched.

    ``y`` is one (k, n) matrix shared by every batch entry, so the batch
    folds into m and the product is one launch at (batch * m, n, k).  Dims
    that are not multiples of the spec's granularity (64 for bf16, 8 for
    f32) are zero-padded (exact for a product) and the result is sliced
    back.  CUDA tensors launch the kernel, CPU tensors take
    ``matmul_plain`` through the same wrapper.

    With ``in_graph=`` (a ``BucketedDispatch``) the operands must be 2-D,
    padded to the lattice envelope (a multiple of the granule), and
    ``dims`` carries the raw ``{m, n, k}``; the result is envelope-shaped
    -- the caller slices ``[:m, :n]`` (exact: padded k contributes zero
    partial products, padded rows and columns land in the tail).
    """
    if x.ndim < 2 or y.ndim != 2 or x.shape[-1] != y.shape[0]:
        raise ValueError(f"matmul takes x (..., m, k) and y (k, n); got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    _refuse_grad("matmul", "the matmul kernel's backward", x, y)
    out_dtype = out_dtype or x.dtype
    if in_graph is not None:
        if x.ndim != 2:
            raise ValueError("in-graph matmul takes 2-D envelope-padded "
                             f"operands, got x.ndim={x.ndim}")
        kernel = matmul_kernel_name(x.dtype)
        (M, K), N = x.shape, y.shape[1]
        env = {"m": M, "n": N, "k": K}
        if gemm_dims(kernel, env) != env:
            raise ValueError(f"in-graph matmul takes operands padded to the "
                             f"{kernel} granule; got (m, n, k) {M, N, K}")
        cfg = _branch_config(in_graph, kernel, dims, env)
        return matmul_kernel(x.contiguous(), y.contiguous(),
                             **_fit_gemm(kernel, cfg,
                                         {"bm": M, "bn": N, "bk": K}),
                             out_dtype=out_dtype)
    lead = x.shape[:-1]
    k, n = y.shape
    x2 = x.reshape(-1, k)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"matmul runs on cuda or cpu tensors, not {x.device}")
    kernel = matmul_kernel_name(x.dtype)
    m = x2.shape[0]
    D = gemm_dims(kernel, {"m": m, "n": n, "k": k})
    mp, np_, kp = D["m"], D["n"], D["k"]
    if (mp, kp) != (m, k):
        x2 = F.pad(x2, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        y = F.pad(y, (0, np_ - n, 0, kp - k))
    x2, y2 = x2.contiguous(), y.contiguous()
    cfg = _resolve(kernel, D, _DEFAULTS[kernel], plan, _gemm_spec(kernel))
    out = matmul_kernel(x2, y2, **_fit_gemm(kernel, cfg,
                                            {"bm": mp, "bn": np_, "bk": kp}),
                        out_dtype=out_dtype)
    if (mp, np_) != (m, n):
        out = out[:m, :n]
    return out.reshape(*lead, n)


def moe_gmm(x: torch.Tensor, w: torch.Tensor, *,
            plan: StepPlan | None = None) -> torch.Tensor:
    """Tuned grouped matmul: x (e, g, k) @ w (e, k, n) -> (e, g, n) in x's
    type, f32 accumulation.

    Resolves (bg, bn, bk) through ``choose_or_default("moe_gmm_b16" |
    "moe_gmm_b32", {e, g, k, n}, GMM_DEFAULT | GMM_DEFAULT_F32)``.  g, n
    and k that are not multiples of the spec's granularity (64 for bf16, 8
    for f32) are zero-padded (exact for a product) and the result is sliced
    back; the tiles are then snapped to the padded shape.  CUDA tensors
    launch the kernel, CPU tensors take ``moe_gmm_plain`` through the same
    wrapper.  With grad on a CUDA input the padded product runs as
    ``_MoeGmm`` (the padding and its slice stay autograd's).
    """
    if x.ndim != 3 or w.ndim != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"moe_gmm takes x (e, g, k) and w (e, k, n); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    kernel = gmm_kernel_name(x.dtype)
    e, g, k = x.shape
    n = w.shape[2]
    D = gemm_dims(kernel, {"e": e, "g": g, "k": k, "n": n})
    gp, np_, kp = D["g"], D["n"], D["k"]
    if (gp, kp) != (g, k):
        x = F.pad(x, (0, kp - k, 0, gp - g))
    if (kp, np_) != (k, n):
        w = F.pad(w, (0, np_ - n, 0, kp - k))
    cfg = _resolve(kernel, D, _DEFAULTS[kernel], plan, _gemm_spec(kernel))
    tiles = _fit_gemm(kernel, cfg, {"bg": gp, "bn": np_, "bk": kp})
    if _wants_grad(x, w):
        out = _MoeGmm.apply(x.contiguous(), w.contiguous(), tiles)
    else:
        out = moe_gmm_kernel(x.contiguous(), w.contiguous(), **tiles)
    if (gp, np_) != (g, n):
        out = out[:, :g, :n]
    return out


class _MoeGmm(torch.autograd.Function):
    """The grouped matmul on the card with its gradient: the tuned forward
    kernel, and the backward kernel's two products (dx = dy w^T, dw = x^T
    dy).  bf16 takes the backward body's launch parameters from
    ``moe_gmm.backward_tiles`` (the forward's spec cannot express them: a
    persistent grid, a capacity tile of 192 rows); f32 tiles each product at
    the tile ``_resolve`` gives under the forward's spec at that product's
    own (padded) dims."""

    @staticmethod
    def forward(ctx, x, w, tiles):
        ctx.save_for_backward(x, w)
        return moe_gmm_kernel(x, w, **tiles)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        if x.dtype == torch.bfloat16:
            dx, dw = moe_gmm_backward_kernel(x, w, dy.contiguous())
            return dx, dw, None
        kernel = gmm_kernel_name(x.dtype)
        e, g, k = x.shape
        n = w.shape[2]

        def tiles(G: int, K: int, N: int) -> dict[str, int]:
            D = gemm_dims(kernel, {"e": e, "g": G, "k": K, "n": N})
            cfg = _resolve(kernel, D, _DEFAULTS[kernel], None,
                           _gemm_spec(kernel))
            return _fit_gemm(kernel, cfg, {"bg": G, "bn": N, "bk": K})

        dx, dw = moe_gmm_backward_kernel(x, w, dy.contiguous(),
                                         dx_tiles=tiles(g, n, k),
                                         dw_tiles=tiles(k, g, n))
        return dx, dw, None


def flash_kernel_name(head_dim: int, causal: bool) -> str:
    """The kernel-spec name flash attention is tuned under (as the JAX
    package names it: the dtype is not part of the name)."""
    return f"flash_attn_d{head_dim}" + ("_causal" if causal else "")


@functools.lru_cache(maxsize=None)
def _flash_spec(head_dim: int, causal: bool, dtype_bytes: int):
    return flash_attention_spec(head_dim, causal, dtype_bytes)


@functools.lru_cache(maxsize=None)
def _flash_tile_fits(head_dim: int, causal: bool, dtype_bytes: int,
                     bq: int, bkv: int) -> bool:
    """Whether tiles (bq, bkv) satisfy the flash spec of this dtype (a
    driver tuned in bf16 may pick a tile whose f32 stage is too large)."""
    spec = _flash_spec(head_dim, causal, dtype_bytes)
    one = CandidateTable.from_rows(spec.program_params,
                                   [{"bq": bq, "bkv": bkv}])
    D = {"bh": 1, "sq": 1, "skv": 1}
    return bool(spec.feasible_mask(D, one)[0]) and \
        bq in spec.default_candidates("bq") and \
        bkv in spec.default_candidates("bkv")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    num_q_heads: int, num_kv_heads: int, causal: bool = True,
                    window: int | None = None, softcap: float | None = None,
                    scale: float | None = None,
                    q_chunk: int | None = None,
                    plan: StepPlan | None = None, in_graph=None,
                    dims=None) -> torch.Tensor:
    """(b*hq, sq, d) x (b*hkv, skv, d)^2 -> (b*hq, sq, d), tuned tiles.

    CPU tensors take ``flash_attention_plain`` (streamed over ``q_chunk``
    query rows, as the JAX path does).  CUDA tensors resolve (bq, bkv)
    through ``choose_or_default`` at D = (bh, sq, skv) and launch the
    kernel, which masks ragged tails, so no shape is padded; ``q_chunk``
    does not apply to the kernel, which streams by construction.  With
    grad on and a CUDA input that requires it the call runs as
    ``_FlashAttention``: the forward kernel writing lse, and the backward
    kernel with the same window and softcap.

    With ``in_graph=`` the operands are envelope-padded and ``dims``
    carries the raw ``{bh, sq, skv}``.  Only causal self-attention with
    aligned q/kv padding is safe here: a query row at position i attends
    to kv positions <= i, so the zero rows of the padded kv tail are
    masked out for every valid query row, and padded query rows land in
    the tail the caller slices off.  The branch's tiles are taken as the
    kernel takes ragged tails; a pair this dtype's kernel does not take
    falls to ``FLASH_DEFAULT``, as on the tuned path.
    """
    if in_graph is not None:
        _refuse_grad("flash_attention(in_graph=)",
                     "a backward through a bucket's padded buffers", q, k, v)
        if not causal:
            raise ValueError(
                "in-graph flash attention requires causal=True: non-causal "
                "attention would read the zero-padded kv tail")
        BH, SQ, d = q.shape
        cfg = _branch_config(in_graph, flash_kernel_name(d, causal), dims,
                             {"bh": BH, "sq": SQ, "skv": k.shape[1]})
        if not _flash_tile_fits(d, causal, q.element_size(), cfg["bq"],
                                cfg["bkv"]):
            cfg = FLASH_DEFAULT
        return flash_attention_kernel(
            q, k, v, num_q_heads=num_q_heads, num_kv_heads=num_kv_heads,
            bq=cfg["bq"], bkv=cfg["bkv"], causal=causal, window=window,
            softcap=softcap, scale=scale)
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, num_q_heads=num_q_heads, num_kv_heads=num_kv_heads,
            causal=causal, window=window, softcap=softcap, scale=scale,
            q_chunk=q_chunk)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, "
                         f"not {q.device}")
    bh, sq, d = q.shape
    cfg = _resolve(flash_kernel_name(d, causal),
                   {"bh": bh, "sq": sq, "skv": k.shape[1]}, FLASH_DEFAULT,
                   plan, _flash_spec(d, causal, q.element_size()))
    if not _flash_tile_fits(d, causal, q.element_size(), cfg["bq"],
                            cfg["bkv"]):
        cfg = FLASH_DEFAULT
    kw = dict(num_q_heads=num_q_heads, num_kv_heads=num_kv_heads,
              causal=causal, window=window, softcap=softcap, scale=scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, cfg["bq"], cfg["bkv"], kw)
    return flash_attention_kernel(q, k, v, bq=cfg["bq"], bkv=cfg["bkv"],
                                  **kw)


class _FlashAttention(torch.autograd.Function):
    """Flash attention on the card with its gradient: the tuned forward
    kernel writing lse, and the backward kernel from (q, k, v, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, bq, bkv, kw):
        out, lse = flash_attention_kernel(q, k, v, bq=bq, bkv=bkv,
                                          return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward_kernel(
            q, k, v, out, dout.contiguous(), lse, **ctx.kw)
        return dq, dk, dv, None, None, None


def kernel_spec(kernel: str, dtype: torch.dtype = torch.bfloat16):
    """The spec the ops resolve ``kernel`` under for inputs of ``dtype``
    (what a driver-cache read for it must name): the GEMMs' by name, flash
    attention's and the SSD scan's at the dtype's width (their names carry
    no dtype), an auto-registered kernel's derived spec."""
    if kernel in _DEFAULTS:
        return _gemm_spec(kernel)
    width = torch.empty((), dtype=dtype).element_size()
    flash = _FLASH_NAME.match(kernel)
    if flash:
        return _flash_spec(int(flash.group(1)), bool(flash.group(2)), width)
    ssd = _SSD_NAME.match(kernel)
    if ssd:
        return _ssd_spec(int(ssd.group(1)), int(ssd.group(2)), width)
    ak = get_auto(kernel)
    if ak is None:
        raise ValueError(f"no spec for kernel {kernel!r}")
    return ak.spec


def ssd_kernel_name(head_dim: int, d_state: int) -> str:
    """The kernel-spec name the SSD scan is tuned under (the reference's:
    the dtype is not part of the name)."""
    return f"ssd_scan_h{head_dim}_n{d_state}"


@functools.lru_cache(maxsize=None)
def _ssd_spec(head_dim: int, d_state: int, dtype_bytes: int):
    return ssd_scan_spec(head_dim, d_state, dtype_bytes)


@functools.lru_cache(maxsize=None)
def _ssd_chunk(head_dim: int, d_state: int, dtype_bytes: int,
               chunk: int) -> int:
    """``chunk`` if the SSD spec of this dtype takes it, else the largest
    smaller candidate it takes (a driver tuned in bf16, or the default, may
    name a chunk whose f32 stage is too large)."""
    spec = _ssd_spec(head_dim, d_state, dtype_bytes)
    D = {"bh": 1, "s": 1, "chunkflops": 1}
    fits = spec.candidates(D)["chunk"]
    below = fits[fits <= chunk]
    if chunk in fits:
        return int(chunk)
    return int(below.max() if below.size else fits.min())


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, A: torch.Tensor, *,
             plan: StepPlan | None = None) -> torch.Tensor:
    """Mamba-2 SSD scan with the tuned chunk length: x (bh, s, dh), dt
    (bh, s), B, C (bh / h, s, n) each shared by h consecutive rows of x (h
    = 1: one copy per row), A (bh,) -> y (bh, s, dh) in x's dtype.

    The chunk is resolved through ``choose_or_default`` at D = (bh, s,
    chunkflops 1), the reference's key, and taken as chosen (the kernel
    masks a ragged last chunk); a chunk this dtype's shared memory cannot
    hold falls to the largest smaller one that fits.  CUDA tensors launch
    the kernel; CPU tensors take ``ssd_scan_plain`` at the same chunk.
    With grad on a CUDA input it runs as ``_SsdScan``, at the largest chunk
    up to that one whose backward fits in shared memory too.
    """
    bh, s, dh = x.shape
    n = B.shape[-1]
    cfg = _resolve(ssd_kernel_name(dh, n),
                   {"bh": bh, "s": s, "chunkflops": 1}, SSD_DEFAULT, plan,
                   _ssd_spec(dh, n, x.element_size()))
    chunk = _ssd_chunk(dh, n, x.element_size(), int(cfg["chunk"]))
    dt, A = dt.float().contiguous(), A.float().contiguous()
    tensors = (x, dt, B, C, A)
    if _wants_grad(*tensors):
        return _SsdScan.apply(x.contiguous(), dt, B.contiguous(),
                              C.contiguous(), A,
                              _ssd_train_chunk(dh, n, x.element_size(),
                                               chunk))
    if all(t.device.type == "cpu" for t in tensors):
        return ssd_scan_plain(x, dt, B, C, A, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu tensors, not "
                         f"{x.device}")
    return ssd_scan_kernel(x.contiguous(), dt, B.contiguous(),
                           C.contiguous(), A, chunk=chunk)


@functools.lru_cache(maxsize=None)
def _ssd_train_chunk(head_dim: int, d_state: int, dtype_bytes: int,
                     chunk: int) -> int:
    """``chunk`` if the backward's shared memory holds it too, else the
    largest smaller chunk the spec takes that it holds (the backward runs
    at the forward's chunk, whose entering states it reads)."""
    spec = _ssd_spec(head_dim, d_state, dtype_bytes)
    fits = spec.candidates({"bh": 1, "s": 1, "chunkflops": 1})["chunk"]
    ok = [int(c) for c in fits if c <= chunk and backward_smem_bytes(
        int(c), d_state, dtype_bytes, head_dim) <= SMEM_LIMIT]
    if not ok:
        raise ValueError(f"no chunk up to {chunk} fits the SSD backward at "
                         f"(dh {head_dim}, n {d_state}, {dtype_bytes}-byte "
                         f"inputs)")
    return max(ok)


class _SsdScan(torch.autograd.Function):
    """The SSD scan on the card with its gradient: the forward kernel
    writing each chunk's entering state, and the backward kernel from the
    states and dy at the same chunk."""

    @staticmethod
    def forward(ctx, x, dt, B, C, A, chunk):
        y, states = ssd_scan_kernel(x, dt, B, C, A, chunk=chunk,
                                    return_states=True)
        ctx.save_for_backward(x, dt, B, C, A, states)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, B, C, A, states = ctx.saved_tensors
        grads = ssd_scan_backward_kernel(x, dt, B, C, A, states,
                                         dy.contiguous(), chunk=ctx.chunk)
        return (*grads, None)


@functools.lru_cache(maxsize=None)
def _layernorm_auto(c: int, dtype_bytes: int, eps: float,
                    device: str) -> AutoKernel:
    return auto_register(LAYERNORM, layernorm_grid_spec(c, dtype_bytes, eps),
                         device=device)


@functools.lru_cache(maxsize=None)
def _colsum_auto(dtype_bytes: int, device: str) -> AutoKernel:
    return auto_register(COLSUM, colsum_grid_spec(dtype_bytes),
                         device=device)


def layernorm(x: torch.Tensor, res: torch.Tensor, gamma: torch.Tensor,
              beta: torch.Tensor, *, eps: float = 1e-6,
              plan: StepPlan | None = None, in_graph=None,
              dims=None) -> torch.Tensor:
    """Fused layernorm + residual of x, res (r, c) with an
    introspection-tuned row tile.

    The kernel is auto-registered for (c, dtype, eps) on first use; ``br``
    is resolved through ``choose_or_default(layernorm_c{c}_b{16|32}, {r},
    defaults)`` and fitted to r by ``fit_config``: the derived row axis is
    ragged (the kernel masks the last block), so br is kept, at most r
    rounded up to the derived granularity.  CUDA tensors launch the kernel,
    CPU tensors take ``layernorm_plain`` through the same wrapper.

    With ``in_graph=`` the inputs are row-padded to the envelope and
    ``dims`` carries the raw ``{r}``: padded rows normalize a zero row
    (finite: eps keeps the rsqrt bounded) and land in the tail, so the
    valid rows are unaffected.
    """
    if x.ndim != 2:
        raise ValueError(f"layernorm takes x (r, c); got {tuple(x.shape)}")
    _refuse_grad("layernorm", "the layernorm kernel's backward", x, res,
                 gamma, beta)
    r, c = x.shape
    ak = _layernorm_auto(c, x.element_size(), float(eps), x.device.type)
    if in_graph is not None:
        cfg = ak.fit_config(_branch_config(in_graph, ak.name, dims,
                                           {"r": r}), {"r": r})
    else:
        cfg = ak.fit_config(_resolve(ak.name, {"r": r}, ak.defaults, plan,
                                     ak.spec), {"r": r})
    return layernorm_kernel(x.contiguous(), res.contiguous(), gamma, beta,
                            br=cfg["br"], eps=eps)


def blocked_colsum(x: torch.Tensor, *,
                   plan: StepPlan | None = None, in_graph=None,
                   dims=None) -> torch.Tensor:
    """Column sums of x (r, c) as (c,) f32 with introspection-tuned (br, bc)
    tiles.

    The kernel is auto-registered for x's dtype on first use; a c that is
    not a multiple of the derived ``bc`` granularity is zero-padded (zero
    columns land in the sliced-off tail), and the resolved config is
    snapped to the shape by ``fit_config``.  CUDA tensors launch the
    kernel, CPU tensors take ``colsum_plain`` through the same wrapper.

    With ``in_graph=`` the input is envelope-padded (c a multiple of the
    ``bc`` granularity) and ``dims`` carries the raw ``{r, c}``; padded
    rows add zero to every column sum and padded columns land in the
    tail, so the result is exact.
    """
    if x.ndim != 2:
        raise ValueError(f"blocked_colsum takes x (r, c); got "
                         f"{tuple(x.shape)}")
    _refuse_grad("blocked_colsum", "the column sum's backward", x)
    r, c = x.shape
    ak = _colsum_auto(x.element_size(), x.device.type)
    if in_graph is not None:
        if c % ak.alignments()["bc"]:
            raise ValueError(f"in-graph column sum takes c padded to a "
                             f"multiple of {ak.alignments()['bc']}; got {c}")
        env = {"r": r, "c": c}
        cfg = ak.fit_config(_branch_config(in_graph, ak.name, dims, env),
                            env)
        return colsum_kernel(x.contiguous(), br=cfg["br"], bc=cfg["bc"])
    cp = _round_up(c, ak.alignments()["bc"])
    if cp != c:
        x = F.pad(x, (0, cp - c))
    D = {"r": r, "c": cp}
    cfg = ak.fit_config(_resolve(ak.name, D, ak.defaults, plan, ak.spec), D)
    out = colsum_kernel(x.contiguous(), br=cfg["br"], bc=cfg["bc"])
    return out[:c] if cp != c else out


def probe_launcher(kernel: str, D: Mapping[str, int], device: torch.device,
                   seed: int) -> Callable[[Mapping[str, int]], torch.Tensor]:
    """Bind seeded inputs of kernel ``kernel`` at data size D on ``device``
    and return ``launch(P)``, which runs the kernel once at tiles P and
    returns its output -- what ``CudaEventTimer`` times.

    Flash attention is probed in bf16 (the models' dtype) with one kv head
    per q head (D carries no head counts) and the spec's causality; the SSD
    scan in bf16 with dt in [0.01, 0.51] and A in [-1.5, -0.5], the JAX
    kernel tests' ranges, and one B and C shared by all bh rows (one group,
    as mamba2-130m's heads at batch 1).  An auto-registered kernel
    (``get_auto``) is probed on standard-normal inputs of its GridSpec's
    ``make_args(D)`` with its static keyword arguments.
    """
    gen = torch.Generator(device=device).manual_seed(int(seed))
    ak = get_auto(kernel)
    if ak is not None:
        tensors = [torch.randn(tuple(shape), generator=gen, device=device
                               ).to(dt)
                   for shape, dt in ak.grid_spec.make_args(D)]
        static = dict(ak.grid_spec.call_kwargs)

        def launch_auto(P: Mapping[str, int]) -> torch.Tensor:
            return ak.kernel.launch(
                *tensors, **static,
                **{p: int(P[p]) for p in ak.spec.program_params})

        return launch_auto
    ssd = _SSD_NAME.match(kernel)
    if ssd:
        dh, n = int(ssd.group(1)), int(ssd.group(2))
        bh, s = D["bh"], D["s"]

        def rand(*shape):
            return torch.rand(*shape, generator=gen, device=device)

        def randn(*shape):
            return torch.randn(*shape, generator=gen, device=device)

        x = (randn(bh, s, dh) * 0.5).to(torch.bfloat16)
        dt = 0.01 + 0.5 * rand(bh, s)
        Bm = (randn(1, s, n) * 0.3).to(torch.bfloat16)
        Cm = (randn(1, s, n) * 0.3).to(torch.bfloat16)
        A = -0.5 - rand(bh)

        def launch_ssd(P: Mapping[str, int]) -> torch.Tensor:
            return ssd_scan_kernel(x, dt, Bm, Cm, A, chunk=int(P["chunk"]))

        return launch_ssd
    flash = _FLASH_NAME.match(kernel)
    if flash:
        d, causal = int(flash.group(1)), bool(flash.group(2))
        bh, sq, skv = D["bh"], D["sq"], D["skv"]
        q = torch.randn(bh, sq, d, generator=gen, device=device
                        ).to(torch.bfloat16)
        k = torch.randn(bh, skv, d, generator=gen, device=device
                        ).to(torch.bfloat16)
        v = torch.randn(bh, skv, d, generator=gen, device=device
                        ).to(torch.bfloat16)

        def launch_flash(P: Mapping[str, int]) -> torch.Tensor:
            return flash_attention_kernel(
                q, k, v, num_q_heads=bh, num_kv_heads=bh, bq=int(P["bq"]),
                bkv=int(P["bkv"]), causal=causal)

        return launch_flash
    if kernel in _GMM_KERNELS.values():
        dtype = torch.bfloat16 if kernel == "moe_gmm_b16" else torch.float32
        e, g, k, n = D["e"], D["g"], D["k"], D["n"]
        xg = torch.randn(e, g, k, generator=gen, device=device).to(dtype)
        wg = torch.randn(e, k, n, generator=gen, device=device).to(dtype)

        def launch_gmm(P: Mapping[str, int]) -> torch.Tensor:
            return moe_gmm_kernel(xg, wg, bg=int(P["bg"]), bn=int(P["bn"]),
                                  bk=int(P["bk"]))

        return launch_gmm
    if kernel not in _MATMUL_KERNELS.values():
        raise ValueError(f"no probe launcher for kernel {kernel!r}")
    dtype = torch.bfloat16 if kernel == "matmul_b16" else torch.float32
    x = torch.randn(D["m"], D["k"], generator=gen, device=device).to(dtype)
    y = torch.randn(D["k"], D["n"], generator=gen, device=device).to(dtype)

    def launch(P: Mapping[str, int]) -> torch.Tensor:
        return matmul_kernel(x, y, bm=int(P["bm"]), bn=int(P["bn"]),
                             bk=int(P["bk"]))

    return launch
