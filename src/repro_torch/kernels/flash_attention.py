"""Flash attention: the hand-written CUDA kernel's wrapper and its plain version.

``flash_attention_kernel`` launches ``csrc/flash_attention.cu`` (the Hopper
port of the JAX package's ``flash_attention_pallas``) with launch parameters
(bq, bkv): a grid of ceil(sq / bq) x (b * hq) CTAs, each looping over kv
blocks of bkv rows.  q is (b * hq, sq, d), k and v are (b * hkv, skv, d),
bf16 or f32; q head ``bh`` reads kv head
``(bh // hq) * hkv + (bh % hq) // (hq // hkv)``.  The softmax, its running
max and sum, and the output accumulator are f32; the output has q's dtype.
bf16 (head dims 64, 128 and 256) runs the wgmma + TMA-ring body: 2 * bq
threads (one warpgroup per 64 query rows) and only the compiled tiles
``FLASH_SM90_TILES[d]``; its PV product takes P as two bf16 terms (hi +
lo), as exact as an f32 P to about 2^-17.  f32 runs the SIMT body: 4 * bq
threads, any bq that is a multiple of 16 within the limits and bkv in
``BKV_TILES``.

``flash_attention_plain`` computes the same function in plain PyTorch, as
the JAX package's ``flash_attention_ref`` does: the full score tensor per
query chunk, the same masks, and 0 for a query row that sees no key.  It
keeps the probabilities in f32 for the PV product, as both kernel bodies
and the Pallas kernel do (the JAX oracle casts them to v's dtype first,
which is the same in f32 and within the bf16 tolerance in bf16).  The tests
use it, and the wrapper takes it only for tensors on the CPU; a CUDA tensor
launches the kernel or raises.  ``LAUNCHES.count`` counts kernel launches
and nothing else, ``LAUNCHES.windowed.count`` those made with a window;
``LAUNCHES.tiles[(bh, sq, skv, d, causal)]`` holds the (bq, bkv) of the
last launch at that shape.  With ``return_lse=True`` both
also return lse, f32 (b * hq, sq): the natural-log log-sum-exp of each row's
scaled, masked scores, -inf for a row that sees no key.

``flash_attention_backward_kernel`` launches ``csrc/flash_attention_bwd.cu``
(FlashAttention-2's backward, no atomics, so deterministic): from q, k, v,
the forward's output and lse and the output's gradient it gives dq, dk and
dv (GQA: dk and dv summed over each kv head's group), causal or not, with
the forward's window and softcap, accumulated in f32.  bf16 runs the wgmma +
TMA-ring body (``backward_body``) at head dims 64, 128 and 256: a prep
kernel (delta = rowsum(dO * O) and lse in the log2 domain, rows padded to
``BACKWARD_ROW_PAD``), dK / dV per (kv head, 64 kv rows; two warpgroups
splitting D at 256) and dQ per (q head, 64 q rows), every product on wgmma,
P and dS in registers and rounded once to bf16 for the products that take
them.  f32 runs the SIMT body (FP32 FMAs; wgmma takes f32 only as TF32) at
head dims 64 and 128; its tiles do not fit shared memory at 256, where it
is refused.  ``flash_attention_backward_plain`` is its plain version: P
recomputed from lse (from the capped score with a softcap), delta =
rowsum(dO * O) from the stored output, the same five products in f32.
``BACKWARD_LAUNCHES.count`` counts calls of the backward kernel (one call
launches its three kernels), ``BACKWARD_LAUNCHES.windowed.count`` those
made with a window; ``BACKWARD_LAUNCHES.tiles[(bh, sq, skv, d, causal)]``
holds the body ("wgmma" or "simt") of the last call at that shape and
whether it was capped (``capped``: a softcap was given; the wgmma body then
runs its kernels compiled for the cap).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.kernel_spec import (FLASH_HEAD_DIMS, FLASH_PAD,
                                FLASH_SM90_TILES, FLASH_THREADS_PER_ROW,
                                flash_regs_per_thread, flash_sm90_smem_bytes,
                                flash_uses_sm90)
from ._build import load
from .matmul import LaunchCounter

__all__ = ["AttentionLaunchCounter", "BACKWARD_HEAD_DIMS",
           "BACKWARD_LAUNCHES", "BKV_TILES", "DTYPES", "LAUNCHES", "SIMT_BACKWARD_HEAD_DIMS", "backward_attributes",
           "backward_body", "flash_attention_backward_kernel", "flash_attention_backward_plain",
           "flash_attention_kernel", "flash_attention_plain",
           "kernel_attributes", "smem_bytes", "tile_attributes"]

DTYPES = (torch.float32, torch.bfloat16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
BKV_TILES = (32, 64, 128)       # the SIMT body's template instantiations
BQ_GRANULE = 16                 # 4 rows per thread x 4 threads per row
SMEM_LIMIT = 232448             # dynamic shared memory a block may opt in to
REGS_PER_SM = 65536
MAX_GRID_Y = 65535
_NEG_INF = -1e30
BACKWARD_HEAD_DIMS = (64, 128, 256)     # the wgmma body's instantiations
SIMT_BACKWARD_HEAD_DIMS = (64, 128)     # the f32 SIMT body's
# Its three kernels: delta (for bf16 the prep kernel, which also writes lse
# in the log2 domain), dK / dV, dQ.  The wgmma body compiles dK / dV and dQ
# twice, with and without the cap (``backward_attributes(capped=)``); the
# SIMT body takes the cap at run time.
BACKWARD_KERNELS = ("delta", "dkdv", "dq")
BACKWARD_ROW_PAD = 64   # bf16: lse and delta rows padded to the 64-row block


def backward_body(dtype: torch.dtype, head_dim: int) -> str:
    """The backward body that runs for (dtype, head_dim): "wgmma" for bf16
    (head dims ``BACKWARD_HEAD_DIMS``), "simt" for f32 (head dims
    ``SIMT_BACKWARD_HEAD_DIMS``)."""
    dims = SIMT_BACKWARD_HEAD_DIMS if dtype == torch.float32 \
        else BACKWARD_HEAD_DIMS
    if dtype not in DTYPES or head_dim not in dims:
        raise ValueError(f"the backward kernel takes bf16 at head dims "
                         f"{BACKWARD_HEAD_DIMS} and f32 at head dims "
                         f"{SIMT_BACKWARD_HEAD_DIMS}, not {dtype} at "
                         f"{head_dim}")
    return "wgmma" if dtype == torch.bfloat16 else "simt"



class AttentionLaunchCounter(LaunchCounter):
    """A ``LaunchCounter`` that also counts the launches made with a window
    in ``windowed`` (a ``LaunchCounter`` of its own, reset with it)."""

    def __init__(self) -> None:
        super().__init__()
        self.windowed = LaunchCounter()

    def reset(self) -> None:
        super().reset()
        self.windowed.reset()

    def launched(self, shape: tuple, *, windowed: bool = False,
                 **tiles: int | str) -> None:
        """Count one launch, made at ``shape`` with ``tiles``, and with
        ``windowed`` one made with a window."""
        super().launched(shape, **tiles)
        if windowed:
            self.windowed.launched(shape, **tiles)


LAUNCHES = AttentionLaunchCounter()
BACKWARD_LAUNCHES = AttentionLaunchCounter()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load("flash_attention")
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.klaraptor_flash_attention.argtypes = [
        vp, vp, vp, vp, vp, i, i, i, i, i, i, i, i, f, i, i, i, f, i, vp]
    lib.klaraptor_flash_attention.restype = i
    ip = ctypes.POINTER(ctypes.c_int)
    lib.klaraptor_flash_attention_attributes.argtypes = [i, i, i, ip, ip, ip]
    lib.klaraptor_flash_attention_attributes.restype = i
    lib.klaraptor_flash_attention_tile_attributes.argtypes = [i, i, i, ip, ip,
                                                              ip]
    lib.klaraptor_flash_attention_tile_attributes.restype = i
    lib.klaraptor_flash_error_string.argtypes = [i]
    lib.klaraptor_flash_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = load("flash_attention_bwd")
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.klaraptor_flash_attention_bwd.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, i, f, i, i, i, f,
        i, vp]
    lib.klaraptor_flash_attention_bwd.restype = i
    ip = ctypes.POINTER(ctypes.c_int)
    lib.klaraptor_flash_attention_bwd_attributes.argtypes = [i, i, i, ip, ip,
                                                             ip]
    lib.klaraptor_flash_attention_bwd_attributes.restype = i
    lib.klaraptor_flash_error_string.argtypes = [i]
    lib.klaraptor_flash_error_string.restype = ctypes.c_char_p
    return lib


def _raise_cuda(what: str, rc: int, lib: ctypes.CDLL | None = None) -> None:
    msg = (lib or _lib()).klaraptor_flash_error_string(rc).decode()
    raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


def _attributes(fn, *args) -> dict[str, int]:
    vals = [ctypes.c_int() for _ in range(3)]
    rc = fn(*args, *[ctypes.byref(v) for v in vals])
    if rc:
        _raise_cuda("cudaFuncGetAttributes", rc)
    return dict(zip(("num_regs", "max_threads", "local_bytes"),
                    (v.value for v in vals)))


def kernel_attributes(dtype: torch.dtype, head_dim: int,
                      bkv: int) -> dict[str, int]:
    """Registers per thread, thread limit and spilled local bytes of the
    SIMT kernel compiled for (dtype, head_dim, bkv): f32 only (builds it if
    needed)."""
    return _attributes(_lib().klaraptor_flash_attention_attributes,
                       _DTYPE_CODE[dtype], head_dim, bkv)


def tile_attributes(head_dim: int, bq: int, bkv: int) -> dict[str, int]:
    """The same for the bf16 wgmma kernel of tile (bq, bkv) at head dim 64,
    128 or 256."""
    return _attributes(_lib().klaraptor_flash_attention_tile_attributes,
                       head_dim, bq, bkv)


def backward_attributes(dtype: torch.dtype, head_dim: int, kernel: str,
                        capped: bool = False) -> dict[str, int]:
    """The same for kernel ``kernel`` ("delta", "dkdv" or "dq") of the
    backward body that (dtype, head_dim) runs (builds it if needed); with
    ``capped``, the wgmma body's dK / dV or dQ compiled for a softcap (bf16
    only: the SIMT body has one kernel with and without the cap)."""
    which = BACKWARD_KERNELS.index(kernel)
    if capped:
        if dtype != torch.bfloat16 or kernel == "delta":
            raise ValueError(f"only the wgmma body's dkdv and dq are compiled "
                             f"for a softcap, not {dtype} {kernel}")
        which += 2
    lib = _bwd_lib()
    vals = [ctypes.c_int() for _ in range(3)]
    rc = lib.klaraptor_flash_attention_bwd_attributes(
        _DTYPE_CODE[dtype], head_dim, which,
        *[ctypes.byref(v) for v in vals])
    if rc:
        _raise_cuda("cudaFuncGetAttributes", rc, lib)
    return dict(zip(("num_regs", "max_threads", "local_bytes"),
                    (v.value for v in vals)))


def smem_bytes(head_dim: int, bq: int, bkv: int, elem_bytes: int) -> int:
    """Dynamic shared memory of one CTA.  The wgmma body: the Q tile, the
    K/V ring and its barriers; the SIMT body: Q, K and V tiles in the input
    type and the padded f32 probability tile."""
    if flash_uses_sm90(head_dim, elem_bytes):
        return flash_sm90_smem_bytes(head_dim, bq, bkv)
    return (bq + 2 * bkv) * head_dim * elem_bytes + bq * (bkv + FLASH_PAD) * 4


def _visible(cq: int, ckv: int, causal: bool, window: int | None,
             q_off: int, k_off: int, device) -> torch.Tensor:
    """(cq, ckv) mask of the (query, key) pairs attention computes."""
    qpos = (q_off + torch.arange(cq, device=device))[:, None]
    kpos = (k_off + torch.arange(ckv, device=device))[None, :]
    mask = torch.ones((cq, ckv), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    return mask


def _attn_block(qf, kf, vf, scale, softcap, causal, window, q_off, k_off=0,
                want_lse=False):
    """Attention for one query chunk, GQA-aware, in f32: (out, lse), lse
    None unless ``want_lse``.

    qf (b, kv, group, cq, d); kf/vf (b, kv, ckv, d): K/V stay at kv heads.
    """
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, kf) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = _visible(qf.shape[3], kf.shape[2], causal, window, q_off, k_off,
                    qf.device)
    p = torch.softmax(s.masked_fill(~mask, _NEG_INF), dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", p, vf)
    lse = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1) \
        if want_lse else None
    return out.masked_fill(~mask.any(dim=-1)[:, None], 0.0), lse


def flash_attention_plain(
    q: torch.Tensor,          # (b * hq, sq, d)
    k: torch.Tensor,          # (b * hkv, skv, d)
    v: torch.Tensor,
    *,
    num_q_heads: int,
    num_kv_heads: int,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
    q_chunk: int | None = None,
    return_lse: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Attention in plain PyTorch, f32 math, output in q's dtype.

    ``q_chunk=None`` materializes the full (b, h, sq, skv) score tensor;
    ``q_chunk=C`` streams over query chunks of C rows, and for causal
    self-attention each chunk reads only the keys it can see, as the JAX
    oracle does.  ``return_lse=True`` returns (out, lse), lse f32 (b * hq,
    sq), -inf for a row that sees no key.
    """
    bhq, sq, d = q.shape
    bhkv, skv, _ = k.shape
    b = bhq // num_q_heads
    group = num_q_heads // num_kv_heads
    scale = scale if scale is not None else d ** -0.5

    qf = q.float().reshape(b, num_kv_heads, group, sq, d)
    kf = k.float().reshape(b, num_kv_heads, skv, d)
    vf = v.float().reshape(b, num_kv_heads, skv, d)

    if q_chunk is None or q_chunk >= sq:
        out, lse = _attn_block(qf, kf, vf, scale, softcap, causal, window, 0,
                               want_lse=return_lse)
    else:
        outs, lses = [], []
        for lo in range(0, sq, q_chunk):    # the last chunk may be short
            hi = min(lo + q_chunk, sq)
            if causal and sq == skv:
                k_lo = 0 if window is None else max(0, lo - window + 1)
                k_lo = (k_lo // 128) * 128
                k_hi = hi
            else:
                k_lo, k_hi = 0, skv
            o, l = _attn_block(
                qf[:, :, :, lo:hi], kf[:, :, k_lo:k_hi], vf[:, :, k_lo:k_hi],
                scale, softcap, causal, window, lo, k_off=k_lo,
                want_lse=return_lse)
            outs.append(o)
            lses.append(l)
        out = torch.cat(outs, dim=3)
        lse = torch.cat(lses, dim=3) if return_lse else None
    out = out.reshape(bhq, sq, d).to(q.dtype)
    return (out, lse.reshape(bhq, sq)) if return_lse else out


def _check_operands(q, k, v, num_q_heads, num_kv_heads) -> None:
    """Raise ValueError on q, k, v that neither kernel takes."""
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape \
            or q.shape[2] != k.shape[2]:
        raise ValueError(f"flash attention takes q (b*hq, sq, d) and k, v "
                         f"(b*hkv, skv, d); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise ValueError(f"flash attention takes q, k, v of one dtype in "
                         f"{DTYPES}; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device) \
            or q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"q, k, v must share one cpu or cuda device; got "
                         f"{q.device}, {k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash attention takes contiguous q, k, v")
    bhq, sq, d = q.shape
    bhkv, skv, _ = k.shape
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one the kernel is built for "
                         f"{FLASH_HEAD_DIMS}")
    if num_q_heads <= 0 or num_kv_heads <= 0 or num_q_heads % num_kv_heads \
            or bhq % num_q_heads or bhkv % num_kv_heads \
            or bhq // num_q_heads != bhkv // num_kv_heads:
        raise ValueError(f"heads ({num_q_heads} q, {num_kv_heads} kv) do "
                         f"not match q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)}")
    if bhq > MAX_GRID_Y or max(sq, skv) + 128 >= 2**31:
        raise ValueError(f"shape {tuple(q.shape)} exceeds the launch grid")
    if q.device.type == "cuda" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must be 16-byte aligned")


def _check(q, k, v, num_q_heads, num_kv_heads, bq, bkv, window,
           softcap) -> None:
    """Raise ValueError on anything the forward kernel does not take."""
    _check_operands(q, k, v, num_q_heads, num_kv_heads)
    d = q.shape[2]
    if flash_uses_sm90(d, q.element_size()):
        if (bq, bkv) not in FLASH_SM90_TILES[d]:
            raise ValueError(f"(bq, bkv)=({bq!r}, {bkv!r}) is not a "
                             f"compiled tile of the bf16 wgmma kernel at "
                             f"head dim {d}; it has {FLASH_SM90_TILES[d]}")
    else:
        if not isinstance(bq, int) or bq <= 0 or bq % BQ_GRANULE:
            raise ValueError(f"bq={bq!r} must be a positive multiple of "
                             f"{BQ_GRANULE}")
        if bkv not in BKV_TILES:
            raise ValueError(f"bkv={bkv!r} must be one of {BKV_TILES}")
        threads = FLASH_THREADS_PER_ROW * bq
        regs = flash_regs_per_thread(d)
        if threads * regs > REGS_PER_SM:
            raise ValueError(f"bq={bq} gives {threads} threads of {regs} "
                             f"registers, more than an SM's {REGS_PER_SM}")
        smem = smem_bytes(d, bq, bkv, q.element_size())
        if smem > SMEM_LIMIT:
            raise ValueError(f"tiles need {smem} bytes of shared memory, "
                             f"more than the {SMEM_LIMIT} a block can have")
    _check_window_softcap(window, softcap)


def _check_window_softcap(window, softcap) -> None:
    if window is not None and (not isinstance(window, int)
                               or abs(window) >= 2**31):
        raise ValueError(f"window={window!r} must be an int32 or None")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap={softcap!r} must be positive or None")


def flash_attention_kernel(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    num_q_heads: int, num_kv_heads: int, bq: int, bkv: int,
    causal: bool = True, window: int | None = None,
    softcap: float | None = None, scale: float | None = None,
    return_lse: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Attention with tiles (bq, bkv): the CUDA kernel for CUDA tensors,
    ``flash_attention_plain`` for CPU tensors (after the same checks).
    ``return_lse=True`` returns (out, lse) and has the kernel write lse in
    its epilogue; without it the kernel gets a null lse pointer."""
    _check(q, k, v, num_q_heads, num_kv_heads, bq, bkv, window, softcap)
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, num_q_heads=num_q_heads, num_kv_heads=num_kv_heads,
            causal=causal, window=window, softcap=softcap, scale=scale,
            return_lse=return_lse)
    bhq, sq, d = q.shape
    skv = k.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty((bhq, sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if out.numel() == 0 or skv == 0:    # no key at all: every row gives 0
        if lse is not None:
            lse.fill_(float("-inf"))
        out.zero_()
        return (out, lse) if return_lse else out
    scale = scale if scale is not None else d ** -0.5
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _lib().klaraptor_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            bhq, sq, skv, d, num_q_heads, num_kv_heads, bq, bkv, float(scale),
            int(bool(causal)), int(window is not None),
            int(window) if window is not None else 0,
            float(softcap) if softcap is not None else 0.0,
            _DTYPE_CODE[q.dtype], stream)
    if rc:
        _raise_cuda("flash attention kernel launch", rc)
    LAUNCHES.launched((bhq, sq, skv, d, bool(causal)),
                      windowed=window is not None, bq=bq, bkv=bkv)
    return (out, lse) if return_lse else out


def flash_attention_backward_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    dout: torch.Tensor, lse: torch.Tensor, *, num_q_heads: int,
    num_kv_heads: int, causal: bool = True, window: int | None = None,
    softcap: float | None = None, scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of attention in plain PyTorch, f32 math, each in its
    input's dtype: c = scale q k^T (soft-capped to softcap tanh(c /
    softcap)), P = exp(c - lse) on the visible pairs (``_visible``, with
    the window), delta = rowsum(dout * out), dS = P (dout v^T - delta) g
    with g = 1 - (c / softcap)^2 the cap's derivative (1 with no cap), dq =
    scale dS k, dk = scale dS^T q and dv = P^T dout, summed over each kv
    head's group.  A row that sees no key (lse -inf) gets a zero gradient."""
    bhq, sq, d = q.shape
    bhkv, skv, _ = k.shape
    b = bhq // num_q_heads
    group = num_q_heads // num_kv_heads
    scale = scale if scale is not None else d ** -0.5

    def heads(t, n):                  # (b * h, s, d) -> (b, kv, group, s, d)
        return t.float().reshape(b, num_kv_heads, group, n, d)

    qf, of, dof = heads(q, sq), heads(out, sq), heads(dout, sq)
    kf = k.float().reshape(b, num_kv_heads, skv, d)
    vf = v.float().reshape(b, num_kv_heads, skv, d)
    l = lse.float().reshape(b, num_kv_heads, group, sq, 1)
    mask = _visible(sq, skv, causal, window, 0, 0, q.device) \
        & torch.isfinite(l)
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, kf) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    p = torch.exp(s - l.masked_fill(~torch.isfinite(l), 0.0)) \
        .masked_fill(~mask, 0.0)
    delta = (dof * of).sum(dim=-1, keepdim=True)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dof, vf)
    ds = p * (dp - delta)
    if softcap is not None:
        ds = ds * (1.0 - (s / softcap) ** 2)
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qf) * scale
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dof)
    return (dq.reshape(bhq, sq, d).to(q.dtype),
            dk.reshape(bhkv, skv, d).to(k.dtype),
            dv.reshape(bhkv, skv, d).to(v.dtype))


def flash_attention_backward_kernel(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    dout: torch.Tensor, lse: torch.Tensor, *, num_q_heads: int,
    num_kv_heads: int, causal: bool = True, window: int | None = None,
    softcap: float | None = None, scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv): the CUDA backward kernel for CUDA tensors,
    ``flash_attention_backward_plain`` for CPU tensors (after the same
    checks).  q, out, dout (b * hq, sq, d) and k, v (b * hkv, skv, d) of one
    dtype and lse f32 (b * hq, sq), all contiguous; the forward's window
    and softcap.  bf16 runs the wgmma body (head dims 64, 128, 256), f32
    the SIMT body (64, 128)."""
    _check_operands(q, k, v, num_q_heads, num_kv_heads)
    _check_window_softcap(window, softcap)
    bhq, sq, d = q.shape
    if out.shape != q.shape or dout.shape != q.shape \
            or out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"out and dout must be like q {tuple(q.shape)} "
                         f"{q.dtype}; got {tuple(out.shape)} {out.dtype} and "
                         f"{tuple(dout.shape)} {dout.dtype}")
    if lse.shape != (bhq, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be f32 {(bhq, sq)}; got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    body = backward_body(q.dtype, d)        # raises on an unbuilt head dim
    for name, t in (("out", out), ("dout", dout), ("lse", lse)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    kw = dict(num_q_heads=num_q_heads, num_kv_heads=num_kv_heads,
              causal=causal, window=window, softcap=softcap, scale=scale)
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, out, dout, lse, **kw)
    if any(t.data_ptr() % 16 for t in (out, dout)):
        raise ValueError("out and dout must be 16-byte aligned")
    skv = k.shape[1]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    # delta, then (bf16) lse in the log2 domain, rows padded
    sq_pad = -(-sq // BACKWARD_ROW_PAD) * BACKWARD_ROW_PAD
    work = torch.empty(2 * bhq * sq_pad, dtype=torch.float32,
                       device=q.device)
    scale = scale if scale is not None else d ** -0.5
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.klaraptor_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), work.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), bhq, sq, skv, d, num_q_heads,
            num_kv_heads, float(scale), int(bool(causal)),
            int(window is not None), int(window) if window is not None else 0,
            float(softcap) if softcap is not None else 0.0,
            _DTYPE_CODE[q.dtype], stream)
    if rc:
        _raise_cuda("flash attention backward launch", rc, lib)
    BACKWARD_LAUNCHES.launched((bhq, sq, skv, d, bool(causal)),
                               windowed=window is not None, body=body,
                               capped=softcap is not None)
    return dq, dk, dv
