"""Flash attention: the hand-written CUDA kernel's wrapper and its plain version.

``flash_attention_kernel`` launches ``csrc/flash_attention.cu`` (the Hopper
port of the JAX package's ``flash_attention_pallas``) with launch parameters
(bq, bkv): a grid of ceil(sq / bq) x (b * hq) CTAs of 4 * bq threads, each CTA
looping over kv blocks of bkv rows.  q is (b * hq, sq, d), k and v are
(b * hkv, skv, d), bf16 or f32; q head ``bh`` reads kv head
``(bh // hq) * hkv + (bh % hq) // (hq // hkv)``.  The softmax, its running
max and sum, and the output accumulator are f32; the output has q's dtype.

``flash_attention_plain`` computes the same function in plain PyTorch, as
the JAX package's ``flash_attention_ref`` does: the full score tensor per
query chunk, the same masks, and 0 for a query row that sees no key.  It
keeps the probabilities in f32 for the PV product (the kernel's arithmetic;
the JAX oracle casts them to v's dtype first, which is the same in f32).  The
tests use it, and the wrapper takes it only for tensors on the CPU; a CUDA
tensor launches the kernel or raises.  ``LAUNCHES.count`` counts kernel
launches and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.kernel_spec import (FLASH_HEAD_DIMS, FLASH_PAD,
                                FLASH_THREADS_PER_ROW, flash_regs_per_thread)
from ._build import load
from .matmul import LaunchCounter

__all__ = ["BKV_TILES", "DTYPES", "LAUNCHES", "flash_attention_kernel",
           "flash_attention_plain", "kernel_attributes", "smem_bytes"]

DTYPES = (torch.float32, torch.bfloat16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
BKV_TILES = (32, 64, 128)       # the kernel's template instantiations
BQ_GRANULE = 16                 # 4 rows per thread x 4 threads per row
SMEM_LIMIT = 232448             # dynamic shared memory a block may opt in to
REGS_PER_SM = 65536
MAX_GRID_Y = 65535
_NEG_INF = -1e30

LAUNCHES = LaunchCounter()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load("flash_attention")
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.klaraptor_flash_attention.argtypes = [
        vp, vp, vp, vp, i, i, i, i, i, i, i, i, f, i, i, i, f, i, vp]
    lib.klaraptor_flash_attention.restype = i
    ip = ctypes.POINTER(ctypes.c_int)
    lib.klaraptor_flash_attention_attributes.argtypes = [i, i, i, ip, ip, ip]
    lib.klaraptor_flash_attention_attributes.restype = i
    lib.klaraptor_flash_error_string.argtypes = [i]
    lib.klaraptor_flash_error_string.restype = ctypes.c_char_p
    return lib


def _raise_cuda(what: str, rc: int) -> None:
    msg = _lib().klaraptor_flash_error_string(rc).decode()
    raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


def kernel_attributes(dtype: torch.dtype, head_dim: int,
                      bkv: int) -> dict[str, int]:
    """Registers per thread, thread limit and spilled local bytes of the
    kernel compiled for (dtype, head_dim, bkv) (builds it if needed)."""
    vals = [ctypes.c_int() for _ in range(3)]
    rc = _lib().klaraptor_flash_attention_attributes(
        _DTYPE_CODE[dtype], head_dim, bkv, *[ctypes.byref(v) for v in vals])
    if rc:
        _raise_cuda("cudaFuncGetAttributes", rc)
    return dict(zip(("num_regs", "max_threads", "local_bytes"),
                    (v.value for v in vals)))


def smem_bytes(head_dim: int, bq: int, bkv: int, elem_bytes: int) -> int:
    """Dynamic shared memory of one CTA: Q, K and V tiles in the input type
    and the padded f32 probability tile."""
    return (bq + 2 * bkv) * head_dim * elem_bytes + bq * (bkv + FLASH_PAD) * 4


def _attn_block(qf, kf, vf, scale, softcap, causal, window, q_off, k_off=0):
    """Attention for one query chunk, GQA-aware, in f32.

    qf (b, kv, group, cq, d); kf/vf (b, kv, ckv, d): K/V stay at kv heads.
    """
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, kf) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    cq, ckv = qf.shape[3], kf.shape[2]
    qpos = (q_off + torch.arange(cq, device=qf.device))[:, None]
    kpos = (k_off + torch.arange(ckv, device=qf.device))[None, :]
    mask = torch.ones((cq, ckv), dtype=torch.bool, device=qf.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    p = torch.softmax(s.masked_fill(~mask, _NEG_INF), dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", p, vf)
    return out.masked_fill(~mask.any(dim=-1)[:, None], 0.0)


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
) -> torch.Tensor:
    """Attention in plain PyTorch, f32 math, output in q's dtype.

    ``q_chunk=None`` materializes the full (b, h, sq, skv) score tensor;
    ``q_chunk=C`` streams over query chunks of C rows, and for causal
    self-attention each chunk reads only the keys it can see, as the JAX
    oracle does.
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
        out = _attn_block(qf, kf, vf, scale, softcap, causal, window, 0)
    else:
        outs = []
        for lo in range(0, sq, q_chunk):    # the last chunk may be short
            hi = min(lo + q_chunk, sq)
            if causal and sq == skv:
                k_lo = 0 if window is None else max(0, lo - window + 1)
                k_lo = (k_lo // 128) * 128
                k_hi = hi
            else:
                k_lo, k_hi = 0, skv
            outs.append(_attn_block(
                qf[:, :, :, lo:hi], kf[:, :, k_lo:k_hi], vf[:, :, k_lo:k_hi],
                scale, softcap, causal, window, lo, k_off=k_lo))
        out = torch.cat(outs, dim=3)
    return out.reshape(bhq, sq, d).to(q.dtype)


def _check(q, k, v, num_q_heads, num_kv_heads, bq, bkv, window,
           softcap) -> None:
    """Raise ValueError on anything the kernel does not take."""
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
        raise ValueError(f"tiles need {smem} bytes of shared memory, more "
                         f"than the {SMEM_LIMIT} a block can have")
    if bhq > MAX_GRID_Y or max(sq, skv) + 128 >= 2**31:
        raise ValueError(f"shape {tuple(q.shape)} exceeds the launch grid")
    if window is not None and (not isinstance(window, int)
                               or abs(window) >= 2**31):
        raise ValueError(f"window={window!r} must be an int32 or None")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap={softcap!r} must be positive or None")
    if q.device.type == "cuda" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must be 16-byte aligned")


def flash_attention_kernel(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    num_q_heads: int, num_kv_heads: int, bq: int, bkv: int,
    causal: bool = True, window: int | None = None,
    softcap: float | None = None, scale: float | None = None,
) -> torch.Tensor:
    """Attention with tiles (bq, bkv): the CUDA kernel for CUDA tensors,
    ``flash_attention_plain`` for CPU tensors (after the same checks)."""
    _check(q, k, v, num_q_heads, num_kv_heads, bq, bkv, window, softcap)
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, num_q_heads=num_q_heads, num_kv_heads=num_kv_heads,
            causal=causal, window=window, softcap=softcap, scale=scale)
    bhq, sq, d = q.shape
    skv = k.shape[1]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    scale = scale if scale is not None else d ** -0.5
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _lib().klaraptor_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bhq, sq, skv, d, num_q_heads, num_kv_heads, bq, bkv, float(scale),
            int(bool(causal)), int(window is not None),
            int(window) if window is not None else 0,
            float(softcap) if softcap is not None else 0.0,
            _DTYPE_CODE[q.dtype], stream)
    if rc:
        _raise_cuda("flash attention kernel launch", rc)
    LAUNCHES.count += 1
    return out
