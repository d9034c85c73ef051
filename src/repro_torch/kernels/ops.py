"""Tuned kernel dispatch -- the runtime integration point of KLARAPTOR.

Each op consults the driver registry *immediately before launch* (paper
Section V-C: one IO call per kernel call, data parameters in, launch
parameters out) and launches the CUDA kernel with the chosen tiles: the
matmul snaps them to the shape with ``fit_tile`` at the granularities the
port's kernel spec states; flash attention and the SSD scan mask ragged
tails in the kernel and take them as chosen.  With no driver registered an
op uses its static default config.

A CUDA tensor always goes to the kernel (or raises); only a CPU tensor takes
the kernel's plain PyTorch version.
"""

from __future__ import annotations

import functools
import re
from typing import Callable, Mapping

import torch
import torch.nn.functional as F

from ..core.driver import choose_or_default, fit_tile
from ..core.kernel_spec import (CandidateTable, flash_attention_spec,
                                matmul_spec, ssd_scan_spec)
from .flash_attention import flash_attention_kernel, flash_attention_plain
from .matmul import matmul_kernel, matmul_plain
from .ssd_scan import ssd_scan_kernel, ssd_scan_plain

__all__ = ["FLASH_DEFAULT", "MATMUL_DEFAULT", "SSD_DEFAULT",
           "flash_attention", "flash_kernel_name", "matmul",
           "matmul_kernel_name", "probe_launcher", "ssd_kernel_name",
           "ssd_scan"]

# Static heuristic defaults (what a programmer would hard-code).  The flash
# default fits the kernel at every head dim and dtype it is built for; the
# SSD default is the reference's.
MATMUL_DEFAULT = {"bm": 128, "bn": 128, "bk": 32}
FLASH_DEFAULT = {"bq": 64, "bkv": 64}
SSD_DEFAULT = {"chunk": 256}

_FLASH_NAME = re.compile(r"^flash_attn_d(\d+)(_causal)?$")
_SSD_NAME = re.compile(r"^ssd_scan_h(\d+)_n(\d+)$")

_MATMUL_KERNELS = {torch.bfloat16: "matmul_b16", torch.float32: "matmul_b32"}


def matmul_kernel_name(dtype: torch.dtype) -> str:
    """The kernel-spec name the matmul of ``dtype`` inputs is tuned under."""
    try:
        return _MATMUL_KERNELS[dtype]
    except KeyError:
        raise ValueError(f"no matmul kernel for {dtype}; inputs must be "
                         f"one of {tuple(_MATMUL_KERNELS)}") from None


@functools.lru_cache(maxsize=None)
def _alignments(kernel: str) -> dict[str, int]:
    spec = matmul_spec(dtype_bytes=2 if kernel == "matmul_b16" else 4)
    return {p: spec.alignment(p) for p in spec.program_params}


def _round_up(v: int, a: int) -> int:
    return -(-v // a) * a


def matmul(x: torch.Tensor, y: torch.Tensor, *,
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Tuned x @ y over the last two dims of x; leading dims are batched.

    ``y`` is one (k, n) matrix shared by every batch entry, so the batch
    folds into m and the product is one launch at (batch * m, n, k).  Dims
    that are not multiples of the spec's granularity are zero-padded (exact
    for a product) and the result is sliced back.
    """
    if x.ndim < 2 or y.ndim != 2 or x.shape[-1] != y.shape[0]:
        raise ValueError(f"matmul takes x (..., m, k) and y (k, n); got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    k, n = y.shape
    x2 = x.reshape(-1, k)
    if x.device.type == "cpu" and y.device.type == "cpu":
        return matmul_plain(x2, y, out_dtype).reshape(*lead, n)
    if x.device.type != "cuda":
        raise ValueError(f"matmul runs on cuda or cpu tensors, not {x.device}")
    kernel = matmul_kernel_name(x.dtype)
    align = _alignments(kernel)
    m = x2.shape[0]
    mp, np_, kp = (_round_up(m, align["bm"]), _round_up(n, align["bn"]),
                   _round_up(k, align["bk"]))
    if (mp, kp) != (m, k):
        x2 = F.pad(x2, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        y = F.pad(y, (0, np_ - n, 0, kp - k))
    x2, y2 = x2.contiguous(), y.contiguous()
    cfg = choose_or_default(kernel, {"m": mp, "n": np_, "k": kp},
                            MATMUL_DEFAULT)
    out = matmul_kernel(x2, y2, bm=fit_tile(mp, cfg["bm"], align["bm"]),
                        bn=fit_tile(np_, cfg["bn"], align["bn"]),
                        bk=fit_tile(kp, cfg["bk"], align["bk"]),
                        out_dtype=out_dtype)
    if (mp, np_) != (m, n):
        out = out[:m, :n]
    return out.reshape(*lead, n)


def flash_kernel_name(head_dim: int, causal: bool) -> str:
    """The kernel-spec name flash attention is tuned under (as the JAX
    package names it: the dtype is not part of the name)."""
    return f"flash_attn_d{head_dim}" + ("_causal" if causal else "")


@functools.lru_cache(maxsize=None)
def _flash_tile_fits(head_dim: int, causal: bool, dtype_bytes: int,
                     bq: int, bkv: int) -> bool:
    """Whether tiles (bq, bkv) satisfy the flash spec of this dtype (a
    driver tuned in bf16 may pick a tile whose f32 stage is too large)."""
    spec = flash_attention_spec(head_dim, causal, dtype_bytes)
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
                    q_chunk: int | None = None) -> torch.Tensor:
    """(b*hq, sq, d) x (b*hkv, skv, d)^2 -> (b*hq, sq, d), tuned tiles.

    CPU tensors take ``flash_attention_plain`` (streamed over ``q_chunk``
    query rows, as the JAX path does).  CUDA tensors resolve (bq, bkv)
    through ``choose_or_default`` at D = (bh, sq, skv) and launch the
    kernel, which masks ragged tails, so no shape is padded; ``q_chunk``
    does not apply to the kernel, which streams by construction.
    """
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
    cfg = choose_or_default(flash_kernel_name(d, causal),
                            {"bh": bh, "sq": sq, "skv": k.shape[1]},
                            FLASH_DEFAULT)
    if not _flash_tile_fits(d, causal, q.element_size(), cfg["bq"],
                            cfg["bkv"]):
        cfg = FLASH_DEFAULT
    return flash_attention_kernel(
        q, k, v, num_q_heads=num_q_heads, num_kv_heads=num_kv_heads,
        bq=cfg["bq"], bkv=cfg["bkv"], causal=causal, window=window,
        softcap=softcap, scale=scale)


def ssd_kernel_name(head_dim: int, d_state: int) -> str:
    """The kernel-spec name the SSD scan is tuned under (the reference's:
    the dtype is not part of the name)."""
    return f"ssd_scan_h{head_dim}_n{d_state}"


@functools.lru_cache(maxsize=None)
def _ssd_chunk(head_dim: int, d_state: int, dtype_bytes: int,
               chunk: int) -> int:
    """``chunk`` if the SSD spec of this dtype takes it, else the largest
    smaller candidate it takes (a driver tuned in bf16, or the default, may
    name a chunk whose f32 stage is too large)."""
    spec = ssd_scan_spec(head_dim, d_state, dtype_bytes)
    D = {"bh": 1, "s": 1, "chunkflops": 1}
    fits = spec.candidates(D)["chunk"]
    below = fits[fits <= chunk]
    if chunk in fits:
        return int(chunk)
    return int(below.max() if below.size else fits.min())


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Mamba-2 SSD scan with the tuned chunk length: x (bh, s, dh), dt
    (bh, s), B, C (bh, s, n), A (bh,) -> y (bh, s, dh) in x's dtype.

    The chunk is resolved through ``choose_or_default`` at D = (bh, s,
    chunkflops 1), the reference's key, and taken as chosen (the kernel
    masks a ragged last chunk); a chunk this dtype's shared memory cannot
    hold falls to the largest smaller one that fits.  CUDA tensors launch
    the kernel; CPU tensors take ``ssd_scan_plain`` at the same chunk.
    """
    bh, s, dh = x.shape
    n = B.shape[-1]
    cfg = choose_or_default(ssd_kernel_name(dh, n),
                            {"bh": bh, "s": s, "chunkflops": 1}, SSD_DEFAULT)
    chunk = _ssd_chunk(dh, n, x.element_size(), int(cfg["chunk"]))
    dt, A = dt.float().contiguous(), A.float().contiguous()
    tensors = (x, dt, B, C, A)
    if all(t.device.type == "cpu" for t in tensors):
        return ssd_scan_plain(x, dt, B, C, A, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu tensors, not "
                         f"{x.device}")
    return ssd_scan_kernel(x.contiguous(), dt, B.contiguous(),
                           C.contiguous(), A, chunk=chunk)


def probe_launcher(kernel: str, D: Mapping[str, int], device: torch.device,
                   seed: int) -> Callable[[Mapping[str, int]], None]:
    """Bind seeded inputs of kernel ``kernel`` at data size D on ``device``
    and return ``launch(P)``, which runs the kernel once at tiles P --
    what ``CudaEventTimer`` times.

    Flash attention is probed in bf16 (the models' dtype) with one kv head
    per q head (D carries no head counts) and the spec's causality; the SSD
    scan in bf16 with dt in [0.01, 0.51] and A in [-1.5, -0.5], the JAX
    kernel tests' ranges.
    """
    gen = torch.Generator(device=device).manual_seed(int(seed))
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
        Bm = (randn(bh, s, n) * 0.3).to(torch.bfloat16)
        Cm = (randn(bh, s, n) * 0.3).to(torch.bfloat16)
        A = -0.5 - rand(bh)

        def launch_ssd(P: Mapping[str, int]) -> None:
            ssd_scan_kernel(x, dt, Bm, Cm, A, chunk=int(P["chunk"]))

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

        def launch_flash(P: Mapping[str, int]) -> None:
            flash_attention_kernel(q, k, v, num_q_heads=bh, num_kv_heads=bh,
                                   bq=int(P["bq"]), bkv=int(P["bkv"]),
                                   causal=causal)

        return launch_flash
    if kernel not in _MATMUL_KERNELS.values():
        raise ValueError(f"no probe launcher for kernel {kernel!r}")
    dtype = torch.bfloat16 if kernel == "matmul_b16" else torch.float32
    x = torch.randn(D["m"], D["k"], generator=gen, device=device).to(dtype)
    y = torch.randn(D["k"], D["n"], generator=gen, device=device).to(dtype)

    def launch(P: Mapping[str, int]) -> None:
        matmul_kernel(x, y, bm=int(P["bm"]), bn=int(P["bn"]),
                      bk=int(P["bk"]))

    return launch
