"""Mamba-2 SSD chunked scan: the hand-written CUDA kernel's wrapper and its
plain version.

``ssd_scan_kernel`` launches ``csrc/ssd_scan.cu`` (the Hopper port of the JAX
package's ``ssd_scan_pallas``) with launch parameter ``chunk``.  x is (bh, s,
dh), dt (bh, s), A (bh,), and B and C (bh / h, s, n), each shared by h
consecutive rows of x: h is inferred from the shapes, and h = 1 is the
reference's per-head interface.  x, B and C are bf16 or f32 of one type, dt
and A are f32 (the layer computes them in f32), and y has x's type.

The kernel is bound by bytes and by the chain of chunk states, so it runs
every chunk of every row as a CTA of its own, all in parallel: a CTA
computes what needs no other chunk, then takes the previous chunk's f32
state from an L2 ring (two slots per chain, which the wrapper allocates),
publishes its own and finishes its rows.  The h rows that share B and C run
each chunk together, so B and C come from device memory once per group.
bf16 at a compiled (dh, n) (``SSD_SM90_SHAPES``) runs the wgmma body with
the compiled chunks only (``SSD_SM90_CHUNKS``; another chunk raises, on the
CPU too); f32, and bf16 at other shapes, the SIMT body, whose chunk is any
multiple of 32 whose stage fits in shared memory.  The kernel masks a ragged
last chunk, so the chunk need not divide s.

``ssd_scan_plain`` computes the same chunked function in plain PyTorch, f32
inside: per chunk the decay-gated quadratic form and the carried state's
term, then the state update, with a shorter last chunk where the chunk does
not divide s.  The tests use it, and the wrapper takes it only for tensors on
the CPU; a CUDA tensor launches the kernel or raises.  ``LAUNCHES.count``
counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.kernel_spec import (SSD_COLS, SSD_ROWS, SSD_SM90_CHUNKS,
                                SSD_STATE_SLOTS, SSD_THREADS, ssd_smem_bytes,
                                ssd_uses_sm90)
from ._build import load
from ._workspace import zeroed_ints
from .matmul import LaunchCounter

__all__ = ["DTYPES", "LAUNCHES", "kernel_attributes", "ssd_ctas",
           "ssd_scan_kernel", "ssd_scan_plain", "tile_attributes"]

DTYPES = (torch.float32, torch.bfloat16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448     # dynamic shared memory a block may opt in to
_NEG_INF = -1e30

LAUNCHES = LaunchCounter()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load("ssd_scan")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.klaraptor_ssd_scan.argtypes = [vp] * 8 + [i] * 7 + [vp]
    lib.klaraptor_ssd_scan.restype = i
    ip = ctypes.POINTER(ctypes.c_int)
    lib.klaraptor_ssd_scan_attributes.argtypes = [i, ip, ip, ip]
    lib.klaraptor_ssd_scan_attributes.restype = i
    lib.klaraptor_ssd_scan_tile_attributes.argtypes = [i, i, i, ip, ip, ip]
    lib.klaraptor_ssd_scan_tile_attributes.restype = i
    lib.klaraptor_ssd_error_string.argtypes = [i]
    lib.klaraptor_ssd_error_string.restype = ctypes.c_char_p
    return lib


def _raise_cuda(what: str, rc: int) -> None:
    msg = _lib().klaraptor_ssd_error_string(rc).decode()
    raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


def _read_attributes(fn, *args) -> dict[str, int]:
    vals = [ctypes.c_int() for _ in range(3)]
    rc = fn(*args, *[ctypes.byref(v) for v in vals])
    if rc:
        _raise_cuda("cudaFuncGetAttributes", rc)
    return dict(zip(("num_regs", "max_threads", "local_bytes"),
                    (v.value for v in vals)))


def kernel_attributes(dtype: torch.dtype) -> dict[str, int]:
    """Registers per thread, thread limit and spilled local bytes of the
    SIMT body compiled for ``dtype`` (builds it if needed)."""
    return _read_attributes(_lib().klaraptor_ssd_scan_attributes,
                            _DTYPE_CODE[dtype])


def tile_attributes(dh: int, n: int, chunk: int) -> dict[str, int]:
    """The same for the bf16 wgmma instantiation (dh, n, chunk)."""
    return _read_attributes(_lib().klaraptor_ssd_scan_tile_attributes, dh, n,
                            chunk)


def ssd_ctas(bh: int, s: int, dh: int, n: int, chunk: int,
             dtype: torch.dtype) -> int:
    """CTAs of one launch: one per chunk of each row, times dh / SSD_COLS
    column blocks in the SIMT body."""
    chunks = -(-s // chunk)
    if ssd_uses_sm90(dh, n, torch.finfo(dtype).bits // 8):
        return bh * chunks
    return bh * (dh // SSD_COLS) * chunks


def _per_row(t: torch.Tensor, bh: int) -> torch.Tensor:
    """B or C (bh / h, s, n) as one copy per row of x (bh, s, n)."""
    g = t.shape[0]
    return t[:, None].expand(g, bh // g, *t.shape[1:]).reshape(bh,
                                                                *t.shape[1:])


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, A: torch.Tensor,
                   chunk: int = 256) -> torch.Tensor:
    """The SSD scan in plain PyTorch, chunk by chunk, f32 inside; the output
    has x's dtype.  x (bh, s, dh); dt (bh, s); B, C (bh / h, s, n), each
    shared by h consecutive rows of x; A (bh,)."""
    bh, s, dh = x.shape
    n = B.shape[-1]
    xf, dtf = x.float(), dt.float()
    Bf, Cf = _per_row(B.float(), bh), _per_row(C.float(), bh)
    a = A.float()[:, None]                                  # (bh, 1)
    state = torch.zeros(bh, n, dh, dtype=torch.float32, device=x.device)
    out = torch.empty(bh, s, dh, dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):                # the last chunk may be short
        c1 = min(c0 + chunk, s)
        xc, dc, Bc, Cc = xf[:, c0:c1], dtf[:, c0:c1], Bf[:, c0:c1], Cf[:, c0:c1]
        cum = torch.cumsum(a * dc, dim=1)                   # (bh, L) inclusive
        total = cum[:, -1:]                                 # (bh, 1)
        idx = torch.arange(c1 - c0, device=x.device)
        causal = idx[:, None] >= idx[None, :]
        # mask the exponent before exp: i < j would overflow
        expnt = (cum[:, :, None] - cum[:, None, :]).masked_fill(~causal,
                                                                _NEG_INF)
        gate = torch.exp(expnt) * dc[:, None, :]            # (bh, L, L)
        scores = torch.einsum("bin,bjn->bij", Cc, Bc) * gate
        out[:, c0:c1] = scores @ xc + (Cc * torch.exp(cum)[..., None]) @ state
        w = torch.exp(total - cum) * dc                     # (bh, L)
        state = torch.exp(total)[..., None] * state + torch.einsum(
            "bjn,bjd->bnd", Bc * w[..., None], xc)
    return out.to(x.dtype)


def _check(x, dt, B, C, A, chunk) -> None:
    """Raise ValueError on anything the kernel does not take."""
    if x.ndim != 3 or B.ndim != 3 or B.shape != C.shape \
            or B.shape[1] != x.shape[1] or B.shape[0] < 1 \
            or x.shape[0] % B.shape[0] \
            or tuple(dt.shape) != x.shape[:2] \
            or tuple(A.shape) != x.shape[:1]:
        raise ValueError(f"the SSD scan takes x (bh, s, dh), dt (bh, s), B "
                         f"and C (bh / h, s, n), each shared by h "
                         f"consecutive rows of x, and A (bh,); got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}, "
                         f"{tuple(A.shape)}")
    if not (x.dtype == B.dtype == C.dtype) or x.dtype not in DTYPES \
            or dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"the SSD scan takes x, B, C of one dtype in "
                         f"{DTYPES} and f32 dt and A; got {x.dtype}, "
                         f"{B.dtype}, {C.dtype}, {dt.dtype}, {A.dtype}")
    tensors = (x, dt, B, C, A)
    if len({t.device for t in tensors}) != 1 \
            or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"x, dt, B, C, A must share one cpu or cuda device; "
                         f"got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the SSD scan takes contiguous x, dt, B, C, A")
    bh, s, dh = x.shape
    n = B.shape[-1]
    if dh % SSD_COLS or n % 8:
        raise ValueError(f"head dim {dh} and state {n} are not ones the "
                         f"kernel takes (head dim divisible by {SSD_COLS}, "
                         f"state divisible by 8)")
    if not isinstance(chunk, int) or chunk <= 0:
        raise ValueError(f"chunk={chunk!r} must be a positive int")
    if ssd_uses_sm90(dh, n, x.element_size()):
        if chunk not in SSD_SM90_CHUNKS:
            raise ValueError(f"chunk={chunk} is not compiled for the bf16 "
                             f"wgmma body at (dh {dh}, n {n}): it has "
                             f"chunks {SSD_SM90_CHUNKS}")
    elif chunk % SSD_ROWS:
        raise ValueError(f"chunk={chunk!r} must be a positive multiple of "
                         f"{SSD_ROWS}")
    smem = ssd_smem_bytes(chunk, n, x.element_size(), dh)
    if smem > SMEM_LIMIT:
        raise ValueError(f"chunk {chunk} needs {smem} bytes of shared "
                         f"memory, more than the {SMEM_LIMIT} a block can "
                         f"have")
    if x.numel() >= 2**31 or B.numel() >= 2**31 \
            or ssd_ctas(bh, s, dh, n, chunk, x.dtype) >= 2**31:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the launch grid")
    if x.device.type == "cuda" and any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("x, dt, B, C, A must be 16-byte aligned")


def ssd_scan_kernel(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor, A: torch.Tensor, *,
                    chunk: int) -> torch.Tensor:
    """The SSD scan at chunk length ``chunk``: the CUDA kernel for CUDA
    tensors, ``ssd_scan_plain`` for CPU tensors (after the same checks).
    B and C may be (bh / h, s, n), shared by h consecutive rows of x."""
    _check(x, dt, B, C, A, chunk)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, B, C, A, chunk=chunk)
    bh, s, dh = x.shape
    n = B.shape[-1]
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    # a chain per row (per 16 head-dim columns in the SIMT body), a flag per
    # warp of a chain's CTA
    if ssd_uses_sm90(dh, n, x.element_size()):
        cols, warps = dh, 2 * chunk // 32
    else:
        cols, warps = SSD_COLS, SSD_THREADS // 32
    chains = bh * (dh // cols)
    states = torch.empty(chains * SSD_STATE_SLOTS * n * cols,
                         dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        sync = zeroed_ints(x.device, stream, 1 + chains * warps)
        rc = _lib().klaraptor_ssd_scan(
            x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
            A.data_ptr(), out.data_ptr(), states.data_ptr(), sync.data_ptr(),
            bh, s, dh, n, chunk, bh // B.shape[0], _DTYPE_CODE[x.dtype],
            stream)
    if rc:
        _raise_cuda("SSD scan kernel launch", rc)
    LAUNCHES.count += 1
    return out
