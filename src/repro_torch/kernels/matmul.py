"""Tiled matmul: the hand-written CUDA kernel's wrapper and its plain version.

``matmul_kernel`` launches ``csrc/matmul.cu`` (the Hopper port of the JAX
package's ``matmul_pallas``) with launch parameters (bm, bn, bk): a grid of
(m / bm) x (n / bn) CTAs of (bm / 8) * (bn / 8) threads, each CTA looping
over k in steps of bk.  Inputs are bf16 or f32, accumulation is f32, and the
result is cast to ``out_dtype`` (bf16, f16 or f32).

``matmul_plain`` computes the same function in plain PyTorch, accumulating
in f32 as a sum of outer products over k.  The tests use it, and the wrapper
takes it only for tensors on the CPU; a CUDA tensor launches the kernel or
raises.  ``LAUNCHES.count`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load

__all__ = ["IN_DTYPES", "LAUNCHES", "OUT_DTYPES", "LaunchCounter",
           "kernel_attributes", "matmul_kernel", "matmul_plain"]

IN_DTYPES = (torch.float32, torch.bfloat16)
OUT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

GRANULE = 8             # micro-tile edge and 16-byte vector width (bf16)
MAX_THREADS = 512       # the kernel's __launch_bounds__
SMEM_LIMIT = 232448     # dynamic shared memory a block may opt in to
MAX_GRID_Y = 65535
_PLAIN_CHUNK_ELEMS = 1 << 24   # f32 elements of one outer-product chunk


class LaunchCounter:
    """How many times a kernel was launched (``count``, a plain int)."""

    def __init__(self) -> None:
        self.count = 0

    def reset(self) -> None:
        self.count = 0


LAUNCHES = LaunchCounter()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load("matmul")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.klaraptor_matmul.argtypes = [vp, vp, vp, i, i, i, i, i, i, i, i, vp]
    lib.klaraptor_matmul.restype = i
    ip = ctypes.POINTER(ctypes.c_int)
    lib.klaraptor_matmul_attributes.argtypes = [i, ip, ip, ip]
    lib.klaraptor_matmul_attributes.restype = i
    lib.klaraptor_error_string.argtypes = [i]
    lib.klaraptor_error_string.restype = ctypes.c_char_p
    return lib


def _raise_cuda(what: str, rc: int) -> None:
    msg = _lib().klaraptor_error_string(rc).decode()
    raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


def kernel_attributes(dtype: torch.dtype) -> dict[str, int]:
    """Registers per thread, thread limit and spilled local bytes of the
    kernel compiled for ``dtype`` in and out (builds it if needed)."""
    vals = [ctypes.c_int() for _ in range(3)]
    rc = _lib().klaraptor_matmul_attributes(
        _DTYPE_CODE[dtype], *[ctypes.byref(v) for v in vals])
    if rc:
        _raise_cuda("cudaFuncGetAttributes", rc)
    return dict(zip(("num_regs", "max_threads", "local_bytes"),
                    (v.value for v in vals)))


def matmul_plain(x: torch.Tensor, y: torch.Tensor,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x[m, k] @ y[k, n] in plain PyTorch: f32 accumulation, cast at the end.

    Sums outer products over chunks of k, so no library matmul is called;
    chunks are sized to keep the (m, chunk, n) product under 64 MB.
    """
    out_dtype = out_dtype or x.dtype
    m, k = x.shape
    n = y.shape[1]
    xf, yf = x.float(), y.float()
    acc = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    chunk = max(1, _PLAIN_CHUNK_ELEMS // max(m * n, 1))
    for l0 in range(0, k, chunk):
        l1 = min(l0 + chunk, k)
        if l1 - l0 == 1:
            acc.addcmul_(xf[:, l0:l1], yf[l0:l1, :])
        else:
            acc += (xf[:, l0:l1, None] * yf[None, l0:l1, :]).sum(1)
    return acc.to(out_dtype)


def _check(x: torch.Tensor, y: torch.Tensor, bm: int, bn: int, bk: int,
           out_dtype: torch.dtype) -> None:
    """Raise ValueError on anything the kernel does not take."""
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"matmul takes x (m, k) and y (k, n); got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if x.dtype != y.dtype or x.dtype not in IN_DTYPES:
        raise ValueError(f"matmul takes two inputs of one dtype in "
                         f"{IN_DTYPES}; got {x.dtype} and {y.dtype}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {OUT_DTYPES}, "
                         f"got {out_dtype}")
    if x.device != y.device or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"inputs must share one cpu or cuda device; got "
                         f"{x.device} and {y.device}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("matmul takes contiguous inputs")
    m, k = x.shape
    n = y.shape[1]
    for name, t, size in (("bm", bm, m), ("bn", bn, n), ("bk", bk, k)):
        if not isinstance(t, int) or t <= 0 or t % GRANULE:
            raise ValueError(f"{name}={t!r} must be a positive multiple "
                             f"of {GRANULE}")
        if size % t:
            raise ValueError(f"{name}={t} does not divide {size}")
    threads = (bm // GRANULE) * (bn // GRANULE)
    if threads > MAX_THREADS:
        raise ValueError(f"bm * bn / 64 = {threads} threads exceeds the "
                         f"kernel's {MAX_THREADS}")
    smem = (bm + bn) * bk * x.element_size()
    if smem > SMEM_LIMIT:
        raise ValueError(f"tiles need {smem} bytes of shared memory, more "
                         f"than the {SMEM_LIMIT} a block can have")
    if m // bm > MAX_GRID_Y or max(m, n, k) >= 2**31:
        raise ValueError(f"shape ({m}, {n}, {k}) exceeds the launch grid")
    if x.device.type == "cuda" and (x.data_ptr() % 16 or y.data_ptr() % 16):
        raise ValueError("inputs must be 16-byte aligned")


def matmul_kernel(x: torch.Tensor, y: torch.Tensor, *, bm: int, bn: int,
                  bk: int, out_dtype: torch.dtype | None = None
                  ) -> torch.Tensor:
    """C = x @ y with tiles (bm, bn, bk): the CUDA kernel for CUDA tensors,
    ``matmul_plain`` for CPU tensors (after the same argument checks)."""
    out_dtype = out_dtype or x.dtype
    _check(x, y, bm, bn, bk, out_dtype)
    if x.device.type == "cpu":
        return matmul_plain(x, y, out_dtype)
    m, k = x.shape
    n = y.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib().klaraptor_matmul(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k, bm, bn, bk,
            _DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype], stream)
    if rc:
        _raise_cuda("matmul kernel launch", rc)
    LAUNCHES.count += 1
    return out
