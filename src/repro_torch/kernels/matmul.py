"""Tiled matmul: the hand-written CUDA kernel's wrapper and its plain version.

``matmul_kernel`` launches ``csrc/matmul.cu`` (the Hopper port of the JAX
package's ``matmul_pallas``) with launch parameters (bm, bn, bk): a grid of
(m / bm) x (n / bn) CTAs, each looping over k in steps of bk.  Inputs are
bf16 or f32, accumulation is f32, and the result is cast to ``out_dtype``
(bf16, f16 or f32).  bf16 runs the wgmma + TMA-ring mainloop of
``csrc/gemm_sm90.cuh``: 2 * bm threads, a ring of ``SM90_STAGES`` slots, and
only the compiled tiles ``SM90_TILES``.  f32 runs the SIMT mainloop of
``csrc/gemm_simt.cuh``: (bm / 8) * (bn / 8) threads, a cp.async ring of
``SIMT_STAGES`` slots, any 8-granular tile within the thread and
shared-memory limits.

``matmul_plain`` computes the same function in plain PyTorch, accumulating
in f32 as a sum of outer products over k.  The tests use it, and the wrapper
takes it only for tensors on the CPU; a CUDA tensor launches the kernel or
raises.  ``LAUNCHES.count`` counts kernel launches and nothing else.
``matmul_launch`` states a launch in numbers for introspection
(``repro_torch.introspect``), ``MATMUL`` bundles it with the wrapper.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.kernel_spec import (MATMUL_MICRO_TILE, MATMUL_REGS_PER_THREAD,
                                SIMT_GRANULE, SIMT_PAD, SIMT_STAGES,
                                SM90_GRANULE, SM90_REGS_PER_THREAD,
                                SM90_SMEM_EXTRA, SM90_STAGES, SM90_TILES,
                                simt_smem_bytes, sm90_smem_bytes)
from ..introspect.trace import CudaKernel, LaunchDescription, OperandLaunch
from ._build import load

__all__ = ["IN_DTYPES", "LAUNCHES", "MATMUL", "OUT_DTYPES", "LaunchCounter",
           "kernel_attributes", "matmul_kernel", "matmul_launch",
           "matmul_plain", "simt_operands", "sm90_operands",
           "tile_attributes"]

IN_DTYPES = (torch.float32, torch.bfloat16)
OUT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

MAX_THREADS = 512       # the SIMT body's __launch_bounds__
SMEM_LIMIT = 232448     # dynamic shared memory a block may opt in to
MAX_GRID_Y = 65535
_PLAIN_CHUNK_ELEMS = 1 << 24   # f32 elements of one outer-product chunk


class LaunchCounter:
    """How many times a kernel was launched (``count``, a plain int), and,
    for a kernel that records them, the tiles (and, for a kernel with two
    bodies, the body) of its last launch at each shape (``tiles``, keyed as
    the kernel's wrapper keys them)."""

    def __init__(self) -> None:
        self.count = 0
        self.tiles: dict[tuple, dict[str, int | str]] = {}

    def reset(self) -> None:
        self.count = 0
        self.tiles.clear()

    def launched(self, shape: tuple, **tiles: int | str) -> None:
        """Count one launch, made at ``shape`` with ``tiles``."""
        self.count += 1
        self.tiles[shape] = tiles


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
    lib.klaraptor_matmul_tile_attributes.argtypes = [i, i, i, ip, ip]
    lib.klaraptor_matmul_tile_attributes.restype = i
    lib.klaraptor_error_string.argtypes = [i]
    lib.klaraptor_error_string.restype = ctypes.c_char_p
    return lib


def _raise_cuda(what: str, rc: int) -> None:
    msg = _lib().klaraptor_error_string(rc).decode()
    raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


def kernel_attributes(dtype: torch.dtype) -> dict[str, int]:
    """Registers per thread, thread limit and spilled local bytes of the
    kernel compiled for ``dtype`` in and out (builds it if needed); for
    bf16 the largest over the compiled wgmma tiles."""
    vals = [ctypes.c_int() for _ in range(3)]
    rc = _lib().klaraptor_matmul_attributes(
        _DTYPE_CODE[dtype], *[ctypes.byref(v) for v in vals])
    if rc:
        _raise_cuda("cudaFuncGetAttributes", rc)
    return dict(zip(("num_regs", "max_threads", "local_bytes"),
                    (v.value for v in vals)))


def tile_attributes(bm: int, bn: int, bk: int) -> dict[str, int]:
    """Registers per thread and spilled local bytes of the bf16 wgmma
    instantiation of tile (bm, bn, bk)."""
    vals = [ctypes.c_int() for _ in range(2)]
    rc = _lib().klaraptor_matmul_tile_attributes(
        bm, bn, bk, *[ctypes.byref(v) for v in vals])
    if rc:
        _raise_cuda(f"attributes of tile {(bm, bn, bk)}", rc)
    return dict(zip(("num_regs", "local_bytes"), (v.value for v in vals)))


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


def sm90_operands(deps: tuple[tuple[int, ...], ...], batch: tuple[int, ...],
                  rows: int, bn: int, bk: int, dt: torch.dtype,
                  out_dt: torch.dtype) -> tuple[OperandLaunch, ...]:
    """The operands of a bf16 wgmma launch: x, y and the output (their axis
    dependences ``deps``, their tiles led by ``batch``), then the ring's
    other SM90_STAGES - 1 slots and its barriers as shared-memory scratch."""
    ring = SM90_STAGES - 1
    return (
        OperandLaunch((*batch, rows, bk), deps[0], dt, staged=True),
        OperandLaunch((*batch, bk, bn), deps[1], dt, staged=True),
        OperandLaunch((*batch, rows, bn), deps[2], out_dt, is_output=True),
        OperandLaunch((ring, rows, bk), (), dt, scratch=True),
        OperandLaunch((ring, bk, bn), (), dt, scratch=True),
        OperandLaunch((SM90_SMEM_EXTRA,), (), torch.uint8, scratch=True),
    )


def simt_operands(deps: tuple[tuple[int, ...], ...], batch: tuple[int, ...],
                  rows: int, bn: int, bk: int, dt: torch.dtype,
                  out_dt: torch.dtype) -> tuple[OperandLaunch, ...]:
    """The operands of an f32 SIMT launch: x, y and the output (their axis
    dependences ``deps``, their tiles led by ``batch``), then the ring's
    other SIMT_STAGES - 1 slots and every slot's x-row padding as
    shared-memory scratch."""
    ring = SIMT_STAGES - 1
    return (
        OperandLaunch((*batch, rows, bk), deps[0], dt, staged=True),
        OperandLaunch((*batch, bk, bn), deps[1], dt, staged=True),
        OperandLaunch((*batch, rows, bn), deps[2], out_dt, is_output=True),
        OperandLaunch((ring, rows, bk), (), dt, scratch=True),
        OperandLaunch((ring, bk, bn), (), dt, scratch=True),
        OperandLaunch((SIMT_STAGES, rows, SIMT_PAD), (), dt, scratch=True),
    )


def matmul_launch(args, *, bm: int, bn: int, bk: int,
                  out_dtype: torch.dtype | None = None) -> LaunchDescription:
    """The launch ``matmul_kernel`` makes on tensors of the ``(shape,
    dtype)`` pairs ``args`` = (x, y): grid (m / bm, n / bn), a loop over
    k / bk, x and y tiles staged in shared memory.  bf16: 2 * bm threads on
    the tensor cores, the ring of SM90_STAGES slots in shared memory, tiles
    in multiples of 64.  f32: (bm / 8) * (bn / 8) threads of FP32 FMAs, the
    cp.async ring of SIMT_STAGES padded slots in shared memory, tiles in
    multiples of 8.  Arithmetic only."""
    (xs, dt), (ys, _) = args
    m, k = xs
    n = ys[1]
    grid = (-(-m // bm), -(-n // bn))
    if dt == torch.bfloat16:
        return LaunchDescription(
            grid=grid, loops=(-(-k // bk),), threads=2 * bm,
            smem_bytes=sm90_smem_bytes(bm, bn, bk),
            operands=sm90_operands(((0, 2), (1, 2), (0, 1)), (), bm, bn, bk,
                                   dt, out_dtype or dt),
            flops=2.0 * m * n * k, dtype=dt, granule=SM90_GRANULE,
            compute_unit="bf16")
    return LaunchDescription(
        grid=grid, loops=(-(-k // bk),),
        threads=(bm // MATMUL_MICRO_TILE) * (bn // MATMUL_MICRO_TILE),
        smem_bytes=simt_smem_bytes(bm, bn, bk),
        operands=simt_operands(((0, 2), (1, 2), (0, 1)), (), bm, bn, bk, dt,
                               out_dtype or dt),
        flops=2.0 * m * n * k, dtype=dt, granule=SIMT_GRANULE)


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
    sm90 = x.dtype == torch.bfloat16
    granule = SM90_GRANULE if sm90 else SIMT_GRANULE
    for name, t, size in (("bm", bm, m), ("bn", bn, n), ("bk", bk, k)):
        if not isinstance(t, int) or t <= 0 or t % granule:
            raise ValueError(f"{name}={t!r} must be a positive multiple "
                             f"of {granule}")
        if size % t:
            raise ValueError(f"{name}={t} does not divide {size}")
    if sm90 and (bm, bn, bk) not in SM90_TILES:
        raise ValueError(f"tile {(bm, bn, bk)} is not compiled for bf16; "
                         f"the wgmma kernel has {SM90_TILES}")
    d = matmul_launch((((m, k), x.dtype), ((k, n), y.dtype)), bm=bm, bn=bn,
                      bk=bk, out_dtype=out_dtype)
    if d.threads > MAX_THREADS:
        raise ValueError(f"bm * bn / 64 = {d.threads} threads exceeds the "
                         f"kernel's {MAX_THREADS}")
    if d.smem_bytes > SMEM_LIMIT:
        raise ValueError(f"tile {(bm, bn, bk)} needs {d.smem_bytes} bytes "
                         f"of shared memory for its ring, more than the "
                         f"{SMEM_LIMIT} a block can have")
    # grid.y holds m / bm in the SIMT body, n / bn in the wgmma body
    if d.grid[1 if sm90 else 0] > MAX_GRID_Y or max(m, n, k) >= 2**31:
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


MATMUL = CudaKernel(source="matmul", describe=matmul_launch,
                    launch=matmul_kernel, attributes=kernel_attributes,
                    regs_cap={torch.float32: MATMUL_REGS_PER_THREAD,
                              torch.bfloat16: SM90_REGS_PER_THREAD})
