"""Blocked column sum: the hand-written CUDA kernel's wrapper, its plain
version, and its tunable interface -- auto-specced, no hand spec.

out[j] = sum_i x[i, j] in f32 for x (r, c) in bf16 or f32.
``colsum_kernel`` launches ``csrc/colsum.cu`` (the Hopper port of the JAX
package's ``colsum_pallas``) with launch parameters (br, bc): a grid of
(c / bc, r / br) CTAs of bc threads, each summing br rows of bc columns.
The kernel is bound by bytes, so the row tile -- which the TPU kernel
walked on one core -- is spread over CTAs to put bytes in flight on every
SM.  Each CTA writes its bc partial sums to an f32 workspace (r / br, c)
that the wrapper allocates, and the last CTA of a column block to finish
(an integer ticket per block, kept zeroed between launches on one stream)
adds them in row-split order and writes the output once: one launch, no
float atomics, the same bits on every run.  The output is ``(c,)``, not the
TPU kernel's (8, c) sublane plane of which the JAX op takes row 0.

No KernelSpec exists for this kernel anywhere: ``repro_torch.introspect``
derives it from the launch this module describes (``colsum_launch``, the
workspace among its operands) and the compiled kernel's registers, and
``ops.blocked_colsum`` dispatches through the derived spec.
``colsum_plain`` computes the same function in plain PyTorch; the wrapper
takes it only for tensors on the CPU, a CUDA tensor launches the kernel or
raises.  ``LAUNCHES.count`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..introspect.gridspec import GridSpec
from ..introspect.trace import CudaKernel, LaunchDescription, OperandLaunch
from ._build import load
from ._workspace import zeroed_ints
from .matmul import LaunchCounter

__all__ = ["COLSUM", "COLSUM_LANES", "COLSUM_REGS_PER_THREAD", "DTYPES",
           "LAUNCHES", "colsum_grid_spec", "colsum_kernel", "colsum_launch",
           "colsum_plain", "colsum_split_order", "kernel_attributes"]

DTYPES = (torch.float32, torch.bfloat16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

GRANULE = 8                     # columns per thread
COLSUM_LANES = 8                # row lanes per CTA
COLSUM_REGS_PER_THREAD = 64     # __launch_bounds__(1024)
MAX_THREADS = 1024
MAX_GRID_Y = 65535

LAUNCHES = LaunchCounter()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load("colsum")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.klaraptor_colsum.argtypes = [vp, vp, vp, vp, i, i, i, i, i, vp]
    lib.klaraptor_colsum.restype = i
    ip = ctypes.POINTER(ctypes.c_int)
    lib.klaraptor_colsum_attributes.argtypes = [i, ip, ip, ip]
    lib.klaraptor_colsum_attributes.restype = i
    lib.klaraptor_colsum_error_string.argtypes = [i]
    lib.klaraptor_colsum_error_string.restype = ctypes.c_char_p
    return lib


def _raise_cuda(what: str, rc: int) -> None:
    msg = _lib().klaraptor_colsum_error_string(rc).decode()
    raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


def kernel_attributes(dtype: torch.dtype) -> dict[str, int]:
    """Registers per thread, thread limit and spilled local bytes of the
    kernel compiled for ``dtype`` (builds it if needed)."""
    vals = [ctypes.c_int() for _ in range(3)]
    rc = _lib().klaraptor_colsum_attributes(
        _DTYPE_CODE[dtype], *[ctypes.byref(v) for v in vals])
    if rc:
        _raise_cuda("cudaFuncGetAttributes", rc)
    return dict(zip(("num_regs", "max_threads", "local_bytes"),
                    (v.value for v in vals)))


def colsum_plain(x: torch.Tensor) -> torch.Tensor:
    """Column sums of an (r, c) tensor in f32 (the JAX package's
    ``colsum_ref``)."""
    return x.float().sum(dim=0)


def colsum_split_order(x: torch.Tensor, br: int) -> torch.Tensor:
    """Column sums in the kernel's two-level order: the f32 sum of each
    split of br rows, then the splits added one by one in row-split order
    (what the kernel's last CTA of a column block does)."""
    r, c = x.shape
    parts = x.float().reshape(r // br, br, c).sum(dim=1)
    total = torch.zeros(c, dtype=torch.float32, device=x.device)
    for k in range(parts.shape[0]):
        total = total + parts[k]
    return total


def colsum_launch(args, *, br: int, bc: int) -> LaunchDescription:
    """The launch ``colsum_kernel`` makes on a tensor of the ``(shape,
    dtype)`` pair ``args`` = (x,): grid (c / bc, r / br) and no loop; each
    CTA writes its (bc,) f32 partial sums to the workspace, which the last
    CTA of its column block reads back (so the partials are one output and
    one input tile per CTA); the output is written once per column block;
    an (8, bc) f32 scratch tile in shared memory.  Arithmetic only."""
    ((xs, dt),) = args
    r, c = xs
    return LaunchDescription(
        grid=(-(-c // bc), -(-r // br)),
        loops=(),
        threads=bc,
        smem_bytes=COLSUM_LANES * bc * 4,
        operands=(
            OperandLaunch((br, bc), (0, 1), dt),
            OperandLaunch((bc,), (0, 1), torch.float32, is_output=True),
            OperandLaunch((bc,), (0, 1), torch.float32),
            OperandLaunch((bc,), (0,), torch.float32, is_output=True),
            OperandLaunch((COLSUM_LANES, bc), (), torch.float32,
                          scratch=True),
        ),
        flops=float(r * c),
        dtype=dt,
    )


def _check(x: torch.Tensor, br: int, bc: int) -> None:
    """Raise ValueError on anything the kernel does not take."""
    if x.ndim != 2:
        raise ValueError(f"colsum takes x (r, c); got {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise ValueError(f"colsum takes x in {DTYPES}, not {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"x must be on a cpu or cuda device, not "
                         f"{x.device}")
    if not x.is_contiguous():
        raise ValueError("colsum takes a contiguous x")
    r, c = x.shape
    if not isinstance(br, int) or br <= 0 or r % br:
        raise ValueError(f"br={br!r} must be a positive divisor of {r}")
    if not isinstance(bc, int) or bc <= 0 or bc % GRANULE or c % bc:
        raise ValueError(f"bc={bc!r} must be a positive multiple of "
                         f"{GRANULE} dividing {c}")
    d = colsum_launch((((r, c), x.dtype),), br=br, bc=bc)
    if d.threads > MAX_THREADS:
        raise ValueError(f"bc={bc} threads exceeds the kernel's "
                         f"{MAX_THREADS}")
    if r // br > MAX_GRID_Y or r * c >= 2**31:
        raise ValueError(f"shape ({r}, {c}) exceeds the kernel's limits")
    if x.device.type == "cuda" and x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")


def colsum_kernel(x: torch.Tensor, *, br: int, bc: int) -> torch.Tensor:
    """Column sums of x (r, c) as (c,) f32 with tiles (br, bc): the CUDA
    kernel for CUDA tensors, ``colsum_plain`` for CPU tensors (after the
    same argument checks)."""
    _check(x, br, bc)
    if x.device.type == "cpu":
        return colsum_plain(x)
    r, c = x.shape
    out = torch.empty(c, dtype=torch.float32, device=x.device)
    part = torch.empty(r // br, c, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        tickets = zeroed_ints(x.device, stream, c // bc)
        rc = _lib().klaraptor_colsum(x.data_ptr(), out.data_ptr(),
                                     part.data_ptr(), tickets.data_ptr(), r,
                                     c, br, bc, _DTYPE_CODE[x.dtype], stream)
    if rc:
        _raise_cuda("colsum kernel launch", rc)
    LAUNCHES.count += 1
    return out


def colsum_grid_spec(dtype_bytes: int = 2) -> GridSpec:
    """Tunable-interface declaration for ``spec_from_kernel`` (the
    reference's candidates and defaults; probe hints of the port's own)."""
    dt = torch.bfloat16 if dtype_bytes == 2 else torch.float32
    return GridSpec(
        name=f"colsum_b{dtype_bytes * 8}",
        data_params=("r", "c"),
        program_params=("br", "bc"),
        make_args=lambda D: (((D["r"], D["c"]), dt),),
        param_candidates={
            "br": (8, 16, 32, 64, 128, 256, 512, 1024, 2048),
            "bc": (128, 256, 512, 1024, 2048),
        },
        # Rows from 512 to 8192, so the fit sees launches of one row split
        # (r 512, br 512) up to 1024 (r 8192, br 8), and up to 16384
        # columns, so it sees one column block and many.
        probe_hints={"r": (512, 2048, 8192), "c": (1024, 2048, 16384)},
        defaults={"br": 256, "bc": 512},
    )


COLSUM = CudaKernel(source="colsum", describe=colsum_launch,
                    launch=colsum_kernel, attributes=kernel_attributes,
                    regs_cap=COLSUM_REGS_PER_THREAD)
