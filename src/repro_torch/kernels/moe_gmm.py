"""Grouped (expert) matmul: the hand-written CUDA kernel's wrapper and its
plain version.

``moe_gmm_kernel`` launches ``csrc/moe_gmm.cu`` (the Hopper port of the JAX
package's ``moe_gmm_pallas``) with launch parameters (bg, bn, bk): a grid of
e x (g / bg) x (n / bn) CTAs, each looping over k in steps of bk.  x (e, g,
k) and w (e, k, n) are bf16 or f32 of one type, accumulation is f32 and out
(e, g, n) has x's type: the capacity-padded per-expert product of an MoE
layer.  bf16 runs the wgmma + TMA-ring mainloop of ``csrc/gemm_sm90.cuh``
with the expert on blockIdx.z: 2 * bg threads and only the compiled tiles
``SM90_TILES``.  f32 runs the SIMT mainloop of ``csrc/gemm_simt.cuh`` the
f32 matmul runs too, with the expert on blockIdx.z: (bg / 8) * (bn / 8)
threads and a cp.async ring of ``SIMT_STAGES`` slots.

``moe_gmm_plain`` computes the same function in plain PyTorch, per expert in
f32 as a sum of outer products over chunks of k.  The tests use it, and the
wrapper takes it only for tensors on the CPU; a CUDA tensor launches the
kernel or raises.  ``LAUNCHES.count`` counts kernel launches and nothing
else; ``LAUNCHES.tiles[(e, g, k, n)]`` holds the (bg, bn, bk) of the last
launch at that (padded) shape.  ``moe_gmm_launch`` states a launch in
numbers for introspection (``repro_torch.introspect``), ``MOE_GMM`` bundles
it with the wrapper.

``moe_gmm_backward_kernel`` gives (dx, dw) from x, w and the output's
gradient dy: dx[e] = dy[e] w[e]^T and dw[e] = x[e]^T dy[e], each at its own
tiles.  bf16 runs both on the wgmma mainloop with the transposed operand
read in place (``csrc/moe_gmm.cu``'s backward, the layouts ``LAYOUTS``); f32
runs the SIMT mainloop on transposed contiguous copies.  Its plain version
is ``moe_gmm_backward_plain``.  ``BACKWARD_LAUNCHES`` counts calls (one call
makes both products) and keeps the tiles of each product at each shape.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.kernel_spec import (MATMUL_MICRO_TILE, MATMUL_REGS_PER_THREAD,
                                SIMT_GRANULE, SM90_GRANULE,
                                SM90_REGS_PER_THREAD, SM90_TILES,
                                simt_smem_bytes, sm90_smem_bytes)
from ..introspect.trace import CudaKernel, LaunchDescription
from ._build import load
from .matmul import LaunchCounter, simt_operands, sm90_operands

__all__ = ["BACKWARD_LAUNCHES", "DTYPES", "LAUNCHES", "LAYOUTS", "MOE_GMM",
           "kernel_attributes", "moe_gmm_backward_kernel",
           "moe_gmm_backward_plain", "moe_gmm_kernel", "moe_gmm_launch",
           "moe_gmm_plain", "tile_attributes"]

DTYPES = (torch.float32, torch.bfloat16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

MAX_THREADS = 512       # the SIMT body's __launch_bounds__
SMEM_LIMIT = 232448     # dynamic shared memory a block may opt in to
MAX_GRID_YZ = 65535
_PLAIN_CHUNK_ELEMS = 1 << 24   # f32 elements of one outer-product chunk

# gemm_sm90.cuh's operand layouts: the forward, dX (w read as its
# transpose), dW (x read as its transpose)
LAYOUTS = {"forward": 0, "dx": 1, "dw": 2}

LAUNCHES = LaunchCounter()
BACKWARD_LAUNCHES = LaunchCounter()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load("moe_gmm")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.klaraptor_moe_gmm.argtypes = [vp, vp, vp, i, i, i, i, i, i, i, i, vp]
    lib.klaraptor_moe_gmm.restype = i
    ip = ctypes.POINTER(ctypes.c_int)
    lib.klaraptor_moe_gmm_attributes.argtypes = [i, ip, ip, ip]
    lib.klaraptor_moe_gmm_attributes.restype = i
    lib.klaraptor_moe_gmm_tile_attributes.argtypes = [i, i, i, i, ip, ip]
    lib.klaraptor_moe_gmm_tile_attributes.restype = i
    lib.klaraptor_moe_gmm_backward.argtypes = [vp] * 5 + [i] * 10 + [vp]
    lib.klaraptor_moe_gmm_backward.restype = i
    lib.klaraptor_moe_gmm_error_string.argtypes = [i]
    lib.klaraptor_moe_gmm_error_string.restype = ctypes.c_char_p
    return lib


def _raise_cuda(what: str, rc: int) -> None:
    msg = _lib().klaraptor_moe_gmm_error_string(rc).decode()
    raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


def kernel_attributes(dtype: torch.dtype) -> dict[str, int]:
    """Registers per thread, thread limit and spilled local bytes of the
    kernel compiled for ``dtype`` (builds it if needed); for bf16 the
    largest over the compiled wgmma tiles."""
    vals = [ctypes.c_int() for _ in range(3)]
    rc = _lib().klaraptor_moe_gmm_attributes(
        _DTYPE_CODE[dtype], *[ctypes.byref(v) for v in vals])
    if rc:
        _raise_cuda("cudaFuncGetAttributes", rc)
    return dict(zip(("num_regs", "max_threads", "local_bytes"),
                    (v.value for v in vals)))


def tile_attributes(bg: int, bn: int, bk: int,
                    layout: str = "forward") -> dict[str, int]:
    """Registers per thread and spilled local bytes of the bf16 wgmma
    instantiation of tile (bg, bn, bk) in ``layout`` (a key of
    ``LAYOUTS``)."""
    vals = [ctypes.c_int() for _ in range(2)]
    rc = _lib().klaraptor_moe_gmm_tile_attributes(
        bg, bn, bk, LAYOUTS[layout], *[ctypes.byref(v) for v in vals])
    if rc:
        _raise_cuda(f"attributes of tile {(bg, bn, bk)}", rc)
    return dict(zip(("num_regs", "local_bytes"), (v.value for v in vals)))


def moe_gmm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x[e, g, k] @ w[e, k, n] in plain PyTorch: f32 accumulation per
    expert, cast to x's type at the end.

    Sums outer products over chunks of k, so no library matmul is called;
    chunks are sized to keep the (e, g, chunk, n) product under 64 MB.
    """
    e, g, k = x.shape
    n = w.shape[2]
    xf, wf = x.float(), w.float()
    acc = torch.zeros((e, g, n), dtype=torch.float32, device=x.device)
    chunk = max(1, _PLAIN_CHUNK_ELEMS // max(e * g * n, 1))
    for l0 in range(0, k, chunk):
        l1 = min(l0 + chunk, k)
        if l1 - l0 == 1:
            acc.addcmul_(xf[:, :, l0:l1], wf[:, l0:l1, :])
        else:
            acc += (xf[:, :, l0:l1, None] * wf[:, None, l0:l1, :]).sum(2)
    return acc.to(x.dtype)


def moe_gmm_launch(args, *, bg: int, bn: int, bk: int) -> LaunchDescription:
    """The launch ``moe_gmm_kernel`` makes on tensors of the ``(shape,
    dtype)`` pairs ``args`` = (x, w): grid (e, g / bg, n / bn), a loop over
    k / bk, x and w tiles staged in shared memory; per expert the launch
    ``matmul_launch`` states, wgmma for bf16 and the SIMT ring for f32.
    Arithmetic only."""
    (xs, dt), (ws, _) = args
    e, g, k = xs
    n = ws[2]
    grid = (e, -(-g // bg), -(-n // bn))
    if dt == torch.bfloat16:
        return LaunchDescription(
            grid=grid, loops=(-(-k // bk),), threads=2 * bg,
            smem_bytes=sm90_smem_bytes(bg, bn, bk),
            operands=sm90_operands(((0, 1, 3), (0, 2, 3), (0, 1, 2)), (1,),
                                   bg, bn, bk, dt, dt),
            flops=2.0 * e * g * n * k, dtype=dt, granule=SM90_GRANULE,
            compute_unit="bf16")
    return LaunchDescription(
        grid=grid, loops=(-(-k // bk),),
        threads=(bg // MATMUL_MICRO_TILE) * (bn // MATMUL_MICRO_TILE),
        smem_bytes=simt_smem_bytes(bg, bn, bk),
        operands=simt_operands(((0, 1, 3), (0, 2, 3), (0, 1, 2)), (1,), bg,
                               bn, bk, dt, dt),
        flops=2.0 * e * g * n * k, dtype=dt, granule=SIMT_GRANULE)


def _check(x: torch.Tensor, w: torch.Tensor, bg: int, bn: int,
           bk: int) -> None:
    """Raise ValueError on anything the kernel does not take."""
    if x.ndim != 3 or w.ndim != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"moe_gmm takes x (e, g, k) and w (e, k, n); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in DTYPES:
        raise ValueError(f"moe_gmm takes two inputs of one dtype in "
                         f"{DTYPES}; got {x.dtype} and {w.dtype}")
    if x.device != w.device or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"inputs must share one cpu or cuda device; got "
                         f"{x.device} and {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("moe_gmm takes contiguous inputs")
    _check_tiles(*x.shape, w.shape[2], x.dtype, bg, bn, bk)
    if x.device.type == "cuda" and (x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError("inputs must be 16-byte aligned")


def _check_tiles(e: int, g: int, k: int, n: int, dtype: torch.dtype,
                 bg: int, bn: int, bk: int) -> None:
    """Raise ValueError on tiles (bg, bn, bk) the kernel does not take for
    the product (e, g, k) @ (e, k, n) in ``dtype``."""
    sm90 = dtype == torch.bfloat16
    granule = SM90_GRANULE if sm90 else SIMT_GRANULE
    for name, t, size in (("bg", bg, g), ("bn", bn, n), ("bk", bk, k)):
        if not isinstance(t, int) or t <= 0 or t % granule:
            raise ValueError(f"{name}={t!r} must be a positive multiple "
                             f"of {granule}")
        if size % t:
            raise ValueError(f"{name}={t} does not divide {size}")
    if sm90 and (bg, bn, bk) not in SM90_TILES:
        raise ValueError(f"tile {(bg, bn, bk)} is not compiled for bf16; "
                         f"the wgmma kernel has {SM90_TILES}")
    d = moe_gmm_launch((((e, g, k), dtype), ((e, k, n), dtype)),
                       bg=bg, bn=bn, bk=bk)
    if d.threads > MAX_THREADS:
        raise ValueError(f"bg * bn / 64 = {d.threads} threads exceeds the "
                         f"kernel's {MAX_THREADS}")
    if d.smem_bytes > SMEM_LIMIT:
        raise ValueError(f"tile {(bg, bn, bk)} needs {d.smem_bytes} bytes "
                         f"of shared memory for its ring, more than the "
                         f"{SMEM_LIMIT} a block can have")
    # SIMT: (n / bn, g / bg, e) on (x, y, z); wgmma: (g / bg, n / bn, e)
    yz = (d.grid[0], d.grid[2]) if sm90 else d.grid[:2]
    if max(yz) > MAX_GRID_YZ \
            or max(e * g * k, e * k * n, e * g * n) >= 2**31:
        raise ValueError(f"shape ({e}, {g}, {n}, {k}) exceeds the launch "
                         f"grid")


def moe_gmm_kernel(x: torch.Tensor, w: torch.Tensor, *, bg: int, bn: int,
                   bk: int) -> torch.Tensor:
    """out[e] = x[e] @ w[e] with tiles (bg, bn, bk): the CUDA kernel for
    CUDA tensors, ``moe_gmm_plain`` for CPU tensors (after the same
    argument checks)."""
    _check(x, w, bg, bn, bk)
    if x.device.type == "cpu":
        return moe_gmm_plain(x, w)
    out = _launch(x, w, bg, bn, bk)
    LAUNCHES.launched((*x.shape, w.shape[2]), bg=bg, bn=bn, bk=bk)
    return out


def _launch(x: torch.Tensor, w: torch.Tensor, bg: int, bn: int,
            bk: int) -> torch.Tensor:
    e, g, k = x.shape
    n = w.shape[2]
    out = torch.empty((e, g, n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib().klaraptor_moe_gmm(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), e, g, n, k, bg, bn,
            bk, _DTYPE_CODE[x.dtype], stream)
    if rc:
        _raise_cuda("moe_gmm kernel launch", rc)
    return out


def moe_gmm_backward_plain(x: torch.Tensor, w: torch.Tensor,
                           dy: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of out = x @ w in plain PyTorch: dx = dy w^T in x's type and
    dw = x^T dy in w's, each as ``moe_gmm_plain`` computes a product."""
    return (moe_gmm_plain(dy, w.transpose(1, 2)).to(x.dtype),
            moe_gmm_plain(x.transpose(1, 2), dy).to(w.dtype))


def moe_gmm_backward_kernel(x: torch.Tensor, w: torch.Tensor,
                            dy: torch.Tensor, *, dx_tiles: dict,
                            dw_tiles: dict
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of out[e] = x[e] @ w[e] from dy (e, g, n): the CUDA kernels
    for CUDA tensors, ``moe_gmm_backward_plain`` for CPU tensors (after the
    same checks).  ``dx_tiles`` (bg, bn, bk) tile dx = dy w^T over (g, k, n)
    and ``dw_tiles`` dw = x^T dy over (k, n, g)."""
    if x.ndim != 3 or w.ndim != 3 or dy.ndim != 3 \
            or x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1] \
            or tuple(dy.shape) != (x.shape[0], x.shape[1], w.shape[2]):
        raise ValueError(f"the grouped matmul's backward takes x (e, g, k), "
                         f"w (e, k, n) and dy (e, g, n); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(dy.shape)}")
    if not (x.dtype == w.dtype == dy.dtype) or x.dtype not in DTYPES:
        raise ValueError(f"x, w, dy must share one dtype in {DTYPES}; got "
                         f"{x.dtype}, {w.dtype}, {dy.dtype}")
    tensors = (x, w, dy)
    if len({t.device for t in tensors}) != 1 \
            or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"x, w, dy must share one cpu or cuda device; got "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the grouped matmul's backward takes contiguous "
                         "inputs")
    e, g, k = x.shape
    n = w.shape[2]
    _check_tiles(e, g, n, k, x.dtype, **dx_tiles)
    _check_tiles(e, k, g, n, x.dtype, **dw_tiles)
    dx_t, dw_t = (tuple(t[p] for p in ("bg", "bn", "bk"))
                  for t in (dx_tiles, dw_tiles))
    if x.device.type == "cpu":
        return moe_gmm_backward_plain(x, w, dy)
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("x, w, dy must be 16-byte aligned")
    if x.dtype == torch.float32:
        dx = _launch(dy, w.transpose(1, 2).contiguous(), **dx_tiles)
        dw = _launch(x.transpose(1, 2).contiguous(), dy, **dw_tiles)
    else:
        dx = torch.empty_like(x)
        dw = torch.empty_like(w)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = _lib().klaraptor_moe_gmm_backward(
                x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                dw.data_ptr(), e, g, n, k, *dx_t, *dw_t, stream)
        if rc:
            _raise_cuda("moe_gmm backward launch", rc)
    BACKWARD_LAUNCHES.launched((e, g, k, n), dx=dx_t, dw=dw_t)
    return dx, dw


MOE_GMM = CudaKernel(source="moe_gmm", describe=moe_gmm_launch,
                     launch=moe_gmm_kernel, attributes=kernel_attributes,
                     regs_cap={torch.float32: MATMUL_REGS_PER_THREAD,
                               torch.bfloat16: SM90_REGS_PER_THREAD})
