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
tiles.  bf16 runs both on ``csrc/gmm_bwd_sm90.cuh``, a persistent wgmma body
with the transposed operand read in place and a TMA-store epilogue, at the
(bm, bn, ctas, n_fast) of ``backward_tiles`` (its docstring states the
rule); f32 runs the SIMT mainloop on transposed contiguous copies.  Its
plain version is ``moe_gmm_backward_plain``.  ``BACKWARD_LAUNCHES`` counts
calls that launch (a call makes both products, or the one asked for) and
keeps the tiles of each product at each shape.
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

__all__ = ["BACKWARD_KEYS", "BACKWARD_LAUNCHES", "BACKWARD_SM90_TILES",
           "DTYPES", "LAUNCHES",
           "MOE_GMM", "backward_attributes", "backward_smem_bytes",
           "backward_tiles", "kernel_attributes", "moe_gmm_backward_kernel",
           "moe_gmm_backward_plain", "moe_gmm_kernel", "moe_gmm_launch",
           "moe_gmm_plain", "tile_attributes"]

DTYPES = (torch.float32, torch.bfloat16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

MAX_THREADS = 512       # the SIMT body's __launch_bounds__
SMEM_LIMIT = 232448     # dynamic shared memory a block may opt in to
MAX_GRID_YZ = 65535
_PLAIN_CHUNK_ELEMS = 1 << 24   # f32 elements of one outer-product chunk

# The bf16 backward body (csrc/gmm_bwd_sm90.cuh): its products, its compiled
# (bm, bn) tiles (GMM_BWD_SM90_TILES: 64 rows per consumer warpgroup, one to
# three; bn up to 256 but at three warpgroups), its k step, its ring's bound
# and its launch parameters; an expert's operand that the walk keeps in L2
# while the other streams should be at most a quarter of the H100's 50 MB.
PRODUCTS = {"dx": 1, "dw": 2}
BACKWARD_SM90_TILES = ((64, 64), (64, 128), (64, 256), (128, 64), (128, 128),
                       (128, 256), (192, 64), (192, 128))
BACKWARD_BK = 64
BACKWARD_MAX_STAGES = 6
BACKWARD_KEYS = ("bm", "bn", "ctas", "n_fast")
BACKWARD_L2_SHARE = 50 * 2**20 // 4
H100_SMS = 132          # streaming multiprocessors of an H100 SXM

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
    lib.klaraptor_moe_gmm_tile_attributes.argtypes = [i, i, i, ip, ip]
    lib.klaraptor_moe_gmm_tile_attributes.restype = i
    lib.klaraptor_moe_gmm_backward.argtypes = [i, vp, vp, vp] + [i] * 8 \
        + [vp]
    lib.klaraptor_moe_gmm_backward.restype = i
    lib.klaraptor_moe_gmm_backward_attributes.argtypes = [i, i, i, ip, ip, ip]
    lib.klaraptor_moe_gmm_backward_attributes.restype = i
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


def tile_attributes(bg: int, bn: int, bk: int) -> dict[str, int]:
    """Registers per thread and spilled local bytes of the bf16 wgmma
    instantiation of tile (bg, bn, bk)."""
    vals = [ctypes.c_int() for _ in range(2)]
    rc = _lib().klaraptor_moe_gmm_tile_attributes(
        bg, bn, bk, *[ctypes.byref(v) for v in vals])
    if rc:
        _raise_cuda(f"attributes of tile {(bg, bn, bk)}", rc)
    return dict(zip(("num_regs", "local_bytes"), (v.value for v in vals)))


def backward_attributes(product: str, bm: int, bn: int) -> dict[str, int]:
    """Registers per thread, spilled local bytes and dynamic shared memory
    of the bf16 backward body for ``product`` ("dx" or "dw") at tile (bm,
    bn)."""
    vals = [ctypes.c_int() for _ in range(3)]
    rc = _lib().klaraptor_moe_gmm_backward_attributes(
        PRODUCTS[product], bm, bn, *[ctypes.byref(v) for v in vals])
    if rc:
        _raise_cuda(f"attributes of backward {product} tile {(bm, bn)}", rc)
    return dict(zip(("num_regs", "local_bytes", "smem_bytes"),
                    (v.value for v in vals)))


def backward_smem_bytes(bm: int, bn: int) -> int:
    """Dynamic shared memory of the bf16 backward body at tile (bm, bn), as
    ``gmm_bwd_sm90::Tile`` counts it: as many ring slots of (bm + bn) x 64
    bf16 as fit beside one (64, bn) bf16 staging tile per warpgroup (at most
    ``BACKWARD_MAX_STAGES``), their barriers, and 1 KiB of alignment."""
    slot = (bm + bn) * BACKWARD_BK * 2
    staging = (bm // 64) * 64 * bn * 2
    fit = (SMEM_LIMIT - 1024 - staging - 16 * BACKWARD_MAX_STAGES) // slot
    stages = min(fit, BACKWARD_MAX_STAGES)
    return 1024 + stages * slot + staging + 16 * stages


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


def _product_dims(product: str, g: int, k: int, n: int
                  ) -> tuple[int, int, int]:
    """(M, N, K) of one backward product: dx = dy w^T is (g, k) over n,
    dw = x^T dy is (k, n) over g."""
    return (g, k, n) if product == "dx" else (k, n, g)


def backward_tiles(e: int, g: int, k: int, n: int,
                   sms: int = H100_SMS) -> dict[str, dict[str, int]]:
    """The bf16 backward body's launch parameters for x (e, g, k) and w (e,
    k, n), per product ("dx", "dw"), as {"bm", "bn", "ctas", "n_fast"}.
    The rule:

    * bm, the rows of a tile (64 per consumer warpgroup): for dx, whose rows
      are the capacity g, the largest of 192, 128, 64 that divides g -- at
      qwen3-moe's padded capacity (192) one tile covers every row, so each
      slab of w crosses HBM once; for dw, 128 where it divides k, else 64;
    * bn: the largest of 256, 128, 64 that divides the product's N (k for
      dx, n for dw) and is compiled beside bm (192 rows take at most 128);
    * n_fast: an expert's tiles are walked m tiles fastest (0), so the
      tiles that share one slab of the B operand run side by side while A's
      whole expert (K x M) stays in L2 -- unless that is more than
      ``BACKWARD_L2_SHARE`` and larger than B's (K x N): then n tiles
      fastest (1), keeping B's instead (grok-1's dw of the down product);
    * ctas: one persistent CTA per SM (``sms``; its ring and staging take
      more than half an SM's shared memory, and two CTAs an SM at smaller
      tiles were slower on the card), or one per tile where there are
      fewer (``_ctas``; the wrapper counts it again for the tile a caller
      asks for).
    """
    out = {}
    for product in PRODUCTS:
        m_, n_, k_ = _product_dims(product, g, k, n)
        bms = (192, 128, 64) if product == "dx" else (128, 64)
        bm = next((b for b in bms if m_ % b == 0), 64)
        bn = next((b for b in (256, 128, 64)
                   if n_ % b == 0 and (bm, b) in BACKWARD_SM90_TILES), 64)
        out[product] = {
            "bm": bm, "bn": bn, "ctas": _ctas(e, m_, n_, bm, bn, sms),
            "n_fast": int(m_ > n_ and 2 * k_ * m_ > BACKWARD_L2_SHARE)}
    return out


def _ctas(e: int, m: int, n: int, bm: int, bn: int, sms: int) -> int:
    """Persistent CTAs of a product (e, m, n) at tile (bm, bn): one an SM,
    or one per tile where there are fewer."""
    return max(1, min(e * -(-m // bm) * -(-n // bn), sms))


def _check_backward_tiles(e: int, g: int, k: int, n: int, product: str,
                          bm: int, bn: int, ctas: int, n_fast: int) -> None:
    """Raise ValueError on launch parameters the bf16 backward body does not
    take for ``product`` of x (e, g, k), w (e, k, n)."""
    m_, n_, k_ = _product_dims(product, g, k, n)
    if (bm, bn) not in BACKWARD_SM90_TILES:
        raise ValueError(f"backward {product} tile {(bm, bn)} is not "
                         f"compiled; the body has {BACKWARD_SM90_TILES}")
    if m_ % bm or n_ % bn or k_ % BACKWARD_BK:
        raise ValueError(f"backward {product} tile {(bm, bn)} does not "
                         f"divide its product ({m_}, {n_}) over k {k_} (a "
                         f"multiple of {BACKWARD_BK})")
    if not isinstance(ctas, int) or ctas < 1:
        raise ValueError(f"ctas={ctas!r} must be a positive int")
    if n_fast not in (0, 1):
        raise ValueError(f"n_fast={n_fast!r} must be 0 or 1")
    if max(e * g * k, e * k * n, e * g * n) >= 2**31:
        raise ValueError(f"shape ({e}, {g}, {n}, {k}) exceeds the kernel's "
                         f"32-bit indices")


def moe_gmm_backward_kernel(x: torch.Tensor, w: torch.Tensor,
                            dy: torch.Tensor, *, dx_tiles: dict | None = None,
                            dw_tiles: dict | None = None,
                            products: tuple = ("dx", "dw")
                            ) -> tuple[torch.Tensor | None,
                                       torch.Tensor | None]:
    """(dx, dw) of out[e] = x[e] @ w[e] from dy (e, g, n): the CUDA kernels
    for CUDA tensors, ``moe_gmm_backward_plain`` for CPU tensors (after the
    same checks).  bf16 tiles are {"bm", "bn", "ctas", "n_fast"} (each key
    not given is ``backward_tiles``'s), f32 tiles the SIMT body's {"bg",
    "bn", "bk"} (required): ``dx_tiles`` tile dx = dy w^T over (g, k, n) and
    ``dw_tiles`` dw = x^T dy over (k, n, g).  ``products`` names the
    products to compute (the other comes back None): timing and tests ask
    for one alone."""
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
    if not products or any(p not in PRODUCTS for p in products):
        raise ValueError(f"products={products!r} must name some of "
                         f"{tuple(PRODUCTS)}")
    e, g, k = x.shape
    n = w.shape[2]
    given = {"dx": dx_tiles, "dw": dw_tiles}
    if x.dtype == torch.float32:
        if dx_tiles is None or dw_tiles is None:
            raise ValueError("the f32 backward takes dx_tiles and dw_tiles "
                             "(bg, bn, bk) of the SIMT body")
        _check_tiles(e, g, n, k, x.dtype, **dx_tiles)
        _check_tiles(e, k, g, n, x.dtype, **dw_tiles)
        tiles = {p: tuple(t[q] for q in ("bg", "bn", "bk"))
                 for p, t in given.items()}
    else:
        sms = H100_SMS if x.device.type == "cpu" else \
            torch.cuda.get_device_properties(x.device).multi_processor_count
        rule = backward_tiles(e, g, k, n, sms)
        for p, t in given.items():
            unknown = set(t or ()) - set(BACKWARD_KEYS)
            if unknown:
                raise ValueError(f"bf16 backward {p} tiles take "
                                 f"{BACKWARD_KEYS}; got {sorted(unknown)}")
        tiles = {}
        for p in PRODUCTS:
            t = {**rule[p], **(given[p] or {})}
            if "ctas" not in (given[p] or {}):
                t["ctas"] = _ctas(e, *_product_dims(p, g, k, n)[:2],
                                  t["bm"], t["bn"], sms)
            tiles[p] = tuple(t[q] for q in BACKWARD_KEYS)
        for p in PRODUCTS:
            _check_backward_tiles(e, g, k, n, p, *tiles[p])
    if x.device.type == "cpu":
        dx, dw = moe_gmm_backward_plain(x, w, dy)
        return (dx if "dx" in products else None,
                dw if "dw" in products else None)
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("x, w, dy must be 16-byte aligned")
    dx = dw = None
    if x.dtype == torch.float32:
        if "dx" in products:
            dx = _launch(dy, w.transpose(1, 2).contiguous(),
                         *tiles["dx"])
        if "dw" in products:
            dw = _launch(x.transpose(1, 2).contiguous(), dy, *tiles["dw"])
    else:
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            if "dx" in products:
                dx = torch.empty_like(x)
                _launch_backward("dx", dy, w, dx, e, g, k, n, tiles["dx"],
                                 stream)
            if "dw" in products:
                dw = torch.empty_like(w)
                _launch_backward("dw", x, dy, dw, e, k, n, g, tiles["dw"],
                                 stream)
    BACKWARD_LAUNCHES.launched((e, g, k, n), **{p: tiles[p]
                                                for p in products})
    return dx, dw


def _launch_backward(product: str, a: torch.Tensor, b: torch.Tensor,
                     out: torch.Tensor, e: int, m: int, n: int, k: int,
                     tiles: tuple, stream: int) -> None:
    rc = _lib().klaraptor_moe_gmm_backward(
        PRODUCTS[product], a.data_ptr(), b.data_ptr(), out.data_ptr(), e, m,
        n, k, *tiles, stream)
    if rc:
        _raise_cuda(f"moe_gmm backward {product} launch", rc)


MOE_GMM = CudaKernel(source="moe_gmm", describe=moe_gmm_launch,
                     launch=moe_gmm_kernel, attributes=kernel_attributes,
                     regs_cap={torch.float32: MATMUL_REGS_PER_THREAD,
                               torch.bfloat16: SM90_REGS_PER_THREAD})
