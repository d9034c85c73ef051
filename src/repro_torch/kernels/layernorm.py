"""Fused layernorm + residual: the hand-written CUDA kernel's wrapper, its
plain version, and its tunable interface -- auto-specced, no hand spec.

y = (x - mean) / sqrt(var + eps) * gamma + beta + residual, normalised over
the feature axis in f32, out in x's type.  ``layernorm_kernel`` launches
``csrc/layernorm.cu`` (the Hopper port of the JAX package's
``layernorm_pallas``) with launch parameter ``br``, the rows of one CTA: a
grid of ceil(r / br) CTAs of 8 warps (the last block's rows past r are
masked, so br need not divide r), each warp normalising every eighth row of
its CTA's block, with gamma and beta staged once per CTA in shared memory.
The feature width ``c`` is a literal of the kernel instance, so the derived
spec is per-width: ``layernorm_c{c}_b{16|32}``.

No KernelSpec exists for this kernel anywhere: ``repro_torch.introspect``
derives it from the launch this module describes (``layernorm_launch``) and
the compiled kernel's registers, and ``ops.layernorm`` dispatches through the
derived spec.  ``layernorm_plain`` computes the same function in plain
PyTorch; the wrapper takes it only for tensors on the CPU, a CUDA tensor
launches the kernel or raises.  ``LAUNCHES.count`` counts kernel launches
and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..introspect.gridspec import GridSpec
from ..introspect.trace import CudaKernel, LaunchDescription, OperandLaunch
from ._build import load
from .matmul import LaunchCounter

__all__ = ["DTYPES", "LAUNCHES", "LAYERNORM", "LN_FLOPS_PER_ELEMENT",
           "LN_REGS_PER_THREAD", "LN_THREADS", "kernel_attributes",
           "layernorm_grid_spec", "layernorm_kernel", "layernorm_launch",
           "layernorm_plain"]

DTYPES = (torch.float32, torch.bfloat16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

LN_THREADS = 256            # 8 warps per CTA
LN_REGS_PER_THREAD = 64     # __launch_bounds__(256, 4)
# Per element: the mean's add; the centred square's subtract and FMA; the
# output's subtract, multiply, FMA with gamma and beta, and residual add.
LN_FLOPS_PER_ELEMENT = 9
SMEM_LIMIT = 232448         # dynamic shared memory a block may opt in to

LAUNCHES = LaunchCounter()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load("layernorm")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.klaraptor_layernorm.argtypes = [vp, vp, vp, vp, vp, i, i, i,
                                        ctypes.c_float, i, i, vp]
    lib.klaraptor_layernorm.restype = i
    ip = ctypes.POINTER(ctypes.c_int)
    lib.klaraptor_layernorm_attributes.argtypes = [i, ip, ip, ip]
    lib.klaraptor_layernorm_attributes.restype = i
    lib.klaraptor_layernorm_error_string.argtypes = [i]
    lib.klaraptor_layernorm_error_string.restype = ctypes.c_char_p
    return lib


def _raise_cuda(what: str, rc: int) -> None:
    msg = _lib().klaraptor_layernorm_error_string(rc).decode()
    raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


def kernel_attributes(dtype: torch.dtype) -> dict[str, int]:
    """Registers per thread, thread limit and spilled local bytes of the
    kernel compiled for ``dtype`` (builds it if needed)."""
    vals = [ctypes.c_int() for _ in range(3)]
    rc = _lib().klaraptor_layernorm_attributes(
        _DTYPE_CODE[dtype], *[ctypes.byref(v) for v in vals])
    if rc:
        _raise_cuda("cudaFuncGetAttributes", rc)
    return dict(zip(("num_regs", "max_threads", "local_bytes"),
                    (v.value for v in vals)))


def layernorm_plain(x: torch.Tensor, res: torch.Tensor, gamma: torch.Tensor,
                    beta: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The fused layernorm + residual in plain PyTorch, f32 math, out in
    x's type (the JAX package's ``layernorm_ref``)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    y = y * gamma.float() + beta.float()
    return (y + res.float()).to(x.dtype)


def layernorm_launch(args, *, br: int, eps: float = 1e-6
                     ) -> LaunchDescription:
    """The launch ``layernorm_kernel`` makes on tensors of the ``(shape,
    dtype)`` pairs ``args`` = (x, res, gamma, beta): grid ceil(r / br) with
    a masked (ragged) last block, no loop, gamma and beta staged as f32 and
    depending on no axis (fetched once per CTA).  Arithmetic only."""
    (xs, dt), _, _, _ = args
    r, c = xs
    return LaunchDescription(
        grid=(-(-r // br),),
        loops=(),
        threads=LN_THREADS,
        smem_bytes=2 * c * 4,
        operands=(
            OperandLaunch((br, c), (0,), dt),
            OperandLaunch((br, c), (0,), dt),
            OperandLaunch((c,), (), torch.float32, staged=True),
            OperandLaunch((c,), (), torch.float32, staged=True),
            OperandLaunch((br, c), (0,), dt, is_output=True),
        ),
        flops=float(LN_FLOPS_PER_ELEMENT * r * c),
        dtype=dt,
        ragged=(0,),
    )


def _check(x: torch.Tensor, res: torch.Tensor, gamma: torch.Tensor,
           beta: torch.Tensor, br: int) -> None:
    """Raise ValueError on anything the kernel does not take."""
    if x.ndim != 2 or res.shape != x.shape:
        raise ValueError(f"layernorm takes x and res of one (r, c) shape; "
                         f"got {tuple(x.shape)} and {tuple(res.shape)}")
    r, c = x.shape
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"gamma and beta must be ({c},); got "
                         f"{tuple(gamma.shape)} and {tuple(beta.shape)}")
    if x.dtype not in DTYPES or res.dtype != x.dtype:
        raise ValueError(f"layernorm takes x and res of one dtype in "
                         f"{DTYPES}; got {x.dtype} and {res.dtype}")
    if not (gamma.is_floating_point() and beta.is_floating_point()):
        raise ValueError("gamma and beta must be floating point")
    devs = {t.device for t in (x, res, gamma, beta)}
    if len(devs) != 1 or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"inputs must share one cpu or cuda device; got "
                         f"{sorted(map(str, devs))}")
    if not (x.is_contiguous() and res.is_contiguous()):
        raise ValueError("layernorm takes contiguous x and res")
    if not isinstance(br, int) or br <= 0:
        raise ValueError(f"br={br!r} must be a positive int")
    d = layernorm_launch((((r, c), x.dtype), ((r, c), x.dtype),
                          ((c,), torch.float32), ((c,), torch.float32)),
                         br=br)
    if d.smem_bytes > SMEM_LIMIT or r * c >= 2**63 or d.grid[0] >= 2**31:
        raise ValueError(f"shape ({r}, {c}) exceeds the kernel's limits")


def layernorm_kernel(x: torch.Tensor, res: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, *, br: int,
                     eps: float = 1e-6) -> torch.Tensor:
    """Fused layernorm + residual of (r, c) rows in CTAs of ``br`` rows: the
    CUDA kernel for CUDA tensors, ``layernorm_plain`` for CPU tensors (after
    the same argument checks)."""
    _check(x, res, gamma, beta, br)
    if x.device.type == "cpu":
        return layernorm_plain(x, res, gamma, beta, eps)
    r, c = x.shape
    g32 = gamma.float().contiguous()
    b32 = beta.float().contiguous()
    out = torch.empty_like(x)
    vector = int(c % (16 // x.element_size()) == 0
                 and x.data_ptr() % 16 == 0 and res.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib().klaraptor_layernorm(
            x.data_ptr(), res.data_ptr(), g32.data_ptr(), b32.data_ptr(),
            out.data_ptr(), r, c, br, float(eps), _DTYPE_CODE[x.dtype],
            vector, stream)
    if rc:
        _raise_cuda("layernorm kernel launch", rc)
    LAUNCHES.count += 1
    return out


def layernorm_grid_spec(c: int, dtype_bytes: int = 2,
                        eps: float = 1e-6) -> GridSpec:
    """Tunable-interface declaration for ``spec_from_kernel``.

    Only the interface and tuning policy (the reference's candidates and
    default; probe hints of the port's own) -- grid, tiles, residency,
    threads, FLOPs, shared memory, registers and constraints are all
    derived.
    """
    dt = torch.bfloat16 if dtype_bytes == 2 else torch.float32
    return GridSpec(
        name=f"layernorm_c{c}_b{dtype_bytes * 8}",
        data_params=("r",),
        program_params=("br",),
        make_args=lambda D: (((D["r"], c), dt), ((D["r"], c), dt),
                             ((c,), torch.float32), ((c,), torch.float32)),
        call_kwargs={"eps": eps},
        param_candidates={"br": (8, 16, 32, 64, 128, 256, 512, 1024, 2048)},
        # Rows up to 8192: below a few thousand rows every br fits one
        # wave, and the fit would never see the regime it must choose in.
        probe_hints={"r": (512, 2048, 8192)},
        fit_vars={"mem_step": ("br",), "cmp_step": ("br",),
                  "ovh_step": ("br",)},
        defaults={"br": 128},
    )


LAYERNORM = CudaKernel(source="layernorm", describe=layernorm_launch,
                       launch=layernorm_kernel, attributes=kernel_attributes,
                       regs_cap=LN_REGS_PER_THREAD)
