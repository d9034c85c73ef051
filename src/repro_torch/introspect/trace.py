"""CUDA kernel capture: describe a launch at (D, P), read the compiled kernel.

The Hopper analogue of the paper's LLVM pass entry point.  There is no IR to
trace: what the JAX package's tracer read off a ``pallas_call`` equation, the
port's CUDA wrapper states itself in a pure-arithmetic
:class:`LaunchDescription` at any (D, P) -- nothing is allocated, launched
or validated, so the synthetic trace points may exceed every launch limit:

  * the CUDA grid, outermost axis first, and the loop extents inside a block
    (where the TPU had sequential grid axes),
  * threads per CTA and dynamic shared-memory bytes,
  * per operand: its tile, the grid axes or loops its position depends on
    (the block-residency analysis: a tile that depends on no loop is loaded
    once per CTA), whether it is staged in shared memory, shared memory only
    (scratch), or an output,
  * the kernel's own FLOP count for the launch, the unit it runs on (FP32
    FMAs or the bf16 tensor cores), the template instantiation (dtype) the
    launch runs, and the granule its tile sizes come in (8 unless the
    kernel states another: the wgmma kernels take multiples of 64).

The compiled half is what ``cudaFuncGetAttributes`` reports of the built
library -- registers per thread and spilled local bytes, the R input of
``cuda_occupancy_program`` -- read only on the card.  Without one (the CPU
tests, or a caller that asks for ``device="cpu"``) the register count is the
kernel's ``__launch_bounds__`` cap, which the wrapper states.  Each capture
records which of the two it holds, and a source fingerprint: a hash of the
``.cu`` source, the nvcc flags, the instantiation and the static keyword
arguments, so an edited kernel, another eps or another dtype never shares a
tuning artefact.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Callable, Mapping

import torch

from ..kernels._build import NVCC_FLAGS, source_bytes
from .gridspec import GridSpec, IntrospectError

__all__ = ["Capture", "CudaKernel", "LaunchDescription", "OperandCapture",
           "OperandLaunch", "capture_kernel"]

Dims = Mapping[str, int]


@dataclass(frozen=True)
class OperandLaunch:
    """One operand of a launch as its wrapper states it.  ``deps`` index the
    launch's axes: the grid axes first, then the loops."""

    tile: tuple[int, ...]
    deps: tuple[int, ...]
    dtype: torch.dtype
    staged: bool = False
    scratch: bool = False
    is_output: bool = False


@dataclass(frozen=True)
class LaunchDescription:
    """What one launch of a CUDA kernel would do, in numbers.  ``ragged``
    indexes the axes (grid axes first, then the loops) whose last, partial
    block the kernel masks, so their tile need not divide the data.
    ``granule`` is what every tile size the kernel takes is a multiple of;
    ``compute_unit`` is where its FLOPs run ("f32" FMAs on the CUDA cores,
    "bf16" on the tensor cores)."""

    grid: tuple[int, ...]
    loops: tuple[int, ...]
    threads: int
    smem_bytes: int
    operands: tuple[OperandLaunch, ...]
    flops: float
    dtype: torch.dtype
    ragged: tuple[int, ...] = ()
    granule: int = 8
    compute_unit: str = "f32"


@dataclass(frozen=True)
class CudaKernel:
    """A hand-written CUDA kernel as introspection and tuning see it.

    ``describe(args, **kwargs)`` states the launch that ``launch(*tensors,
    **kwargs)`` would make on tensors of the ``(shape, dtype)`` pairs
    ``args``; ``attributes(dtype)`` reads the compiled instantiation
    (``num_regs``, ``max_threads``, ``local_bytes``) on the card;
    ``regs_cap`` is its ``__launch_bounds__`` register cap, or a mapping
    from dtype to the cap of that instantiation's body.
    """

    source: str
    describe: Callable[..., LaunchDescription]
    launch: Callable[..., torch.Tensor]
    attributes: Callable[[torch.dtype], dict]
    regs_cap: int | Mapping[torch.dtype, int]

    def regs_cap_for(self, dtype: torch.dtype) -> int:
        """The register cap of the instantiation for ``dtype``."""
        cap = self.regs_cap
        return int(cap[dtype]) if isinstance(cap, Mapping) else int(cap)


@dataclass
class OperandCapture:
    """One operand as read off a launch description."""

    block_shape: tuple[int, ...]
    dep_axes: tuple[int, ...]
    dtype: torch.dtype
    is_output: bool = False
    is_scratch: bool = False
    staged: bool = False


@dataclass
class Capture:
    """Everything read off one described launch and the compiled kernel."""

    grid: tuple[int, ...]          # CTA grid axes, then the loops
    n_parallel: int                # how many leading axes are the CTA grid
    ragged: tuple[int, ...]        # axes whose partial last block is masked
    threads: int
    smem_bytes: int
    operands: list[OperandCapture]
    flops: float
    num_regs: int
    regs_cap: int
    local_bytes: int | None        # spilled bytes (None without a card)
    attributes_source: str         # "compiled" or "launch_bounds"
    fingerprint: str
    granule: int = 8               # tile sizes are multiples of it
    compute_unit: str = "f32"      # where the FLOPs run


def source_fingerprint(kernel: CudaKernel, grid_spec: GridSpec,
                       dtype: torch.dtype) -> str:
    """sha256 of the kernel's source and the headers it may include, the
    nvcc flags, the instantiation and the GridSpec's static keyword
    arguments (16 hex digits)."""
    h = hashlib.sha256(source_bytes(kernel.source))
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(f"\n{kernel.source}\n{dtype}\n".encode())
    h.update(repr(sorted(grid_spec.call_kwargs.items())).encode())
    return h.hexdigest()[:16]


def capture_kernel(kernel: CudaKernel, grid_spec: GridSpec, D: Dims, P: Dims,
                   *, device: str | torch.device = "cuda") -> Capture:
    """Describe ``kernel``'s launch at (D, P) and read its attributes.

    On a CUDA ``device`` the registers and spills come from the compiled
    library (built if needed; without a card or nvcc this raises); with
    ``device="cpu"`` the register count is the ``__launch_bounds__`` cap.
    """
    args = grid_spec.make_args(D)
    kwargs = {**grid_spec.call_kwargs,
              **{p: int(P[p]) for p in grid_spec.program_params}}
    try:
        desc = kernel.describe(args, **kwargs)
    except (TypeError, ValueError, KeyError, ZeroDivisionError) as e:
        raise IntrospectError(
            f"{grid_spec.name}: describing the launch at D={dict(D)} "
            f"P={dict(P)} failed: {type(e).__name__}: {e}") from e
    axes = tuple(int(g) for g in desc.grid) + tuple(int(n) for n in desc.loops)
    if any(not 0 <= a < len(axes) for a in desc.ragged):
        raise IntrospectError(
            f"{grid_spec.name}: ragged axes {desc.ragged} of a launch with "
            f"{len(axes)} axes")
    operands = []
    for i, op in enumerate(desc.operands):
        if any(not 0 <= a < len(axes) for a in op.deps):
            raise IntrospectError(
                f"{grid_spec.name}: operand {i} depends on axis "
                f"{op.deps} of a launch with {len(axes)} axes")
        operands.append(OperandCapture(
            block_shape=tuple(int(t) for t in op.tile),
            dep_axes=tuple(sorted(op.deps)), dtype=op.dtype,
            is_output=op.is_output, is_scratch=op.scratch,
            staged=op.staged))
    if torch.device(device).type == "cuda":
        attrs = kernel.attributes(desc.dtype)
        num_regs, local, source = (int(attrs["num_regs"]),
                                   int(attrs["local_bytes"]), "compiled")
    else:
        num_regs, local, source = (kernel.regs_cap_for(desc.dtype), None,
                                   "launch_bounds")
    return Capture(
        grid=axes, n_parallel=len(desc.grid),
        ragged=tuple(sorted(desc.ragged)), threads=int(desc.threads),
        smem_bytes=int(desc.smem_bytes), operands=operands,
        flops=float(desc.flops), num_regs=num_regs,
        regs_cap=kernel.regs_cap_for(desc.dtype), local_bytes=local,
        attributes_source=source,
        fingerprint=source_fingerprint(kernel, grid_spec, desc.dtype),
        granule=int(desc.granule), compute_unit=desc.compute_unit)
