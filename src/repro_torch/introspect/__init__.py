"""repro_torch.introspect: automatic KernelSpec extraction from CUDA kernels.

The Hopper analogue of KLARAPTOR's LLVM pass (paper Section V-B): instead
of hand-writing the (D, P) workload description of every kernel, read it
off the kernel.  Its wrapper states the launch it would make at any (D, P)
-- grid, loops inside a block, threads, shared memory, per-operand tiles and
the axes they depend on, FLOPs -- and the compiled library reports registers
and spills per thread (``cudaFuncGetAttributes``, the R input of
``cuda_occupancy_program``).  From two such captures the full
:class:`~repro_torch.core.kernel_spec.KernelSpec` is derived:

  * data parameters D and program parameters P by two-point value matching,
  * per-operand traffic and block residency from the stated dependences,
  * threads per CTA as a constant times a product of program parameters,
  * shared-memory stage bytes from the staged and scratch tiles, checked
    against the captured size,
  * FLOPs per point from the described count,
  * feasibility constraints (caps + the Hopper 8-granularity) as the same
    Python-syntax strings hand specs use.

Entry points: ``spec_from_kernel(kernel, grid_spec)`` for the spec alone;
``auto_register(kernel, grid_spec)`` to wire a kernel into the driver
registry and the tuned ops with no hand-written spec code.  GridSpecs that
mirror the hand-written matmul and grouped-matmul specs live in
``repro_torch.introspect.tier1`` (imported on demand).  There is no
counterpart of the JAX package's jaxpr cost walk: the FLOPs come from the
launch description.
"""

from .derive import derive_kernel, spec_from_kernel
from .gridspec import GridSpec, IntrospectError, trace_points
from .registry import AutoKernel, auto_kernels, auto_register, get_auto
from .trace import (Capture, CudaKernel, LaunchDescription, OperandCapture,
                    OperandLaunch, capture_kernel)

__all__ = [
    "GridSpec", "IntrospectError", "trace_points",
    "Capture", "CudaKernel", "LaunchDescription", "OperandCapture",
    "OperandLaunch", "capture_kernel",
    "derive_kernel", "spec_from_kernel",
    "AutoKernel", "auto_register", "get_auto", "auto_kernels",
]
