"""Derive a full KernelSpec from two captures of a CUDA kernel.

The symbolic-reconstruction half of the pass.  A single launch description
yields only concrete numbers (grid and loop extents, tile dims, threads,
shared-memory bytes); describing the launch at *two* (D, P) assignments in
which every parameter takes a unique pair of values turns each number back
into the symbol that produced it:

  * a tile dimension whose values track P[p] across both points is the
    program parameter ``p``; tracking D[d] makes it the data parameter
    ``d``; a value constant across points is a literal,
  * a grid or loop extent equal to D[d] at both points is an unblocked
    axis; equal to ceil(D[d] / P[p]) for exactly one (d, p) pair it is the
    axis that tiles ``d`` with block ``p``; the loops become the spec's
    sequential axes, and an axis whose partial last block the kernel masks
    (the description's ``ragged``) becomes a ragged axis, whose tile need
    not divide ``d``,
  * leading literal-1 tile dims (an unblocked batch axis, such as the
    expert of the grouped matmul) are squeezed, keeping at least two,
  * threads per CTA are a constant times a product of program parameters:
    the one subset of P whose product divides both captured counts into the
    same constant, a power-of-two fraction (the trace points' odd primes
    leave any wrong subset with a prime in the constant).

There is no counterpart of the JAX package's cost walk (``costwalk.py``,
which walked the kernel body's jaxpr): the FLOPs come from the launch
description, the kernel's own count.  Per grid-domain point they are
cross-checked between the two points; a mismatch means the FLOP density
depends on P -- impossible to express as a constant ``flops_per_point`` --
and demands an explicit GridSpec hint.

Registers per thread are the capture's (compiled on the card, the
``__launch_bounds__`` cap without one).  Self-checks: the symbolic grid,
threads and stage bytes (``KernelSpec.stage_expr``: staged and scratch tiles)
must reproduce both captures exactly.

Feasibility constraints are synthesized in the Python-syntax string form
hand specs use: one ``"p <= d"`` cap per blocked axis, plus one granularity
per program parameter.  **The Hopper granularity rule**, which replaces the
TPU's 8-sublane / 128-lane rule: a program parameter that sizes a tile
dimension of any operand is a multiple of the kernel's granule, which its
launch description states -- 8 by default (eight elements are one 16-byte
vector load of bf16, two of f32, and eight rows or columns are the
micro-tile, row-lane and warp granule of the SIMT kernels), 64 for the
wgmma kernels (a warpgroup's 64 rows, 64-column B boxes, 64-wide swizzle
atoms along k); a parameter that sizes no tile gets no granularity
constraint.  The compute unit the FLOPs run on is the description's too.  Shared memory, threads
and registers are then checked by the same Hopper launch limits every spec
gets (``KernelSpec.feasible_mask``).
"""

from __future__ import annotations

import itertools
import math
from fractions import Fraction
from typing import Mapping

import torch

from ..core.kernel_spec import GridAxis, KernelSpec, Operand
from ..core.rational_program import Expr, const, var
from ..trace import trace_span
from .gridspec import GridSpec, IntrospectError, trace_points
from .trace import Capture, CudaKernel, capture_kernel

__all__ = ["derive_kernel", "spec_from_kernel"]

Dims = Mapping[str, int]

# Two points whose derived per-point FLOPs differ by more than this are
# P-dependent (not expressible as a constant flops_per_point).
_FLOP_TOLERANCE = 0.25


def _match_dim(name: str, what: str, v1: int, v2: int,
               D1: Dims, P1: Dims, D2: Dims, P2: Dims) -> str | int:
    """Symbol (param name) or literal behind a pair of captured values."""
    hits = [p for p in P1 if P1[p] == v1 and P2[p] == v2]
    hits += [d for d in D1 if D1[d] == v1 and D2[d] == v2]
    if len(hits) == 1:
        return hits[0]
    if len(hits) > 1:
        raise IntrospectError(
            f"{name}: {what} value ({v1}, {v2}) matches several parameters "
            f"{hits}; trace points are not discriminating")
    if v1 == v2:
        return int(v1)
    raise IntrospectError(
        f"{name}: {what} value changed between points ({v1} -> {v2}) but "
        f"matches no data or program parameter")


def _match_grid(gs: GridSpec, cap1: Capture, cap2: Capture,
                D1: Dims, P1: Dims, D2: Dims, P2: Dims
                ) -> tuple[GridAxis, ...]:
    if len(cap1.grid) != len(cap2.grid) or \
            (cap1.n_parallel, cap1.ragged) != (cap2.n_parallel, cap2.ragged):
        raise IntrospectError(
            f"{gs.name}: launch rank changed between points "
            f"({cap1.grid} vs {cap2.grid})")
    axes = []
    for i, (e1, e2) in enumerate(zip(cap1.grid, cap2.grid)):
        nm = f"ax{i}"
        seq, ragged = i >= cap1.n_parallel, i in cap1.ragged
        direct = [d for d in D1 if D1[d] == e1 and D2[d] == e2]
        ratio = [(d, p) for d in D1 for p in P1
                 if math.ceil(D1[d] / P1[p]) == e1
                 and math.ceil(D2[d] / P2[p]) == e2]
        if len(direct) + len(ratio) > 1:
            raise IntrospectError(
                f"{gs.name}: axis {i} extent ({e1}, {e2}) is ambiguous "
                f"(direct={direct}, ratio={ratio})")
        if direct:
            axes.append(GridAxis(nm, direct[0], None, sequential=seq))
        elif ratio:
            axes.append(GridAxis(nm, ratio[0][0], ratio[0][1],
                                 sequential=seq, ragged=ragged))
        elif e1 == e2:
            axes.append(GridAxis(nm, int(e1), None, sequential=seq))
        else:
            raise IntrospectError(
                f"{gs.name}: axis {i} extent ({e1}, {e2}) matches no data "
                f"extent and no ceil(data/program) division")
    return tuple(axes)


def _squeeze(t1: tuple[int, ...], t2: tuple[int, ...]):
    """Drop leading unblocked batch dims (literal 1 at both points),
    keeping at least two dims."""
    while len(t1) > 2 and t1[0] == 1 and t2[0] == 1:
        t1, t2 = t1[1:], t2[1:]
    return t1, t2


def _match_operands(gs: GridSpec, cap1: Capture, cap2: Capture,
                    axes: tuple[GridAxis, ...],
                    D1: Dims, P1: Dims, D2: Dims, P2: Dims
                    ) -> tuple[Operand, ...]:
    if len(cap1.operands) != len(cap2.operands):
        raise IntrospectError(
            f"{gs.name}: operand count changed between points")
    n_in = 0
    out = []
    for idx, (op1, op2) in enumerate(zip(cap1.operands, cap2.operands)):
        if (op1.is_output, op1.is_scratch, op1.staged, op1.dtype) != \
                (op2.is_output, op2.is_scratch, op2.staged, op2.dtype) \
                or op1.dep_axes != op2.dep_axes:
            raise IntrospectError(
                f"{gs.name}: operand {idx} structure changed between points")
        t1, t2 = _squeeze(op1.block_shape, op2.block_shape)
        if len(t1) != len(t2):
            raise IntrospectError(
                f"{gs.name}: operand {idx} rank changed between points")
        tile = tuple(
            _match_dim(gs.name, f"operand {idx} dim {j}", v1, v2,
                       D1, P1, D2, P2)
            for j, (v1, v2) in enumerate(zip(t1, t2)))
        if op1.is_scratch:
            nm = f"scratch{idx}"
        elif op1.is_output:
            nm = f"out{idx}"
        else:
            nm = f"in{idx}"
            n_in += 1
        out.append(Operand(
            name=nm,
            tile=tile,
            deps=tuple(axes[a].name for a in op1.dep_axes),
            dtype_bytes=op1.dtype.itemsize,
            is_output=op1.is_output,
            staged=op1.staged,
            scratch=op1.is_scratch,
        ))
    if n_in == 0:
        raise IntrospectError(f"{gs.name}: kernel has no input operands")
    return tuple(out)


def _points(axes: tuple[GridAxis, ...], D: Dims) -> float:
    """Size of the grid's data domain (what flops_per_point multiplies)."""
    return float(math.prod(D[a.data] if isinstance(a.data, str) else a.data
                           for a in axes))


def _derive_flops(gs: GridSpec, cap1: Capture, cap2: Capture,
                  axes: tuple[GridAxis, ...], D1: Dims, D2: Dims) -> float:
    """FLOPs per grid-domain point from the described counts, or the hint."""
    if gs.flops_per_point is not None:
        return float(gs.flops_per_point)
    if cap1.flops <= 0 or cap2.flops <= 0:
        raise IntrospectError(
            f"{gs.name}: the launch description counts no FLOPs; pass "
            f"flops_per_point in the GridSpec")
    f1, f2 = cap1.flops / _points(axes, D1), cap2.flops / _points(axes, D2)
    rel = abs(f1 - f2) / max(f1, f2)
    if rel > _FLOP_TOLERANCE:
        raise IntrospectError(
            f"{gs.name}: per-point FLOPs differ between points "
            f"({f1:.1f} vs {f2:.1f}): the FLOP density depends on the "
            f"program parameters; pass flops_per_point in the GridSpec")
    if f1 == f2:
        return float(f1)
    mean = (f1 + f2) / 2.0
    # Round to two significant digits: the residual spread between points
    # comes from amortized per-block terms (1/P), which the fitted overhead
    # metric absorbs anyway.
    digits = 1 - int(math.floor(math.log10(abs(mean))))
    return round(mean, digits)


def _is_dyadic(c: Fraction) -> bool:
    den = c.denominator
    return c > 0 and den & (den - 1) == 0


def _derive_threads(gs: GridSpec, cap1: Capture, cap2: Capture,
                    P1: Dims, P2: Dims) -> Expr:
    """threads = c * prod(P[S]) for the one subset S that fits both points."""
    fits = []
    params = tuple(gs.program_params)
    for n in range(len(params) + 1):
        for S in itertools.combinations(params, n):
            c1 = Fraction(cap1.threads, math.prod(P1[p] for p in S))
            c2 = Fraction(cap2.threads, math.prod(P2[p] for p in S))
            if c1 == c2 and _is_dyadic(c1):
                fits.append((S, c1))
    if len(fits) != 1:
        raise IntrospectError(
            f"{gs.name}: threads per CTA ({cap1.threads}, {cap2.threads}) "
            f"are {'ambiguous' if fits else 'no'} constant times a product "
            f"of program parameters ({[S for S, _ in fits]})")
    S, c = fits[0]
    if not S:
        return const(float(c))
    expr: Expr = var(S[0])
    for p in S[1:]:
        expr = expr * var(p)
    if c.numerator != 1:
        expr = expr * const(float(c.numerator))
    if c.denominator != 1:
        expr = expr / const(float(c.denominator))
    return expr


def _derive_constraints(gs: GridSpec, axes: tuple[GridAxis, ...],
                        operands: tuple[Operand, ...],
                        granule: int) -> tuple[str, ...]:
    cons: list[str] = []
    for a in axes:
        if a.block is not None and isinstance(a.data, str):
            cons.append(f"{a.block} <= {a.data}")
    tiled = {t for op in operands for t in op.tile}
    for p in gs.program_params:
        if p in tiled:
            cons.append(f"{p} % {granule} == 0")
    return tuple(cons)


def _check(gs: GridSpec, what: str, got, want, D: Dims, P: Dims) -> None:
    if got != want:
        raise IntrospectError(
            f"{gs.name}: derived {what} {got} does not reproduce the "
            f"captured {want} at D={dict(D)} P={dict(P)}")


def derive_kernel(kernel: CudaKernel, grid_spec: GridSpec, *,
                  device: str | torch.device = "cuda"
                  ) -> tuple[KernelSpec, Capture]:
    """``spec_from_kernel``, also returning the first point's capture
    (its compiled attributes and fingerprint).  Both run in one
    ``spec_from_kernel`` span, the reference's."""
    with trace_span("spec_from_kernel", kernel=grid_spec.name) as sp:
        (D1, P1), (D2, P2) = trace_points(grid_spec)
        cap1 = capture_kernel(kernel, grid_spec, D1, P1, device=device)
        cap2 = capture_kernel(kernel, grid_spec, D2, P2, device=device)
        axes = _match_grid(grid_spec, cap1, cap2, D1, P1, D2, P2)
        operands = _match_operands(grid_spec, cap1, cap2, axes, D1, P1, D2, P2)
        if (cap1.granule, cap1.compute_unit) != (cap2.granule,
                                                 cap2.compute_unit):
            raise IntrospectError(
                f"{grid_spec.name}: granule or compute unit changed between "
                f"points")
        spec = KernelSpec(
            name=grid_spec.name,
            data_params=tuple(grid_spec.data_params),
            program_params=tuple(grid_spec.program_params),
            grid=axes,
            operands=operands,
            flops_per_point=_derive_flops(grid_spec, cap1, cap2, axes, D1, D2),
            threads=_derive_threads(grid_spec, cap1, cap2, P1, P2),
            regs_per_thread=cap1.num_regs,
            constraints=_derive_constraints(grid_spec, axes, operands,
                                            cap1.granule),
            param_candidates=dict(grid_spec.param_candidates),
            fit_vars=dict(grid_spec.fit_vars),
            source_fingerprint=cap1.fingerprint,
            compute_unit=cap1.compute_unit,
        )
        for D, P, cap in ((D1, P1, cap1), (D2, P2, cap2)):
            env = {**{k: float(v) for k, v in D.items()},
                   **{k: float(v) for k, v in P.items()}}
            grid = tuple(int(round(float(a.extent_expr().eval(env))))
                         for a in spec.grid)
            _check(grid_spec, "grid", grid, cap.grid, D, P)
            _check(grid_spec, "threads",
                   int(round(float(spec.threads.eval(env)))), cap.threads,
                   D, P)
            _check(grid_spec, "shared-memory bytes",
                   int(round(float(spec.stage_expr().eval(env)))),
                   cap.smem_bytes, D, P)
        sp.set(fingerprint=cap1.fingerprint, n_operands=len(operands))
    return spec, cap1


def spec_from_kernel(kernel: CudaKernel, grid_spec: GridSpec, *,
                     device: str | torch.device = "cuda") -> KernelSpec:
    """Derive a full KernelSpec from a hand-written CUDA kernel.

    ``kernel`` states its launch at any (D, P) (trace.py); ``grid_spec``
    declares its tunable interface and optional tuning policy.  The launch
    is described at two synthetic (D, P) points -- nothing executes -- and
    grid, loops, threads, operands (with block-residency dependences),
    shared-memory footprint, FLOPs and feasibility constraints are
    reconstructed from them; registers per thread come from the compiled
    kernel on a CUDA ``device`` and from its ``__launch_bounds__`` cap with
    ``device="cpu"``.  The result is a drop-in peer of a hand-written spec:
    it feeds the same collect -> fit -> choose pipeline, and its
    ``source_fingerprint`` identifies the kernel's source and
    instantiation.
    """
    return derive_kernel(kernel, grid_spec, device=device)[0]
