"""GridSpec: the declared tunable interface of a CUDA kernel.

KLARAPTOR's LLVM pass does not invent the tunable interface of a kernel --
the user's configuration file names the launch parameters and their ranges
(paper Section V-A); the pass derives everything *structural* from the
compiled kernel.  A :class:`GridSpec` is that configuration file: it names
the data parameters D and the program parameters P, says how to build the
kernel's arguments at a given D, and optionally carries tuning *policy* that
no analysis can decide (candidate value grids, probe hints, a FLOP hint for
kernels whose work per point depends on P, defaults).

Everything else -- the grid and the loop inside a block, threads per CTA,
the per-operand tiles and their dependences (block residency), shared-memory
stage bytes, FLOPs, registers per thread and the feasibility constraints --
is derived by ``spec_from_kernel`` from two launch descriptions of the
kernel and its compiled attributes (see trace.py / derive.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Mapping

__all__ = ["GridSpec", "IntrospectError", "trace_points"]

Dims = Mapping[str, int]


class IntrospectError(RuntimeError):
    """Analysis of a CUDA kernel's launch description failed or was
    ambiguous.

    Raised when the described launch cannot be mapped onto the KernelSpec
    model: grid extents, tile dimensions or a thread count that match no
    data/program parameter, a shared-memory size that is not the staged
    tiles', or a FLOP density that depends on the program parameters (needs
    an explicit ``flops_per_point`` hint).
    """


@dataclass
class GridSpec:
    """Tunable-interface declaration handed to ``spec_from_kernel``.

    ``make_args(D)`` returns the kernel's positional arguments at data size
    D as ``(shape, torch.dtype)`` pairs -- nothing is allocated.
    ``call_kwargs`` are static keyword arguments that are part of the
    kernel's identity (eps); the program parameters are passed as additional
    keyword arguments.

    The remaining fields are tuning policy forwarded verbatim into the
    derived :class:`~repro_torch.core.kernel_spec.KernelSpec`; all of them
    have working defaults, so a brand-new kernel needs only ``name``, the
    two parameter tuples, and ``make_args``.
    """

    name: str
    data_params: tuple[str, ...]
    program_params: tuple[str, ...]
    make_args: Callable[[Dims], tuple]
    call_kwargs: dict = field(default_factory=dict)
    # -- tuning policy (not derivable) ----------------------------------------
    param_candidates: dict[str, tuple[int, ...]] = field(default_factory=dict)
    probe_hints: dict[str, tuple[int, ...]] = field(default_factory=dict)
    fit_vars: dict[str, tuple[str, ...]] = field(default_factory=dict)
    # Overrides the launch description's FLOP count (needed when FLOPs per
    # point depend on P).
    flops_per_point: float | None = None
    # Static fallback launch config for dispatch before any tuning.
    defaults: dict[str, int] = field(default_factory=dict)


# Distinct odd primes scale the program parameters so every traced size is
# unique and every (data, program) ceil-division ratio is distinguishable.
_PRIMES = (7, 11, 13, 17, 19, 23)
# Per-data-param multipliers; all below the smallest prime's square and
# pairwise distinct within and across the two traces.
_D_MULT_1 = (3, 5, 6, 9, 15, 25)
_D_MULT_2 = (4, 10, 12, 18, 21, 33)


def trace_points(gs: GridSpec) -> tuple[tuple[Dims, Dims], tuple[Dims, Dims]]:
    """Two (D, P) assignments that make dimension matching unambiguous.

    Program parameters get ``16 * prime`` (point 1) and ``32 * prime``
    (point 2) with a distinct prime each; data parameters get distinct
    multiples of ``32 * prod(primes)`` so every data extent is divisible by
    every program parameter and every value/ratio identifies exactly one
    symbol.
    """
    n_p, n_d = len(gs.program_params), len(gs.data_params)
    if n_p > len(_PRIMES):
        raise IntrospectError(
            f"{gs.name}: more than {len(_PRIMES)} program parameters")
    if n_d > len(_D_MULT_1):
        raise IntrospectError(
            f"{gs.name}: more than {len(_D_MULT_1)} data parameters")
    primes = _PRIMES[:n_p]
    base = 32 * math.prod(primes) if primes else 1024
    points = []
    for p_scale, mults in ((16, _D_MULT_1), (32, _D_MULT_2)):
        P = {p: p_scale * q for p, q in zip(gs.program_params, primes)}
        D = {d: base * m for d, m in zip(gs.data_params, mults)}
        points.append((D, P))
    _check_unambiguous(gs, points)
    return tuple(points)


def _check_unambiguous(gs: GridSpec, points) -> None:
    """Every traced value and extent ratio must identify a unique symbol."""
    for D, P in points:
        vals = list(D.values()) + list(P.values())
        if len(set(vals)) != len(vals):
            raise IntrospectError(
                f"{gs.name}: trace values collide: {D} {P}")
        ratios = [D[d] // P[p] for d in D for p in P]
        if len(set(ratios)) != len(ratios):
            raise IntrospectError(
                f"{gs.name}: trace extent ratios collide: {D} {P}")
        if set(ratios) & set(vals):
            raise IntrospectError(
                f"{gs.name}: a trace extent ratio collides with a traced "
                f"value: {D} {P}")
