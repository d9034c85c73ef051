"""Occupancy rational program (paper Fig. 2).

``cuda_occupancy_program`` reproduces the paper's Fig. 2 flowchart verbatim:
a rational program computing B_active (active thread blocks per SM) from
hardware limits (R_max, Z_max, T_max, B_max, W_max) and kernel metrics
(R registers/thread, Z shared-memory words/block, T threads/block), then
W_active = min(floor(B_active*T/32), W_max) and occupancy = W_active/W_max.
The flowchart has 5 terminating leaves; our Select tree preserves that piece
count.

On Hopper this is the program the performance model (core/perf_model.py)
reads blocks-per-SM from, with Z counted in bytes on both sides.  It is a
genuine rational program: +, -, *, /, floor, min, comparisons only.
"""

from __future__ import annotations

from .rational_program import Expr, Floor, Min, RationalProgram, Select, \
    const, floor_div, var

__all__ = ["cuda_occupancy_program"]


def cuda_occupancy_program() -> RationalProgram:
    """Fig. 2: B_active from (R_max, Z_max, T_max, B_max, W_max, R, Z, T).

    Decision structure (5 leaves, as in the figure):
      T > T_max                      -> 0                      (leaf 1)
      R*T > R_max                    -> 0                      (leaf 2)
      Z == 0                         -> min(B_max, B_T)        (leaf 3)
      Z > Z_max                      -> 0                      (leaf 4)
      else                           -> min(B_max, B_T, B_R, B_Z) (leaf 5)
    with B_T = floor(T_max/T), B_R = floor(R_max/(R*T)), B_Z = floor(Z_max/Z).
    """
    R_max, Z_max, T_max = var("R_max"), var("Z_max"), var("T_max")
    B_max, W_max = var("B_max"), var("W_max")
    R, Z, T = var("R"), var("Z"), var("T")

    B_T = floor_div(T_max, T)
    B_R = floor_div(R_max, R * T)
    B_Z = floor_div(Z_max, Z)

    leaf5 = Min(Min(B_max, B_T), Min(B_R, B_Z))
    leaf3 = Min(B_max, Min(B_T, B_R))
    b_active: Expr = Select(
        T > T_max,
        const(0.0),                                   # leaf 1
        Select(
            R * T > R_max,
            const(0.0),                               # leaf 2
            Select(
                Z <= const(0.0),
                leaf3,                                # leaf 3 (no smem limit)
                Select(Z > Z_max, const(0.0), leaf5)  # leaves 4, 5
            ),
        ),
    )
    w_active = Min(Floor(b_active * T / const(32.0)), W_max)
    occupancy = w_active / W_max
    return RationalProgram(
        name="cuda_occupancy",
        inputs=("R_max", "Z_max", "T_max", "B_max", "W_max", "R", "Z", "T"),
        outputs={"B_active": b_active, "W_active": w_active, "E": occupancy},
        primary="E",
    )
