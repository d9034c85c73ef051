"""The execution-time model of a CUDA kernel as a rational program.

This is the paper's MWP-CWP-style skeleton (Hong & Kim's model, Section
III-A) for a tiled kernel on Hopper.  Each CTA runs a loop of ``seq_iters``
iterations (load tiles into shared memory, barrier, compute from shared
memory, barrier).  ``cuda_occupancy_program`` gives B_active blocks per SM
from registers, shared memory and threads; the grid runs in
``waves = ceil(CTAs / (SMs * B_active))`` and each wave holds
``B_res = ceil(CTAs / (SMs * waves))`` blocks per SM.  The regimes:

  regime A (overlapped, memory-bound):   B_res >= 2 and L_mem >= L_cmp
  regime B (overlapped, compute-bound):  B_res >= 2 and L_cmp >  L_mem
  regime C (serialized):                 B_res  < 2  (one block per SM: no
                                         other block's warps run while this
                                         one waits on its loads -- the
                                         "insufficient warps" case)

The *skeleton* (decision nodes + combination formulas) is known
analytically; the *process nodes* are fitted rational functions of P, per
block and per loop iteration:

  L_mem(P)  -- one block's tile loads for one iteration      (fitted, ~ g_1)
  L_cmp(P)  -- one block's FMAs for one iteration             (fitted, ~ g_2)
  L_ovh(P)  -- the per-step residual: barrier and load-latency bubbles,
               imperfect overlap (the "departure delay")      (fitted, ~ g_3)

  steps = waves * seq_iters
  E = steps * (B_res * max(L_mem, L_cmp) + L_ovh)    if B_res >= 2
  E = steps * (L_mem + L_cmp + L_ovh)                otherwise

Waves, B_res and steps are rational expressions of (D, P) derived from the
KernelSpec (ceil/floor/min keep us inside the rational-program class), and
the fitted metrics use the same ``Select``/``Max`` language as the
reference, so code generation stays hardware-free.
"""

from __future__ import annotations

from .device_model import H100, HardwareParams
from .kernel_spec import KernelSpec
from .rational import RationalFunction
from .rational_program import Expr, Fitted, Max, RationalProgram, Select, \
    const

__all__ = ["build_time_program", "LOW_LEVEL_METRICS"]

# The three fitted low-level metrics (per block and loop iteration, seconds).
LOW_LEVEL_METRICS = ("mem_step", "cmp_step", "ovh_step")


def build_time_program(
    spec: KernelSpec,
    fitted: dict[str, RationalFunction],
    hw: HardwareParams = H100,
) -> RationalProgram:
    """Assemble the execution-time rational program for one kernel.

    ``fitted`` maps each LOW_LEVEL_METRICS name to its rational function
    g_i(D, P) determined by core/fitting.py from probe data.
    """
    missing = set(LOW_LEVEL_METRICS) - set(fitted)
    if missing:
        raise ValueError(f"missing fitted metrics {missing} for {spec.name}")

    steps = spec.grid_steps_expr(hw)
    resident = spec.resident_expr(hw)
    L_mem = Fitted("mem_step", fitted["mem_step"])
    L_cmp = Fitted("cmp_step", fitted["cmp_step"])
    L_ovh = Fitted("ovh_step", fitted["ovh_step"])

    overlapped = steps * (resident * Max(L_mem, L_cmp) + L_ovh)
    serialized = steps * (L_mem + L_cmp + L_ovh)
    E: Expr = Select(resident >= const(2.0), overlapped, serialized)

    return RationalProgram(
        name=f"time_{spec.name}",
        inputs=tuple(spec.data_params) + tuple(spec.program_params),
        outputs={
            "E": E,
            "steps": steps,
            "stage_bytes": spec.stage_expr(),
            "threads": spec.threads,
            "blocks_per_sm": spec.blocks_per_sm_expr(hw),
            "blocks_resident": resident,
            "mem_step": L_mem,
            "cmp_step": L_cmp,
            "ovh_step": L_ovh,
        },
        primary="E",
    )
