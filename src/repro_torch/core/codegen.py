"""Code generation (paper Section IV, step 3) -- vectorized drivers.

The paper converts the rational program R into C code and inserts it into
the CUDA program so it is "called before the execution of the corresponding
kernel".  We emit a self-contained *Python module* per kernel -- the driver
program -- with:

  * one function per fitted rational function g_i(D, P),
  * the launch-geometry pieces of the skeleton (threads, shared memory,
    blocks per SM from the occupancy program, blocks resident per wave,
    grid steps), each a rational expression emitted in ndarray form,
  * ``estimate(**DP)``: the full piecewise rational program E(D, P),
    ndarray-polymorphic: scalars in -> scalar out, columns in -> column out,
  * ``candidates(**D)``: the feasible configuration enumerator, generated
    from the spec's parameter grids, its Python-syntax constraint strings
    (the user-written configuration files of Section V-A) and the Hopper
    launch limits that ``KernelSpec.feasible_mask`` applies, as vectorized
    masks over a columnar table,
  * ``choose(**D)``: steps 4-6's runtime selection -- evaluate E once over
    the whole candidate table, argmin + the occupancy tie-break heuristic
    in numpy, memoized into a decision history.

The generated source has no imports beyond ``numpy`` and no dependency on
this package.
"""

from __future__ import annotations

import math
import textwrap

import numpy as np

from .device_model import H100, HardwareParams
from .kernel_spec import KernelSpec
from .perf_model import LOW_LEVEL_METRICS
from .rational import RationalFunction

__all__ = ["generate_driver_source", "compile_driver_module"]

_HEADER = '''\
"""Auto-generated KLARAPTOR driver program.

kernel:  {kernel}
device:  {device}
This module is the rational program R of the paper: it estimates the kernel's
execution time E(D, P) as a piecewise rational function and selects optimal
launch parameters at runtime.  All evaluation is vectorized over the whole
candidate table.  Generated code -- do not edit.
"""
import math

import numpy as np

KERNEL = {kernel!r}
DEVICE = {device!r}
SMEM_PER_BLOCK = {smem_per_block}
WARP_SIZE = {warp_size}
MAX_THREADS_PER_BLOCK = {max_threads}
REGS_PER_SM = {regs_per_sm}
MAX_REGS_PER_THREAD = {max_regs}
REGS_PER_THREAD = {regs_per_thread}
DATA_PARAMS = {data_params!r}
PROGRAM_PARAMS = {program_params!r}
PARAM_CANDIDATES = {param_candidates!r}
CONSTRAINTS = {constraints!r}

_HISTORY = {{}}  # decision history: D tuple -> chosen P tuple


def _row_mask(ci, scalars, cols):
    """Per-row fallback for a constraint that resists ndarray evaluation
    (e.g. `and`/`or` between array terms, chained comparisons); mirrors the
    spec-side feasible_mask fallback.  Rows that fail to evaluate are
    infeasible."""
    n = next(iter(cols.values())).shape[0]
    out = np.empty(n, dtype=bool)
    g = {{"__builtins__": {{}}, "math": math, "np": np}}
    for i in range(n):
        env = dict(scalars)
        env.update({{p: int(a[i]) for p, a in cols.items()}})
        try:
            out[i] = bool(eval(CONSTRAINTS[ci], g, env))
        except Exception:
            out[i] = False
    return out
'''


def _fn_source(name: str, rf: RationalFunction) -> str:
    args = ", ".join(rf.var_names)
    return (f"def {name}({args}):\n"
            f"    return {rf.to_source()}\n")


def _constraint_vectorizable(c: str, spec: KernelSpec) -> bool:
    """Whether a constraint string evaluates cleanly with ndarray columns
    (boolean `and`/`or` and chained comparisons break on arrays whatever
    the values, so probing with dummy columns decides)."""
    env: dict = {p: np.array([8, 16], dtype=np.int64)
                 for p in spec.program_params}
    env.update({d: 64 for d in spec.data_params})
    try:
        res = eval(c, {"__builtins__": {}, "math": math, "np": np}, env)
        np.broadcast_to(np.asarray(res, dtype=bool), (2,))
        return True
    except Exception:
        return False


def generate_driver_source(
    spec: KernelSpec,
    fitted: dict[str, RationalFunction],
    hw: HardwareParams = H100,
) -> str:
    cand_lists = {p: tuple(spec.default_candidates(p))
                  for p in spec.program_params}
    parts = [_HEADER.format(
        kernel=spec.name, device=hw.name,
        smem_per_block=hw.smem_per_block_optin, warp_size=hw.warp_size,
        max_threads=hw.max_threads_per_block, regs_per_sm=hw.regs_per_sm,
        max_regs=hw.max_regs_per_thread, regs_per_thread=spec.regs_per_thread,
        data_params=tuple(spec.data_params),
        program_params=tuple(spec.program_params),
        param_candidates=cand_lists,
        constraints=tuple(spec.constraints),
    )]

    # Fitted low-level metric subroutines (step 3-ii).
    for metric in LOW_LEVEL_METRICS:
        parts.append(_fn_source(f"g_{metric}", fitted[metric]))

    # Symbolic skeleton pieces (step 3-i), in vector form.
    all_params = list(spec.data_params) + list(spec.program_params)
    sig = ", ".join(all_params)
    pieces = {
        "threads": spec.threads,
        "stage_bytes": spec.stage_expr(),
        "blocks_per_sm": spec.blocks_per_sm_expr(hw),
        "blocks_resident": spec.resident_expr(hw),
        "grid_steps": spec.grid_steps_expr(hw),
    }
    parts.append("\n".join(
        f"def {name}({sig}):\n    return {e.to_source(vector=True)}\n"
        for name, e in pieces.items()))

    # estimate(): the piecewise rational program E(D, P), one ndarray pass.
    metric_calls = {m: f"g_{m}({', '.join(fitted[m].var_names)})"
                    for m in LOW_LEVEL_METRICS}
    parts.append(textwrap.dedent(f'''\
        def estimate({sig}):
            """E(D, P): piecewise rational estimate of execution time (s).

            ndarray-polymorphic: program params may be columns of the
            candidate table, in which case a column of estimates returns.
            """
            steps = grid_steps({sig})
            res = blocks_resident({sig})
            mem = {metric_calls["mem_step"]}
            cmp = {metric_calls["cmp_step"]}
            ovh = {metric_calls["ovh_step"]}
            overlapped = steps * (res * np.maximum(mem, cmp) + ovh)
            serialized = steps * (mem + cmp + ovh)
            return np.where(res >= 2, overlapped, serialized)
        '''))

    # candidates(): columnar feasible-set enumeration, mirroring
    # KernelSpec.feasible_mask line for line.
    d_sig = ", ".join(spec.data_params)
    p_names = list(spec.program_params)
    unpack = "\n".join(f"    {p} = cols[{p!r}]" for p in p_names)
    scalars = "{" + ", ".join(f"{d!r}: {d}" for d in spec.data_params) + "}"
    mask_srcs = [
        f"    mask &= ({c})" if _constraint_vectorizable(c, spec)
        else f"    mask &= _row_mask({i}, {scalars}, cols)"
        for i, c in enumerate(spec.constraints)]
    for a in spec.grid:
        if a.block is not None and isinstance(a.data, str) and not a.ragged:
            mask_srcs.append(f"    mask &= ({a.block} <= {a.data}) & "
                             f"({a.data} % {a.block} == 0)")
    mask_lines = "\n".join(mask_srcs)
    parts.append(textwrap.dedent(f'''\
        def candidates({d_sig}):
            """Columnar feasible configuration table: one int64 ndarray per
            program parameter, constraints applied as vectorized masks."""
            grids = np.meshgrid(
                *[np.asarray(PARAM_CANDIDATES[p], dtype=np.int64)
                  for p in PROGRAM_PARAMS], indexing="ij")
            cols = {{p: g.reshape(-1) for p, g in zip(PROGRAM_PARAMS, grids)}}
        ''') + unpack + f'''
    mask = np.ones({p_names[0]}.shape, dtype=bool)
''' + (mask_lines + "\n" if mask_lines else "") + f'''\
    t = np.rint(threads({sig}))
    mask &= np.rint(stage_bytes({sig})) <= SMEM_PER_BLOCK
    mask &= (t >= WARP_SIZE) & (t <= MAX_THREADS_PER_BLOCK)
    mask &= t * REGS_PER_THREAD <= REGS_PER_SM
    mask &= REGS_PER_THREAD <= MAX_REGS_PER_THREAD
    return {{p: c[mask] for p, c in cols.items()}}
''')

    # choose(): steps 4-6 -- one vectorized evaluation of E over the table,
    # argmin + tie-break via lexsort, memoized decision history.
    parts.append(textwrap.dedent(f'''\
        def choose({d_sig}, margin=0.02):
            """Select optimal launch parameters for data parameters D.

            Evaluates E once over the whole candidate table, keeps configs
            within ``margin`` of the minimum, and breaks ties by occupancy:
            most blocks per SM, then fewest grid steps (the secondary metric
            of Section IV step 5).  Memoized per D.
            """
            key = ({d_sig},)
            hit = _HISTORY.get(key)
            if hit is not None:
                return dict(zip(PROGRAM_PARAMS, hit))
            cols = candidates({d_sig})
        ''') + unpack + f'''
    if {p_names[0]}.size == 0:
        raise ValueError("no feasible launch configuration")
    est = np.asarray(estimate({sig}), dtype=np.float64)
    near = est <= float(np.min(est)) * (1.0 + margin)
    blocks = np.broadcast_to(blocks_per_sm({sig}), est.shape)
    steps = np.broadcast_to(grid_steps({sig}), est.shape)
    # lexsort: last key is primary -- near-optimal first, then most blocks
    # per SM, then fewest grid steps.
    order = np.lexsort((np.asarray(steps, dtype=np.float64),
                        -np.asarray(blocks, dtype=np.float64), ~near))
    pick = int(order[0])
    cfg = tuple(int(cols[p][pick]) for p in PROGRAM_PARAMS)
    _HISTORY[key] = cfg
    return dict(zip(PROGRAM_PARAMS, cfg))
''')

    return "\n\n".join(parts)


def compile_driver_module(source: str) -> dict:
    """Exec the generated driver source; returns its namespace."""
    ns: dict = {}
    exec(compile(source, "<klaraptor-driver>", "exec"), ns)
    return ns
