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
  * ``_feasible``: the one feasibility mask, generated from the spec's
    parameter grids, its Python-syntax constraint strings (the
    user-written configuration files of Section V-A) and the Hopper launch
    limits that ``KernelSpec.feasible_mask`` applies, as vectorized masks
    over S shapes x a columnar candidate table; ``candidates(**D)`` is its
    one-shape case,
  * ``choose_many(**D_columns)``: steps 4-6's selection for S shapes at
    once (the launch-plan compiler, core/plan.py) -- evaluate E once over
    shapes x candidates, argmin + the occupancy tie-break heuristic as
    masked reductions in numpy, chosen rows memoized into a decision
    history,
  * ``choose(**D)``: the runtime selection, the decision history's entry
    for D, else ``choose_many`` on that one shape.

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
    """Whether a constraint string evaluates cleanly with program
    parameters as (C,) columns and data parameters as (S, 1) columns, as
    ``_feasible`` binds them (boolean `and`/`or`, chained comparisons and
    ``min(m, 1024)`` break on arrays whatever the values, so probing with
    dummy columns decides)."""
    env: dict = {p: np.array([8, 16], dtype=np.int64)
                 for p in spec.program_params}
    env.update({d: np.array([[64], [128]], dtype=np.int64)
                for d in spec.data_params})
    try:
        res = eval(c, {"__builtins__": {}, "math": math, "np": np}, env)
        np.broadcast_to(np.asarray(res, dtype=bool), (2, 2))
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

    # _feasible(): the one feasibility mask, (S, C) over S shapes x the
    # candidate table, mirroring KernelSpec.feasible_mask line for line.
    # D columns are reshaped to (S, 1) so every D-only subexpression is
    # evaluated once per shape; a constraint that resists those columns is
    # evaluated row by row.  candidates() is its one-shape case.
    d_sig = ", ".join(spec.data_params)
    p_names = list(spec.program_params)
    unpack = "\n".join(f"    {p} = cols[{p!r}]" for p in p_names)
    d_unpack = "\n".join(f"    {d} = _d_flat[{i}].reshape(-1, 1)"
                         for i, d in enumerate(spec.data_params))
    row_idx = [i for i, c in enumerate(spec.constraints)
               if not _constraint_vectorizable(c, spec)]
    feas_srcs = [f"    feas &= ({c})" for i, c in enumerate(spec.constraints)
                 if i not in row_idx]
    for a in spec.grid:
        if a.block is not None and isinstance(a.data, str) and not a.ragged:
            feas_srcs.append(f"    feas &= ({a.block} <= {a.data}) & "
                             f"({a.data} % {a.block} == 0)")
    feas_lines = "\n".join(feas_srcs)
    row_scalars = "{" + ", ".join(
        f"{d!r}: int(_d_flat[{i}][_s])"
        for i, d in enumerate(spec.data_params)) + "}"
    row_block = "" if not row_idx else f'''\
    for _ci in {tuple(row_idx)!r}:
        for _s in range(feas.shape[0]):
            feas[_s] &= _row_mask(_ci, {row_scalars}, cols)
'''
    parts.append(textwrap.dedent('''\
        def _table():
            """The full candidate table: one int64 column per program
            parameter, the cross product of PARAM_CANDIDATES."""
            grids = np.meshgrid(
                *[np.asarray(PARAM_CANDIDATES[p], dtype=np.int64)
                  for p in PROGRAM_PARAMS], indexing="ij")
            return {p: g.reshape(-1) for p, g in zip(PROGRAM_PARAMS, grids)}


        def _shape_columns(*D):
            """Data parameters (scalars or 1-D arrays, broadcast) as S-long
            int64 columns."""
            return np.broadcast_arrays(*[
                np.asarray(_x, dtype=np.int64).reshape(-1) for _x in D])
        '''))
    parts.append(f'''\
def _feasible(_d_flat, cols):
    """(S, C) feasibility of every candidate at S shapes: the spec's
    constraints, divisibility of non-ragged tiles, shared memory, threads
    and registers."""
{d_unpack}
{unpack}
    feas = np.ones((_d_flat[0].shape[0], {p_names[0]}.shape[0]), dtype=bool)
''' + (feas_lines + "\n" if feas_lines else "") + row_block + f'''\
    t = np.rint(threads({sig}))
    feas &= np.rint(stage_bytes({sig})) <= SMEM_PER_BLOCK
    feas &= (t >= WARP_SIZE) & (t <= MAX_THREADS_PER_BLOCK)
    feas &= t * REGS_PER_THREAD <= REGS_PER_SM
    feas &= REGS_PER_THREAD <= MAX_REGS_PER_THREAD
    return feas


def candidates({d_sig}):
    """Columnar feasible configuration table at one shape: one int64
    ndarray per program parameter."""
    cols = _table()
    mask = _feasible(_shape_columns({d_sig}), cols)[0]
    return {{p: c[mask] for p, c in cols.items()}}
''')

    # choose_many(): steps 4-6 batched over S shapes -- one (S, C)
    # evaluation of E, then per shape the near-optimal rows (all feasible
    # rows when none is near, as when the minimum is NaN), most blocks per
    # SM, fewest grid steps, lowest candidate index, as masked reductions.
    # choose() is its one-shape case behind the decision history.
    parts.append(f'''\
def choose_many({d_sig}, margin=0.02):
    """Select launch parameters for S shapes in one (S, C) pass.

    Each data parameter is a 1-D array of S values (scalars broadcast).
    Returns ``(configs, ok)``: ``configs`` maps each program parameter to
    an (S,) int64 column, ``ok`` flags the shapes with a feasible
    configuration (rows with ``ok`` False hold zeros).  Every chosen row
    joins the decision history.
    """
    _d_flat = _shape_columns({d_sig})
    cols = _table()
    feas = _feasible(_d_flat, cols)
{d_unpack}
{unpack}
    ok = feas.any(axis=1)
    # infeasible candidates may divide by zero; their values are masked
    with np.errstate(all="ignore"):
        est = np.broadcast_to(np.asarray(estimate({sig}),
                                         dtype=np.float64), feas.shape)
        blocks = np.broadcast_to(np.asarray(blocks_per_sm({sig}),
                                            dtype=np.float64), feas.shape)
        steps = np.broadcast_to(np.asarray(grid_steps({sig}),
                                           dtype=np.float64), feas.shape)
        low = np.where(feas, est, np.inf).min(axis=1, keepdims=True)
        near = feas & (est <= low * (1.0 + margin))
    near = np.where(near.any(axis=1, keepdims=True), near, feas)
    tie = np.where(near & ~np.isnan(blocks), blocks, -np.inf)
    near &= tie == tie.max(axis=1, keepdims=True)
    tie = np.where(near & ~np.isnan(steps), steps, np.inf)
    near &= tie == tie.min(axis=1, keepdims=True)
    pick = np.argmax(near, axis=1)
    out = {{p: np.where(ok, c[pick], 0).astype(np.int64)
           for p, c in cols.items()}}
    for _s in np.flatnonzero(ok):
        _HISTORY[tuple(int(a[_s]) for a in _d_flat)] = \\
            tuple(int(out[p][_s]) for p in PROGRAM_PARAMS)
    return out, ok


def choose({d_sig}, margin=0.02):
    """Select optimal launch parameters for data parameters D: E over the
    whole candidate table, configs within ``margin`` of the minimum, ties
    broken by occupancy -- most blocks per SM, then fewest grid steps (the
    secondary metric of Section IV step 5).  Memoized per D."""
    hit = _HISTORY.get(({d_sig},))
    if hit is not None:
        return dict(zip(PROGRAM_PARAMS, hit))
    out, ok = choose_many({d_sig}, margin=margin)
    if not ok[0]:
        raise ValueError("no feasible launch configuration")
    return {{p: int(out[p][0]) for p in PROGRAM_PARAMS}}
''')

    return "\n\n".join(parts)


def compile_driver_module(source: str) -> dict:
    """Exec the generated driver source; returns its namespace."""
    ns: dict = {}
    exec(compile(source, "<klaraptor-driver>", "exec"), ns)
    return ns
