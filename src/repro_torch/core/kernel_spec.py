"""Kernel specifications: the (D, P) interface of a tunable CUDA kernel.

A KernelSpec is the paper's annotated CUDA kernel (Section V-A): it names
the data parameters D, the program parameters P (here the tile sizes that
fix the thread-block shape), and carries the *constraint strings in Python
syntax* that the paper has users write into configuration files.

From the spec we derive, fully analytically, both as numbers over a
candidate table and as rational-program ``Expr``s for the performance model
(one source of truth: the numbers are the ``Expr``s evaluated):

  * the launch geometry -- CTAs over the parallel grid axes, and a loop
    inside the block over the sequential axes (where the TPU had a
    sequential grid axis, a CUDA block loops);
  * threads per CTA and shared memory per CTA (the staged tiles,
    single-buffered), then blocks per SM from ``cuda_occupancy_program``,
    CTA waves, blocks resident per SM in a wave, and grid steps
    (waves x loop iterations);
  * per-operand traffic: an input tile that depends on a sequential axis is
    loaded once per iteration of every CTA, any other input once per CTA;
    an output tile is written once per position over the parallel axes it
    depends on (once per CTA when it depends on them all; once per column
    block for the column sum, whose last CTA of a block writes it).

Feasibility on Hopper (``feasible_mask``) replaces the TPU's VMEM and
lane/sublane rules: staged shared memory per block within the opt-in
limit, threads per CTA in [warp size, max threads per block], registers per
thread within the per-thread limit and registers x threads within the SM's
register file, tiles no larger than the data and dividing it along every
axis whose kernel takes no ragged edge (a ``ragged`` axis is masked by the
kernel, so any tile fits it), plus the spec's own granularity constraints.
"""

from __future__ import annotations

import ast
import functools
import math
import re
from dataclasses import dataclass, field
from typing import Mapping, Sequence

import numpy as np

from .device_model import HardwareParams, TrafficOperand, TrafficTable, H100
from .occupancy import cuda_occupancy_program
from .rational_program import (BinOp, Ceil, Const, Expr, Floor, Max, Min,
                               Select, Var, ceil_div, const, var)

__all__ = [
    "Operand", "GridAxis", "KernelSpec", "CandidateTable", "SpecError",
    "POLYBENCH_LAUNCH_ALIASES", "POLYBENCH_SUITE",
    "flash_attention_spec", "flash_probe_data", "gmm_probe_data",
    "matmul_spec", "moe_gmm_spec", "polybench_suite", "sm90_smem_bytes",
    "ssd_probe_data", "ssd_scan_spec", "ssd_uses_sm90", "substitute",
]

Dims = Mapping[str, int]


class SpecError(ValueError):
    """A constraint string is malformed or references a symbol that is
    neither a data parameter, a program parameter, nor ``math``/``np``."""


@functools.lru_cache(maxsize=4096)
def _constraint_names(constraint: str) -> frozenset[str]:
    """Bare symbols referenced by a constraint expression."""
    try:
        tree = ast.parse(constraint, mode="eval")
    except SyntaxError as e:
        raise SpecError(
            f"constraint {constraint!r} is not a valid Python expression: "
            f"{e.msg}") from e
    return frozenset(n.id for n in ast.walk(tree)
                     if isinstance(n, ast.Name))


def _check_constraint_symbols(constraint: str, known: set[str],
                              spec_name: str) -> None:
    try:
        names = _constraint_names(constraint)
    except SpecError as e:
        raise SpecError(f"spec {spec_name!r}: {e}") from None
    unknown = sorted(names - known)
    if unknown:
        raise SpecError(
            f"constraint {constraint!r} of spec {spec_name!r} references "
            f"unknown symbol(s) {', '.join(map(repr, unknown))}; known "
            f"symbols are the data/program parameters "
            f"{sorted(known - {'math', 'np'})} plus 'math' and 'np'")


def substitute(e: Expr, bindings: Mapping[str, Expr]) -> Expr:
    """Replace variables of ``e`` by expressions (no folding)."""
    if isinstance(e, Var):
        return bindings.get(e.name, e)
    if isinstance(e, BinOp):
        return BinOp(e.op, substitute(e.lhs, bindings),
                     substitute(e.rhs, bindings))
    if isinstance(e, (Min, Max)):
        return type(e)(substitute(e.lhs, bindings),
                       substitute(e.rhs, bindings))
    if isinstance(e, (Floor, Ceil)):
        return type(e)(substitute(e.arg, bindings))
    if isinstance(e, Select):
        return Select(substitute(e.cond, bindings),
                      substitute(e.if_true, bindings),
                      substitute(e.if_false, bindings))
    if isinstance(e, Const):
        return e
    raise TypeError(f"cannot substitute into {type(e).__name__}")


@dataclass
class CandidateTable:
    """Struct-of-arrays configuration set: one int64 column per program
    parameter -- the columnar contract of the whole pipeline."""

    params: tuple[str, ...]
    columns: dict[str, np.ndarray]

    def __post_init__(self) -> None:
        self.columns = {p: np.asarray(c, dtype=np.int64)
                        for p, c in self.columns.items()}

    def __len__(self) -> int:
        if not self.params:
            return 0
        return int(self.columns[self.params[0]].shape[0])

    def __bool__(self) -> bool:
        return len(self) > 0

    def __getitem__(self, param: str) -> np.ndarray:
        return self.columns[param]

    def row(self, i: int) -> dict[str, int]:
        return {p: int(self.columns[p][i]) for p in self.params}

    def select(self, index) -> "CandidateTable":
        return CandidateTable(
            self.params, {p: c[index] for p, c in self.columns.items()})

    @classmethod
    def from_rows(cls, params: Sequence[str],
                  rows: Sequence[Mapping[str, int]]) -> "CandidateTable":
        params = tuple(params)
        return cls(params, {
            p: np.array([r[p] for r in rows], dtype=np.int64) for p in params})

    @classmethod
    def product(cls, params: Sequence[str],
                axes: Sequence[Sequence[int]]) -> "CandidateTable":
        """Full Cartesian grid over per-parameter candidate values."""
        params = tuple(params)
        if not params:
            return cls(params, {})
        grids = np.meshgrid(*[np.asarray(a, dtype=np.int64) for a in axes],
                            indexing="ij")
        return cls(params, {p: g.reshape(-1)
                            for p, g in zip(params, grids)})


@dataclass(frozen=True)
class GridAxis:
    """One grid dimension: extent = ceil(D[data] / P[block]) (or a literal).

    A ``sequential`` axis is not a grid dimension of the CUDA launch but
    the loop every block runs inside itself.  A ``ragged`` axis is one whose
    kernel masks the last, partial block, so its tile need not divide the
    data.
    """

    name: str
    data: str | int
    block: str | None = None
    sequential: bool = False
    ragged: bool = False

    def extent_expr(self) -> Expr:
        total = var(self.data) if isinstance(self.data, str) \
            else Const(float(self.data))
        if self.block is None:
            return total
        return ceil_div(total, var(self.block))


@dataclass(frozen=True)
class Operand:
    """One kernel operand with its tile template and grid dependencies.

    ``tile``: each entry is a program-param name, data-param name or literal.
    ``deps``: grid axis names the tile's position depends on.
    ``staged``: the tile is held in shared memory.
    ``scratch``: the tile lives in shared memory only (counted in the stage
    bytes, never read from or written to device memory).
    """

    name: str
    tile: tuple[str | int, ...]
    deps: tuple[str, ...]
    dtype_bytes: int = 2
    is_output: bool = False
    staged: bool = False
    scratch: bool = False


def _product(exprs: Sequence[Expr]) -> Expr:
    out: Expr = Const(1.0)
    for e in exprs:
        out = out * e
    return out


@dataclass
class KernelSpec:
    name: str
    data_params: tuple[str, ...]
    program_params: tuple[str, ...]
    grid: tuple[GridAxis, ...]
    operands: tuple[Operand, ...]
    # FLOPs per point of the grid's data domain: a number, or an Expr over
    # the program params where the kernel's work per point depends on them.
    flops_per_point: float | Expr
    threads: Expr                   # threads per CTA over the program params
    regs_per_thread: int            # what the kernel is compiled to
    constraints: tuple[str, ...] = ()
    param_candidates: dict[str, tuple[int, ...]] = field(default_factory=dict)
    fit_vars: dict[str, tuple[str, ...]] = field(default_factory=dict)
    # Identity of the compiled kernel a derived spec was read from
    # (``repro_torch.introspect``); empty on hand-written specs.
    source_fingerprint: str = ""
    # The unit the kernel's FLOPs run on (``HardwareParams.peak_flops``):
    # "f32" FMAs on the CUDA cores, or "bf16" on the tensor cores.
    compute_unit: str = "f32"

    # -- symbolic launch geometry (rational-program Exprs) ---------------------
    def ctas_expr(self) -> Expr:
        return _product([a.extent_expr() for a in self.grid
                         if not a.sequential])

    def seq_iters_expr(self) -> Expr:
        return _product([a.extent_expr() for a in self.grid if a.sequential])

    def stage_expr(self) -> Expr:
        """Shared-memory bytes per CTA: the staged tiles, one buffer each."""
        total: Expr = Const(0.0)
        for op in self.operands:
            if not (op.staged or op.scratch):
                continue
            tile = _product([var(t) if isinstance(t, str) else Const(float(t))
                             for t in op.tile])
            total = total + tile * Const(float(op.dtype_bytes))
        return total

    def blocks_per_sm_expr(self, hw: HardwareParams) -> Expr:
        """B_active of the Fig. 2 occupancy program for this kernel."""
        prog = cuda_occupancy_program()
        return substitute(prog.outputs["B_active"], {
            "R_max": const(float(hw.regs_per_sm)),
            "Z_max": const(float(hw.smem_per_sm)),
            "T_max": const(float(hw.max_threads_per_sm)),
            "B_max": const(float(hw.max_blocks_per_sm)),
            "W_max": const(float(hw.max_warps_per_sm)),
            "R": const(float(self.regs_per_thread)),
            "Z": self.stage_expr() + const(float(hw.smem_reserved_per_block)),
            "T": self.threads,
        })

    def waves_expr(self, hw: HardwareParams) -> Expr:
        """ceil(CTAs / (SMs x active blocks per SM))."""
        return Ceil(self.ctas_expr() / (const(float(hw.sm_count))
                                        * self.blocks_per_sm_expr(hw)))

    def resident_expr(self, hw: HardwareParams) -> Expr:
        """Blocks resident per SM in one wave (<= B_active)."""
        return Ceil(self.ctas_expr() / (const(float(hw.sm_count))
                                        * self.waves_expr(hw)))

    def grid_steps_expr(self, hw: HardwareParams) -> Expr:
        """Waves x loop iterations: the busiest SM's sequential steps."""
        return self.waves_expr(hw) * self.seq_iters_expr()

    # -- the same quantities over a candidate table ----------------------------
    def _eval(self, expr: Expr, D: Dims, table: CandidateTable) -> np.ndarray:
        env = {d: float(v) for d, v in D.items()}
        env.update(table.columns)
        out = np.broadcast_to(np.asarray(expr.eval(env), dtype=np.float64),
                              (len(table),))
        return np.rint(out).astype(np.int64)

    def _tile_columns(self, op: Operand, D: Dims,
                      table: CandidateTable) -> np.ndarray:
        n = len(table)
        cols = []
        for t in op.tile:
            if isinstance(t, str) and t in table.columns:
                cols.append(table[t])
            else:
                v = D[t] if isinstance(t, str) else int(t)
                cols.append(np.full(n, int(v), dtype=np.int64))
        return np.stack(cols, axis=1)

    def flops_total(self, D: Dims, table: CandidateTable) -> np.ndarray:
        """(n,) FLOPs of one launch of every config in ``table``."""
        points = 1.0
        for a in self.grid:
            points *= D[a.data] if isinstance(a.data, str) else a.data
        per = self.flops_per_point
        if isinstance(per, Expr):
            env = {d: float(v) for d, v in D.items()}
            env.update(table.columns)
            per = per.eval(env)
        return np.broadcast_to(np.asarray(per, dtype=np.float64) * points,
                               (len(table),)).copy()

    def traffic_table(self, D: Dims, table: CandidateTable,
                      hw: HardwareParams = H100) -> TrafficTable:
        """Launch geometry and operand traffic of every config in ``table``."""
        ctas = self._eval(self.ctas_expr(), D, table)
        extents = {a.name: self._eval(a.extent_expr(), D, table)
                   for a in self.grid}
        iters = {a.name: extents[a.name] for a in self.grid if a.sequential}
        operands = []
        for op in self.operands:
            if op.scratch:
                continue
            if op.is_output:
                # written once per position: over the parallel axes it
                # depends on (the CTAs of other positions write no tile)
                fetches = np.ones_like(ctas)
                for d in op.deps:
                    if d not in iters:
                        fetches = fetches * extents[d]
            else:
                fetches = ctas.copy()
                for d in op.deps:
                    if d in iters:
                        fetches = fetches * iters[d]
            operands.append(TrafficOperand(
                name=op.name, shapes=self._tile_columns(op, D, table),
                fetches=fetches, dtype_bytes=op.dtype_bytes,
                is_output=op.is_output))
        return TrafficTable(
            kernel=self.name,
            D=dict(D),
            config={p: table[p] for p in self.program_params},
            ctas=ctas,
            seq_iters=self._eval(self.seq_iters_expr(), D, table),
            threads=self._eval(self.threads, D, table),
            stage_bytes=self._eval(self.stage_expr(), D, table),
            blocks_per_sm=self._eval(self.blocks_per_sm_expr(hw), D, table),
            blocks_resident=self._eval(self.resident_expr(hw), D, table),
            grid_steps=self._eval(self.grid_steps_expr(hw), D, table),
            flops_total=self.flops_total(D, table),
            operands=operands,
            compute_unit=self.compute_unit,
        )

    # -- feasibility / enumeration (Section IV step 4) -------------------------
    def feasible_mask(self, D: Dims, table: CandidateTable,
                      hw: HardwareParams = H100) -> np.ndarray:
        """(n,) bool: the spec's constraints plus the Hopper launch limits.

        Constraint strings are evaluated once with ndarray columns bound to
        the program parameters in a restricted namespace (no builtins); a
        constraint that resists array evaluation is evaluated row by row.
        """
        n = len(table)
        mask = np.ones(n, dtype=bool)
        env: dict[str, object] = {k: int(v) for k, v in D.items()}
        env.update(table.columns)
        known = set(env) | {"math", "np"}
        globs = {"__builtins__": {}, "math": math, "np": np}
        for c in self.constraints:
            _check_constraint_symbols(c, known, self.name)
            try:
                res = eval(c, globs, dict(env))
                mask &= np.broadcast_to(np.asarray(res, dtype=bool), (n,))
            except Exception:
                ok = np.zeros(n, dtype=bool)
                for i in range(n):
                    row = {**{k: int(v) for k, v in D.items()}, **table.row(i)}
                    try:
                        ok[i] = bool(eval(c, globs, row))
                    except Exception:
                        ok[i] = False
                mask &= ok
        threads = self._eval(self.threads, D, table)
        mask &= self._eval(self.stage_expr(), D, table) \
            <= hw.smem_per_block_optin
        mask &= (threads >= hw.warp_size) & \
            (threads <= hw.max_threads_per_block)
        mask &= threads * self.regs_per_thread <= hw.regs_per_sm
        mask &= self.regs_per_thread <= hw.max_regs_per_thread
        for a in self.grid:
            if a.block is not None and isinstance(a.data, str) \
                    and not a.ragged:
                size = int(D[a.data])
                # a block named by a data parameter spans that extent
                block = table[a.block] if a.block in table.columns \
                    else int(D[a.block])
                mask &= (block <= size) & (size % block == 0)
        return mask

    def default_candidates(self, param: str) -> tuple[int, ...]:
        if param in self.param_candidates:
            return self.param_candidates[param]
        return tuple(2 ** i for i in range(3, 10))

    def candidates(self, D: Dims, hw: HardwareParams = H100
                   ) -> CandidateTable:
        """Columnar feasible configuration table at data size D."""
        axes = [self.default_candidates(p) for p in self.program_params]
        table = CandidateTable.product(self.program_params, axes)
        return table.select(self.feasible_mask(D, table, hw))

    def alignment(self, param: str) -> int:
        """Granularity of ``param`` from constraints of the form
        ``param % N == 0`` (1 when the spec states none)."""
        pat = re.compile(rf"^\s*{re.escape(param)}\s*%\s*(\d+)\s*==\s*0\s*$")
        align = 1
        for c in self.constraints:
            hit = pat.match(c)
            if hit:
                align = math.lcm(align, int(hit.group(1)))
        return align

    def metric_fit_vars(self, metric: str) -> tuple[str, ...]:
        if metric in self.fit_vars:
            return self.fit_vars[metric]
        return tuple(self.program_params)


# ---------------------------------------------------------------------------
# Concrete specs for the port's CUDA kernels in src/repro_torch/kernels/
# ---------------------------------------------------------------------------

# kernels/csrc/matmul.cu, f32: each thread owns an 8 x 8 block of C in
# registers, and __launch_bounds__(512) caps it at 128 registers per thread.
MATMUL_MICRO_TILE = 8
MATMUL_REGS_PER_THREAD = 128

# kernels/csrc/gemm_sm90.cuh, the bf16 matmul and grouped matmul: one
# consumer warpgroup per 64 rows of the tile (2 * bm threads), wgmma's
# 64-row, 64-column and one-swizzle-atom (64 bf16 along k) granules, a ring
# of SM90_STAGES (bm, bk) + (bk, bn) slots plus SM90_SMEM_EXTRA bytes (the
# ring's barriers and its 1 KiB alignment), and __launch_bounds__(256, 1),
# which caps registers at 255 per thread.
SM90_STAGES = 4
SM90_GRANULE = 64
SM90_SMEM_EXTRA = 1024 + 2 * SM90_STAGES * 8
SM90_REGS_PER_THREAD = 255
SM90_CANDIDATES = {"m": (64, 128), "n": (64, 128, 256), "k": (64, 128)}


def sm90_smem_bytes(bm: int, bn: int, bk: int) -> int:
    """Dynamic shared memory of one bf16 wgmma CTA: the ring and its
    barriers."""
    return SM90_STAGES * (bm + bn) * bk * 2 + SM90_SMEM_EXTRA


# The compiled tiles (GEMM_SM90_TILES in gemm_sm90.cuh): every candidate
# whose ring fits the shared memory a block may have.
SM90_TILES = tuple(
    (bm, bn, bk) for bm in SM90_CANDIDATES["m"]
    for bn in SM90_CANDIDATES["n"] for bk in SM90_CANDIDATES["k"]
    if sm90_smem_bytes(bm, bn, bk) <= H100.smem_per_block_optin)


def _sm90_gemm_spec(name: str, data_params: tuple[str, ...], rows: str,
                    grid: tuple[GridAxis, ...], lhs: str, rhs: str,
                    batch: tuple[str, ...]) -> KernelSpec:
    """The wgmma kernel's spec.  Operands: the staged x and y tiles of one
    k step, the output, and the ring's other SM90_STAGES - 1 slots and its
    barriers as scratch (shared memory that moves no bytes of its own)."""
    params = (rows, "bn", "bk")
    ring = SM90_STAGES - 1
    return KernelSpec(
        name=name,
        data_params=data_params,
        program_params=params,
        grid=grid,
        operands=(
            Operand(lhs, (rows, "bk"), (*batch, "i", "l"), 2, staged=True),
            Operand(rhs, ("bk", "bn"), (*batch, "l", "j"), 2, staged=True),
            Operand("out", (rows, "bn"), (*batch, "i", "j"), 2,
                    is_output=True),
            Operand(f"{lhs}_ring", (ring, rows, "bk"), (), 2, scratch=True),
            Operand(f"{rhs}_ring", (ring, "bk", "bn"), (), 2, scratch=True),
            Operand("ring_barriers", (SM90_SMEM_EXTRA,), (), 1, scratch=True),
        ),
        flops_per_point=2.0,  # one multiply-add per point of the domain
        threads=var(rows) * const(2.0),
        regs_per_thread=SM90_REGS_PER_THREAD,
        # wgmma's 64 rows per warpgroup, 64-column B boxes and 64-wide
        # swizzle atoms along k.
        constraints=tuple(f"{p} % {SM90_GRANULE} == 0" for p in params),
        param_candidates={rows: SM90_CANDIDATES["m"],
                          "bn": SM90_CANDIDATES["n"],
                          "bk": SM90_CANDIDATES["k"]},
        fit_vars={m: params for m in ("mem_step", "cmp_step", "ovh_step")},
        compute_unit="bf16",
    )


def matmul_spec(dtype_bytes: int = 2) -> KernelSpec:
    """C[m,n] = A[m,k] @ B[k,n]: CTAs over (i, j), a loop over k inside.

    bf16 (``dtype_bytes=2``) runs the wgmma mainloop on the tensor cores:
    2 * bm threads, the nine compiled (bm, bn, bk) tiles (``SM90_TILES``),
    granules of 64, and shared memory for a ring of ``SM90_STAGES`` slots,
    of which the traffic counts one fetch per k step.  f32 runs the SIMT
    body: (bm, bn) is the thread-block shape, bm * bn / 64 threads, one
    8 x 8 micro-tile each.  A (bm, bk) and B (bk, bn) tiles are staged in
    shared memory; the f32 accumulators are registers and move no bytes.
    """
    grid = (GridAxis("i", "m", "bm"), GridAxis("j", "n", "bn"),
            GridAxis("l", "k", "bk", sequential=True))
    if dtype_bytes == 2:
        return _sm90_gemm_spec("matmul_b16", ("m", "n", "k"), "bm", grid,
                               "lhs", "rhs", ())
    tile = float(MATMUL_MICRO_TILE * MATMUL_MICRO_TILE)
    return KernelSpec(
        name=f"matmul_b{dtype_bytes * 8}",
        data_params=("m", "n", "k"),
        program_params=("bm", "bn", "bk"),
        grid=grid,
        operands=(
            Operand("lhs", ("bm", "bk"), ("i", "l"), dtype_bytes, staged=True),
            Operand("rhs", ("bk", "bn"), ("l", "j"), dtype_bytes, staged=True),
            Operand("out", ("bm", "bn"), ("i", "j"), dtype_bytes,
                    is_output=True),
        ),
        flops_per_point=2.0,  # over the (m, n, k) domain: one FMA per point
        threads=var("bm") * var("bn") / const(tile),
        regs_per_thread=MATMUL_REGS_PER_THREAD,
        # 8 x 8 micro-tiles, and 16-byte vector loads along k and n.
        constraints=("bm % 8 == 0", "bn % 8 == 0", "bk % 8 == 0"),
        param_candidates={
            "bm": (16, 32, 64, 128, 256, 512),
            "bn": (16, 32, 64, 128, 256, 512),
            "bk": (8, 16, 32, 64, 128, 256),
        },
        fit_vars={
            "mem_step": ("bm", "bn", "bk"),
            "cmp_step": ("bm", "bn", "bk"),
            "ovh_step": ("bm", "bn", "bk"),
        },
    )


# kernels/csrc/moe_gmm.cu, f32: csrc/matmul.cu's SIMT body with the expert
# on blockIdx.z, the same 8 x 8 micro-tiles and __launch_bounds__(512).
GMM_REGS_PER_THREAD = 128


def moe_gmm_spec(dtype_bytes: int = 2) -> KernelSpec:
    """out[e] = x[e] @ w[e], x (e, g, k), w (e, k, n): CTAs over (ex, i, j),
    a loop over k inside.

    bf16 runs the wgmma mainloop with the expert on blockIdx.z, as
    ``matmul_spec(2)`` states it: 2 * bg threads, the compiled tiles,
    granules of 64 and the ring's shared memory.  f32 runs the SIMT body:
    (bg, bn) is the thread-block shape, bg * bn / 64 threads, one 8 x 8
    micro-tile each.  Token (bg, bk) and weight (bk, bn) tiles are staged in
    shared memory; the f32 accumulators are registers.  The TPU rules of
    the reference spec (``bg <= 8 * g``, ``bn % 128``) do not carry over:
    the kernel's granules plus the Hopper shared-memory, thread and register
    limits replace them.
    """
    grid = (GridAxis("ex", "e", None), GridAxis("i", "g", "bg"),
            GridAxis("j", "n", "bn"),
            GridAxis("l", "k", "bk", sequential=True))
    if dtype_bytes == 2:
        return _sm90_gemm_spec("moe_gmm_b16", ("e", "g", "k", "n"), "bg",
                               grid, "tokens", "weights", ("ex",))
    tile = float(MATMUL_MICRO_TILE * MATMUL_MICRO_TILE)
    return KernelSpec(
        name=f"moe_gmm_b{dtype_bytes * 8}",
        data_params=("e", "g", "k", "n"),
        program_params=("bg", "bn", "bk"),
        grid=grid,
        operands=(
            Operand("tokens", ("bg", "bk"), ("ex", "i", "l"), dtype_bytes,
                    staged=True),
            Operand("weights", ("bk", "bn"), ("ex", "l", "j"), dtype_bytes,
                    staged=True),
            Operand("out", ("bg", "bn"), ("ex", "i", "j"), dtype_bytes,
                    is_output=True),
        ),
        flops_per_point=2.0,  # over the (e, g, n, k) domain
        threads=var("bg") * var("bn") / const(tile),
        regs_per_thread=GMM_REGS_PER_THREAD,
        constraints=("bg % 8 == 0", "bn % 8 == 0", "bk % 8 == 0"),
        param_candidates={
            "bg": (16, 32, 64, 128, 256, 512),
            "bn": (16, 32, 64, 128, 256, 512),
            "bk": (8, 16, 32, 64, 128, 256),
        },
        fit_vars={
            "mem_step": ("bg", "bn", "bk"),
            "cmp_step": ("bg", "bn", "bk"),
            "ovh_step": ("bg", "bn", "bk"),
        },
    )


def gmm_probe_data(experts: Sequence[int] = (2, 4),
                   sizes: Sequence[int] = (256, 1024)
                   ) -> list[dict[str, int]]:
    """Small probe sizes for a grouped-matmul spec: few experts (the
    reference's ``probe_hints={"e": (2, 4)}``) and g, k, n <= 1024."""
    return [{"e": int(e), "g": int(g), "k": int(k), "n": int(n)}
            for e in experts for g in sizes for k in sizes for n in sizes]


# kernels/csrc/flash_attention.cu, f32 and bf16 at head dim 256 (the SIMT
# body): a CTA of 4 * bq threads, each owning 4 query rows; __launch_bounds__
# caps registers at 128 per thread for head dims up to 128 (512 threads) and
# at 255 for head dim 256 (256 threads).
FLASH_HEAD_DIMS = (64, 128, 256)
FLASH_THREADS_PER_ROW = 4
FLASH_PAD = 16      # f32 words of padding per row of the staged P tile


def flash_regs_per_thread(head_dim: int) -> int:
    """The register cap the SIMT flash kernel of ``head_dim`` is compiled
    to."""
    if head_dim not in FLASH_HEAD_DIMS:
        raise ValueError(f"no flash kernel for head dim {head_dim}; the "
                         f"kernel is built for {FLASH_HEAD_DIMS}")
    return 255 if head_dim == 256 else 128


# kernels/csrc/flash_attention.cu, bf16 at head dims 64 and 128 (the wgmma
# body): one consumer warpgroup per 64 query rows (2 * bq threads), the (bq,
# d) Q tile and a ring of FLASH_SM90_STAGES (bkv, d) K and V slots in shared
# memory, plus FLASH_SM90_SMEM_EXTRA bytes (the 1 KiB alignment and the full,
# empty and Q barriers), and __launch_bounds__(256, 1), which caps registers
# at 255 per thread.
FLASH_SM90_HEAD_DIMS = (64, 128)
FLASH_SM90_STAGES = 2
FLASH_SM90_GRANULE = 64
FLASH_SM90_SMEM_EXTRA = 1024 + (2 * FLASH_SM90_STAGES + 1) * 8
FLASH_SM90_REGS_PER_THREAD = 255
FLASH_SM90_CANDIDATES = {"bq": (64, 128), "bkv": (64, 128)}


def flash_uses_sm90(head_dim: int, dtype_bytes: int) -> bool:
    """Whether flash attention at this head dim and input width runs the
    wgmma body (bf16 at head dims 64 and 128) rather than the SIMT one."""
    return dtype_bytes == 2 and head_dim in FLASH_SM90_HEAD_DIMS


def flash_sm90_smem_bytes(head_dim: int, bq: int, bkv: int) -> int:
    """Dynamic shared memory of one wgmma flash CTA: Q, the K/V ring and
    the extra bytes."""
    return ((bq + 2 * FLASH_SM90_STAGES * bkv) * head_dim * 2
            + FLASH_SM90_SMEM_EXTRA)


# The compiled tiles (FLASH_SM90_TILES in flash_attention.cu): every (bq,
# bkv) candidate whose Q tile and ring fit the shared memory a block may
# have, at each head dim.
FLASH_SM90_TILES = {
    d: tuple((bq, bkv) for bq in FLASH_SM90_CANDIDATES["bq"]
             for bkv in FLASH_SM90_CANDIDATES["bkv"]
             if flash_sm90_smem_bytes(d, bq, bkv)
             <= H100.smem_per_block_optin)
    for d in FLASH_SM90_HEAD_DIMS}


def flash_attention_spec(head_dim: int = 128, causal: bool = True,
                         dtype_bytes: int = 2) -> KernelSpec:
    """Flash attention forward: CTAs over (bh, q blocks), a loop over kv
    blocks inside (online softmax).

    D: bh = batch * q heads (flattened), sq, skv.  P: bq, bkv.  FLOPs per
    (bh, sq, skv) point: 4 * d (QK^T and PV), halved when causal.  The
    kernel masks ragged q and kv tails, so tiles need not divide sq or skv.

    bf16 at head dims 64 and 128 runs the wgmma body on the tensor cores,
    as ``matmul_spec(2)`` states the GEMMs': 2 * bq threads, the compiled
    (bq, bkv) tiles (``FLASH_SM90_TILES``), granules of 64, the register cap
    255, and stage bytes of the Q tile and one K/V slot, with the ring's
    other slots and its barriers as scratch; P lives in registers.  f32, and
    bf16 at head dim 256, run the SIMT body: 4 * bq threads, Q, K and V
    tiles staged in shared memory and so is the f32 probability tile (bq,
    bkv) with 16 words of padding per row; m, l and the output accumulator
    are registers.
    """
    name = f"flash_attn_d{head_dim}" + ("_causal" if causal else "")
    grid = (GridAxis("b", "bh", None),
            GridAxis("iq", "sq", "bq", ragged=True),
            GridAxis("ikv", "skv", "bkv", sequential=True, ragged=True))
    tiles = (
        Operand("q", ("bq", head_dim), ("b", "iq"), dtype_bytes, staged=True),
        Operand("k", ("bkv", head_dim), ("b", "ikv"), dtype_bytes,
                staged=True),
        Operand("v", ("bkv", head_dim), ("b", "ikv"), dtype_bytes,
                staged=True),
        Operand("out", ("bq", head_dim), ("b", "iq"), dtype_bytes,
                is_output=True),
    )
    flops = 4.0 * head_dim * (0.5 if causal else 1.0)
    fit_vars = {m: ("bq", "bkv") for m in ("mem_step", "cmp_step", "ovh_step")}
    if flash_uses_sm90(head_dim, dtype_bytes):
        ring = FLASH_SM90_STAGES - 1
        return KernelSpec(
            name=name,
            data_params=("bh", "sq", "skv"),
            program_params=("bq", "bkv"),
            grid=grid,
            operands=tiles + (
                Operand("k_ring", (ring, "bkv", head_dim), (), 2,
                        scratch=True),
                Operand("v_ring", (ring, "bkv", head_dim), (), 2,
                        scratch=True),
                Operand("ring_barriers", (FLASH_SM90_SMEM_EXTRA,), (), 1,
                        scratch=True),
            ),
            flops_per_point=flops,
            threads=var("bq") * const(2.0),
            regs_per_thread=FLASH_SM90_REGS_PER_THREAD,
            # a warpgroup's 64 rows, and wgmma N in whole 64-wide K/V boxes
            constraints=(f"bq % {FLASH_SM90_GRANULE} == 0",
                         f"bkv % {FLASH_SM90_GRANULE} == 0"),
            param_candidates=dict(FLASH_SM90_CANDIDATES),
            fit_vars=fit_vars,
            compute_unit="bf16",
        )
    return KernelSpec(
        name=name,
        data_params=("bh", "sq", "skv"),
        program_params=("bq", "bkv"),
        grid=grid,
        operands=tiles + (
            Operand("p", ("bq", "bkv"), (), 4, scratch=True),
            Operand("p_pad", ("bq", FLASH_PAD), (), 4, scratch=True),
        ),
        flops_per_point=flops,
        threads=var("bq") * const(float(FLASH_THREADS_PER_ROW)),
        regs_per_thread=flash_regs_per_thread(head_dim),
        # 4 rows per thread and 16 threads across a row: bq % 16; the P tile
        # row is split over 16 lanes, bkv % 32 keeps its padding aligned.
        constraints=("bq % 16 == 0", "bkv % 32 == 0"),
        param_candidates={
            "bq": (16, 32, 64, 128),
            "bkv": (32, 64, 128),
        },
        fit_vars=fit_vars,
    )


def flash_probe_data(bhs: Sequence[int] = (4, 16, 64),
                     seqs: Sequence[int] = (256, 512, 1024)
                     ) -> list[dict[str, int]]:
    """Small probe sizes for a flash spec: few heads, sq = skv <= 1024
    (self-attention, the shape every model layer launches)."""
    return [{"bh": int(bh), "sq": int(s), "skv": int(s)}
            for bh in bhs for s in seqs]


# kernels/csrc/ssd_scan.cu: one launch whose CTAs each take one chunk of one
# (batch * head) row -- the SIMT body one chunk of SSD_COLS head-dim columns
# -- all in parallel, the chunk states passed from CTA to CTA through an f32
# ring in the L2 (SSD_STATE_SLOTS tiles of (n, columns) per chain).
# SIMT body (f32, and bf16 at shapes without a wgmma instantiation): CTAs of
# 256 threads, __launch_bounds__(256, 2), 128 registers per thread.
SSD_COLS = 16           # head-dim columns of the state (and of y) per CTA
SSD_ROWS = 32           # rows of one tile of the intra-chunk score matrix
SSD_GPAD = 4            # f32 words of padding per row of the score tile
SSD_THREADS = 256
SSD_REGS_PER_THREAD = 128
# wgmma body (bf16 at the compiled (d_head, d_state)): one warpgroup per 64
# rows of the chunk (2 * chunk threads), __launch_bounds__(256, 1), which
# caps registers at 255; the compiled chunks; shared memory for x, B, C, h_in
# as hi + lo bf16 tiles, dt and two f32 vectors of the chunk, and
# SSD_SM90_SMEM_EXTRA bytes (the 1 KiB alignment slack, the mbarrier and the
# ticket).
SSD_SM90_SHAPES = ((64, 128),)
SSD_SM90_CHUNKS = (64, 128)
SSD_SM90_GRANULE = 64
SSD_SM90_REGS_PER_THREAD = 255
SSD_SM90_SMEM_EXTRA = 1024 + 64
SSD_STATE_SLOTS = 2


def ssd_uses_sm90(d_head: int, d_state: int, elem_bytes: int) -> bool:
    """Whether the kernel runs its wgmma body at this shape and dtype."""
    return elem_bytes == 2 and (d_head, d_state) in SSD_SM90_SHAPES


def ssd_smem_bytes(chunk: int, d_state: int, elem_bytes: int,
                   d_head: int = SSD_COLS) -> int:
    """Dynamic shared memory of one SSD CTA.  wgmma body: x (chunk x dh), B
    and C (chunk x n) and h_in's hi and lo (n x dh) in bf16, dt, the running
    sum and the weights (f32 each), and SSD_SM90_SMEM_EXTRA.  SIMT body: the
    chunk's B and C (chunk x n) and x columns (chunk x SSD_COLS) in the input
    type, dt, its running sum and the weights (f32), one padded f32 score
    tile (SSD_ROWS x chunk) and the f32 state columns (n x SSD_COLS)."""
    if ssd_uses_sm90(d_head, d_state, elem_bytes):
        return ((chunk * d_head + 2 * chunk * d_state + 2 * d_state * d_head)
                * 2 + 12 * chunk + SSD_SM90_SMEM_EXTRA)
    return ((2 * d_state + SSD_COLS) * chunk * elem_bytes + 12 * chunk
            + 4 * SSD_ROWS * (chunk + SSD_GPAD) + 4 * d_state * SSD_COLS)


def ssd_scan_spec(d_head: int = 64, d_state: int = 128,
                  dtype_bytes: int = 2) -> KernelSpec:
    """Mamba-2 SSD chunked scan (state-space duality, arXiv:2405.21060):
    every chunk of every (batch * head) row is a CTA of its own, and the
    chunk states pass from CTA to CTA in ticket order.

    D: bh (batch * heads), s (sequence), and the reference's ``chunkflops``
    (always 1; kept so the data parameters, and so the drivers' keys, are the
    JAX package's).  P: chunk, the SSD chunk length.  The chunk axis is a
    parallel grid axis now, and ragged (the kernel masks the last chunk).
    Each CTA reads its chunk's x, dt, B and C and the previous chunk's f32
    state, and writes its rows and its own state; so more chunks mean more
    CTAs and more state traffic (and more hops of the chain, which the fitted
    overhead carries), fewer mean more quadratic work per chunk.

    bf16 at a compiled (d_head, d_state) runs the wgmma body: CTAs over
    (bh, chunks), 2 * chunk threads, the compiled chunks only
    (SSD_SM90_CHUNKS: the instantiations are templates), FLOPs on the bf16
    tensor cores -- per row of a chunk 2 n chunk for C B^T, and the products
    whose f32 operand goes in as hi + lo bf16 terms twice over: 4 dh chunk
    for the scores times x, 4 n dh for the state, 4 n dh for C h_in.

    The SIMT body (f32, and other shapes) splits the head dim too: CTAs
    over (bh, d_head / SSD_COLS, chunks) of 256 threads, each recomputing
    the chunk's C B^T scores; per (bh, column block, position) it does
    n (chunk + SSD_ROWS) FLOPs for the causal C B^T score tiles, SSD_COLS
    (chunk + 1) for the scores times x, and 4 n SSD_COLS for the carried
    state's output term and the chunk's state, as FP32 FMAs.
    """
    if d_head % SSD_COLS or d_state % 8:
        raise ValueError(f"no SSD kernel for head dim {d_head} and state "
                         f"{d_state}: the kernel takes head dims divisible "
                         f"by {SSD_COLS} and states divisible by 8")
    name = f"ssd_scan_h{d_head}_n{d_state}"
    fit_vars = {"mem_step": ("chunk",), "cmp_step": ("chunk",),
                "ovh_step": ("chunk",)}
    chunk = var("chunk")
    n = float(d_state)
    if ssd_uses_sm90(d_head, d_state, dtype_bytes):
        dh = float(d_head)
        return KernelSpec(
            name=name,
            data_params=("bh", "s", "chunkflops"),
            program_params=("chunk",),
            grid=(GridAxis("b", "bh", None),
                  GridAxis("c", "s", "chunk", ragged=True)),
            operands=(
                Operand("x", ("chunk", d_head), ("b", "c"), 2, staged=True),
                Operand("dt", ("chunk",), ("b", "c"), 4, staged=True),
                Operand("b_proj", ("chunk", d_state), ("b", "c"), 2,
                        staged=True),
                Operand("c_proj", ("chunk", d_state), ("b", "c"), 2,
                        staged=True),
                Operand("decay", (1,), ("b",), 4),
                Operand("state_in", (d_state, d_head), ("b", "c"), 4),
                Operand("state_out", (d_state, d_head), ("b", "c"), 4,
                        is_output=True),
                Operand("out", ("chunk", d_head), ("b", "c"), 2,
                        is_output=True),
                Operand("h_hi_lo", (2, d_state, d_head), (), 2,
                        scratch=True),
                Operand("cum_w", (2, "chunk"), (), 4, scratch=True),
                Operand("barrier", (SSD_SM90_SMEM_EXTRA,), (), 1,
                        scratch=True),
            ),
            flops_per_point=(const(2.0 * n + 4.0 * dh) * chunk
                             + const(8.0 * n * dh)),
            threads=chunk * const(2.0),
            regs_per_thread=SSD_SM90_REGS_PER_THREAD,
            # a warpgroup's 64 rows
            constraints=(f"chunk % {SSD_SM90_GRANULE} == 0",),
            param_candidates={"chunk": SSD_SM90_CHUNKS},
            fit_vars=fit_vars,
            compute_unit="bf16",
        )
    cols = float(SSD_COLS)
    flops = (const(n) * (chunk + const(float(SSD_ROWS)))
             + const(cols) * (chunk + const(1.0)) + const(4.0 * n * cols))
    return KernelSpec(
        name=name,
        data_params=("bh", "s", "chunkflops"),
        program_params=("chunk",),
        grid=(GridAxis("b", "bh", None),
              GridAxis("d", d_head // SSD_COLS, None),
              GridAxis("c", "s", "chunk", ragged=True)),
        operands=(
            Operand("x", ("chunk", SSD_COLS), ("b", "d", "c"), dtype_bytes,
                    staged=True),
            Operand("dt", ("chunk",), ("b", "c"), 4, staged=True),
            Operand("b_proj", ("chunk", d_state), ("b", "c"), dtype_bytes,
                    staged=True),
            Operand("c_proj", ("chunk", d_state), ("b", "c"), dtype_bytes,
                    staged=True),
            Operand("decay", (1,), ("b",), 4),
            Operand("state_in", (d_state, SSD_COLS), ("b", "d", "c"), 4),
            Operand("state_out", (d_state, SSD_COLS), ("b", "d", "c"), 4,
                    is_output=True),
            Operand("out", ("chunk", SSD_COLS), ("b", "d", "c"), dtype_bytes,
                    is_output=True),
            Operand("cum_w", (2, "chunk"), (), 4, scratch=True),
            Operand("scores", (SSD_ROWS, "chunk"), (), 4, scratch=True),
            Operand("scores_pad", (SSD_ROWS, SSD_GPAD), (), 4, scratch=True),
            Operand("state", (d_state, SSD_COLS), (), 4, scratch=True),
        ),
        flops_per_point=flops,
        threads=const(float(SSD_THREADS)),
        regs_per_thread=SSD_REGS_PER_THREAD,
        # score tiles of SSD_ROWS rows
        constraints=("chunk % 32 == 0",),
        param_candidates={"chunk": (32, 64, 128, 256, 512, 1024, 2048)},
        fit_vars=fit_vars,
    )


def ssd_probe_data(bhs: Sequence[int] = (4, 8, 16, 32, 64),
                   seqs: Sequence[int] = (512, 1024, 2048)
                   ) -> list[dict[str, int]]:
    """Small probe sizes for an SSD spec: bh <= 64, s <= 2048.  A launch
    has bh x ceil(s / chunk) CTAs (times d_head / SSD_COLS in the SIMT
    body), so at chunk 64 these run from 32 CTAs, a quarter of the SMs, to
    2048, many waves; the chains of states run s / chunk hops, 4 to 64."""
    return [{"bh": int(bh), "s": int(s), "chunkflops": 1}
            for bh in bhs for s in seqs]


# ---------------------------------------------------------------------------
# The PolyBench/GPU-analogue suite (the paper's evaluation workloads,
# Section VI, Table I), on Hopper
# ---------------------------------------------------------------------------
# The reference's 28 rows with their names, data and program parameters,
# FLOPs per point, candidates and fit variables.  The matmul rows are the f32
# SIMT matmul's spec (``matmul_spec(4)``), renamed; the reference's
# ``mxu_fraction`` has no counterpart on the CUDA cores, so corr and covar
# equal gemm here.  The matvec, stencil and reduction rows describe a kernel
# neither package compiles: their spec states a notional SIMT launch (threads
# and registers per thread), f32 FMAs on the CUDA cores, and the bytes such a
# kernel would move, in place of the reference's TPU lane padding.

POLYBENCH_MATMUL_ROWS = ("gemm", "mm2_k1", "mm2_k2", "mm3_k1", "mm3_k2",
                         "mm3_k3", "syrk", "syr2k", "corr", "covar")

# Suite rows the card times by launching a compiled kernel: each matmul row
# whose spec is the f32 SIMT matmul's, FLOPs included.  syr2k counts two
# products per point (4 FLOPs) and the kernel computes one, so it has none
# and stays on HopperModel on the card too.
POLYBENCH_LAUNCH_ALIASES = {name: "matmul_b32"
                            for name in POLYBENCH_MATMUL_ROWS
                            if name != "syr2k"}

# Registers per thread of the notional kernels (an accumulator, a few
# addresses and loop counters).
NOTIONAL_REGS_PER_THREAD = 32
# Threads per CTA of the notional reduction.
REDUCTION_THREADS = 256

_ALL_STEPS = ("mem_step", "cmp_step", "ovh_step")


def _matvec_spec(name: str, n_mats: int = 1,
                 dtype_bytes: int = 4) -> KernelSpec:
    """out[i] = sum_j A[i, j] x[j] over CTAs of (br, bc) tiles.

    Notional SIMT launch: bc threads, one per column of the tile, each
    reading its x[j] once and walking the br rows (a warp reads 32
    consecutive f32 of a row, one 128-byte transaction: ``bc % 32 == 0``);
    each row's partial sum is reduced across the CTA and added into out[i]
    with an atomic, so every CTA writes br values.  Nothing is staged in
    shared memory.
    """
    return KernelSpec(
        name=name,
        data_params=("r", "c"),
        program_params=("br", "bc"),
        grid=(GridAxis("i", "r", "br"), GridAxis("j", "c", "bc")),
        operands=(
            Operand("mat", ("br", "bc"), ("i", "j"), dtype_bytes),
            Operand("vec", ("bc",), ("j",), dtype_bytes),
            Operand("out", ("br",), ("i", "j"), dtype_bytes, is_output=True),
        ),
        flops_per_point=2.0 * n_mats,
        threads=var("bc"),
        regs_per_thread=NOTIONAL_REGS_PER_THREAD,
        constraints=("bc % 32 == 0",),
        param_candidates={"br": (8, 16, 32, 64, 128, 256, 512, 1024),
                          "bc": (128, 256, 512, 1024, 2048, 4096)},
        fit_vars={m: ("br", "bc") for m in _ALL_STEPS},
    )


def _stencil_spec(name: str, halo: int, flops: float,
                  dtype_bytes: int = 4) -> KernelSpec:
    """out = stencil(inp) over CTAs of (br, bc) tiles.

    Notional SIMT launch: bc threads, one per column of the tile (``bc %
    32 == 0``: a warp's row reads coalesce), which stage the tile and its
    ``halo`` rows above and below and ``halo`` columns left and right in
    shared memory, then walk the br rows.  The halo is what a CUDA kernel
    reads: ``2 * halo`` rows of bc and br rows of ``2 * halo``.
    """
    return KernelSpec(
        name=name,
        data_params=("r", "c"),
        program_params=("br", "bc"),
        grid=(GridAxis("i", "r", "br"), GridAxis("j", "c", "bc")),
        operands=(
            Operand("inp", ("br", "bc"), ("i", "j"), dtype_bytes, staged=True),
            Operand("halo_r", (2 * halo, "bc"), ("i", "j"), dtype_bytes,
                    staged=True),
            Operand("halo_c", ("br", 2 * halo), ("i", "j"), dtype_bytes,
                    staged=True),
            Operand("out", ("br", "bc"), ("i", "j"), dtype_bytes,
                    is_output=True),
        ),
        flops_per_point=flops,
        threads=var("bc"),
        regs_per_thread=NOTIONAL_REGS_PER_THREAD,
        constraints=("bc % 32 == 0",),
        param_candidates={"br": (8, 16, 32, 64, 128, 256, 512),
                          "bc": (128, 256, 512, 1024, 2048)},
        fit_vars={m: ("br", "bc") for m in _ALL_STEPS},
    )


def _reduction_spec(name: str, flops: float = 1.0,
                    dtype_bytes: int = 4) -> KernelSpec:
    """A full reduction of (r, c) to one value over CTAs of br whole rows.

    Notional SIMT launch: REDUCTION_THREADS threads stride over the CTA's
    br x c block (coalesced along c), reduce across the CTA, and add the
    partial into the one output with an atomic.  The column axis is one
    block of c columns (its block is the data parameter itself), so the
    grid's points, and the FLOPs, are r x c.  Rows are looped over, so br
    needs no granule.
    """
    return KernelSpec(
        name=name,
        data_params=("r", "c"),
        program_params=("br",),
        grid=(GridAxis("i", "r", "br"), GridAxis("j", "c", "c")),
        operands=(
            Operand("inp", ("br", "c"), ("i", "j"), dtype_bytes),
            Operand("out", (1,), ("i",), dtype_bytes, is_output=True),
        ),
        flops_per_point=flops,
        threads=const(float(REDUCTION_THREADS)),
        regs_per_thread=NOTIONAL_REGS_PER_THREAD,
        param_candidates={"br": (8, 16, 32, 64, 128, 256, 512, 1024)},
        fit_vars={m: ("br",) for m in _ALL_STEPS},
    )


def polybench_suite() -> dict[str, KernelSpec]:
    """The PolyBench/GPU-analogue suite (paper Table I rows) on Hopper."""
    suite: dict[str, KernelSpec] = {}
    for nm in POLYBENCH_MATMUL_ROWS:
        s = matmul_spec(dtype_bytes=4)
        s.name = nm
        if nm == "syr2k":
            s.flops_per_point = 4.0
        suite[nm] = s
    for nm, k in (("atax_k1", 1), ("atax_k2", 1), ("bicg_k1", 1),
                  ("bicg_k2", 1), ("mvt_k1", 1), ("mvt_k2", 1),
                  ("gesummv", 2)):
        suite[nm] = _matvec_spec(nm, n_mats=k)
    suite["conv2d"] = _stencil_spec("conv2d", halo=8, flops=17.0)
    suite["conv3d"] = _stencil_spec("conv3d", halo=8, flops=53.0)
    for nm in ("fdtd_step1", "fdtd_step2", "fdtd_step3"):
        suite[nm] = _stencil_spec(nm, halo=8, flops=5.0)
    for nm, fl in (("reduce", 1.0), ("mean", 2.0), ("std", 4.0)):
        suite[nm] = _reduction_spec(nm, flops=fl)
    for nm in ("gramschmidt_k1", "gramschmidt_k2", "gramschmidt_k3"):
        suite[nm] = _matvec_spec(nm)
    return suite


POLYBENCH_SUITE = tuple(polybench_suite().keys())
