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
    loaded once per iteration of every CTA, any other input once per CTA,
    and every CTA writes its output tile once.

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
    "flash_attention_spec", "flash_probe_data", "matmul_spec", "substitute",
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
    flops_per_point: float          # FLOPs per point of the grid's data domain
    threads: Expr                   # threads per CTA over the program params
    regs_per_thread: int            # what the kernel is compiled to
    constraints: tuple[str, ...] = ()
    param_candidates: dict[str, tuple[int, ...]] = field(default_factory=dict)
    fit_vars: dict[str, tuple[str, ...]] = field(default_factory=dict)

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

    def flops_total(self, D: Dims) -> float:
        n = 1.0
        for a in self.grid:
            n *= D[a.data] if isinstance(a.data, str) else a.data
        return self.flops_per_point * n

    def traffic_table(self, D: Dims, table: CandidateTable,
                      hw: HardwareParams = H100) -> TrafficTable:
        """Launch geometry and operand traffic of every config in ``table``."""
        ctas = self._eval(self.ctas_expr(), D, table)
        iters = {a.name: self._eval(a.extent_expr(), D, table)
                 for a in self.grid if a.sequential}
        operands = []
        for op in self.operands:
            if op.scratch:
                continue
            fetches = ctas.copy()
            if not op.is_output:
                for d in op.deps:
                    if d in iters:
                        fetches = fetches * iters[d]
            operands.append(TrafficOperand(
                name=op.name, shapes=self._tile_columns(op, D, table),
                fetches=fetches, dtype_bytes=op.dtype_bytes,
                is_output=op.is_output))
        n = len(table)
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
            flops_total=np.full(n, self.flops_total(D)),
            operands=operands,
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
                mask &= (table[a.block] <= size) & (size % table[a.block] == 0)
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

# kernels/csrc/matmul.cu: each thread owns an 8 x 8 block of C in registers,
# and __launch_bounds__(512) caps it at 128 registers per thread.
MATMUL_MICRO_TILE = 8
MATMUL_REGS_PER_THREAD = 128


def matmul_spec(dtype_bytes: int = 2) -> KernelSpec:
    """C[m,n] = A[m,k] @ B[k,n]: CTAs over (i, j), a loop over k inside.

    (bm, bn) is the thread-block shape: bm * bn / 64 threads, one 8 x 8
    micro-tile each.  A (bm, bk) and B (bk, bn) tiles are staged in shared
    memory; the f32 accumulators are registers and move no bytes.
    """
    tile = float(MATMUL_MICRO_TILE * MATMUL_MICRO_TILE)
    return KernelSpec(
        name=f"matmul_b{dtype_bytes * 8}",
        data_params=("m", "n", "k"),
        program_params=("bm", "bn", "bk"),
        grid=(GridAxis("i", "m", "bm"), GridAxis("j", "n", "bn"),
              GridAxis("l", "k", "bk", sequential=True)),
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


# kernels/csrc/flash_attention.cu: a CTA of 4 * bq threads, each owning 4
# query rows; __launch_bounds__ caps registers at 128 per thread for head
# dims up to 128 (512 threads) and at 255 for head dim 256 (256 threads).
FLASH_HEAD_DIMS = (64, 128, 256)
FLASH_THREADS_PER_ROW = 4
FLASH_PAD = 16      # f32 words of padding per row of the staged P tile


def flash_regs_per_thread(head_dim: int) -> int:
    """The register cap the flash kernel of ``head_dim`` is compiled to."""
    if head_dim not in FLASH_HEAD_DIMS:
        raise ValueError(f"no flash kernel for head dim {head_dim}; the "
                         f"kernel is built for {FLASH_HEAD_DIMS}")
    return 255 if head_dim == 256 else 128


def flash_attention_spec(head_dim: int = 128, causal: bool = True,
                         dtype_bytes: int = 2) -> KernelSpec:
    """Flash attention forward: CTAs over (bh, q blocks), a loop over kv
    blocks inside (online softmax).

    D: bh = batch * q heads (flattened), sq, skv.  P: bq, bkv.  The CTA has
    4 * bq threads.  Q (bq, d), K and V (bkv, d) tiles are staged in shared
    memory, and so is the f32 probability tile (bq, bkv) with 16 words of
    padding per row; m, l and the output accumulator are registers.  FLOPs
    per (bh, sq, skv) point: 4 * d (QK^T and PV), halved when causal.  The
    kernel masks ragged q and kv tails, so tiles need not divide sq or skv.
    """
    regs = flash_regs_per_thread(head_dim)
    return KernelSpec(
        name=f"flash_attn_d{head_dim}" + ("_causal" if causal else ""),
        data_params=("bh", "sq", "skv"),
        program_params=("bq", "bkv"),
        grid=(GridAxis("b", "bh", None),
              GridAxis("iq", "sq", "bq", ragged=True),
              GridAxis("ikv", "skv", "bkv", sequential=True, ragged=True)),
        operands=(
            Operand("q", ("bq", head_dim), ("b", "iq"), dtype_bytes,
                    staged=True),
            Operand("k", ("bkv", head_dim), ("b", "ikv"), dtype_bytes,
                    staged=True),
            Operand("v", ("bkv", head_dim), ("b", "ikv"), dtype_bytes,
                    staged=True),
            Operand("out", ("bq", head_dim), ("b", "iq"), dtype_bytes,
                    is_output=True),
            Operand("p", ("bq", "bkv"), (), 4, scratch=True),
            Operand("p_pad", ("bq", FLASH_PAD), (), 4, scratch=True),
        ),
        flops_per_point=4.0 * head_dim * (0.5 if causal else 1.0),
        threads=var("bq") * const(float(FLASH_THREADS_PER_ROW)),
        regs_per_thread=regs,
        # 4 rows per thread and 16 threads across a row: bq % 16; the P tile
        # row is split over 16 lanes, bkv % 32 keeps its padding aligned.
        constraints=("bq % 16 == 0", "bkv % 32 == 0"),
        param_candidates={
            "bq": (16, 32, 64, 128),
            "bkv": (32, 64, 128),
        },
        fit_vars={
            "mem_step": ("bq", "bkv"),
            "cmp_step": ("bq", "bkv"),
            "ovh_step": ("bq", "bkv"),
        },
    )


def flash_probe_data(bhs: Sequence[int] = (4, 16, 64),
                     seqs: Sequence[int] = (256, 512, 1024)
                     ) -> list[dict[str, int]]:
    """Small probe sizes for a flash spec: few heads, sq = skv <= 1024
    (self-attention, the shape every model layer launches)."""
    return [{"bh": int(bh), "sq": int(s), "skv": int(s)}
            for bh in bhs for s in seqs]
