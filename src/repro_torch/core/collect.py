"""Data collection (paper Section IV, step 1) -- vectorized + budget-aware.

Select a set of probe points K inside the (D, P) space -- small data sizes
only, so that "the compile-time analysis cannot overwhelm the compilation
time" -- execute the kernel at each point through the opaque device oracle,
and record the low-level metric values V.

Which configurations get probed at each size is decided by a search
strategy (search/): the feasible set arrives as the full columnar
``CandidateTable`` and the strategy proposes row indices under a hard
``SearchBudget``.  The default is seeded stratified random with a per-size
execution budget of ``max_configs_per_size * repeats``.

Derived per-sample targets (the L_i of the skeleton in core/perf_model.py),
with ``B_res`` the blocks resident per SM in a wave:
    mem_step = mem_time / (grid_steps * B_res)
    cmp_step = compute_time / (grid_steps * B_res)
    ovh_step = (total_time - skeleton(mem, cmp)) / grid_steps   (residual)
The residual uses the *known* decision skeleton (overlap iff B_res >= 2), so
what remains for ovh_step is the barrier/latency bubble and overlap leak --
the "departure delay" of the MWP-CWP model.

A collect run is a sequence of independent per-size batches: every batch
draws from its own ``RandomState(batch_seed(seed, i))``, and
``merge_shards`` folds them in batch-index order, so the merged dataset is
a pure function of the shards.  All seeds come from a platform-stable hash
(sha256), never Python's ``hash``.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import time
from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np

from ..trace import trace_span
from .device_model import H100, DeviceModel, HardwareParams
from .kernel_spec import KernelSpec

__all__ = [
    "BatchShard", "CollectedData", "batch_budgets", "batch_seed", "collect",
    "collect_batch", "default_probe_data", "from_reference_collected",
    "merge_shards", "stable_mix",
]

Dims = Mapping[str, int]

# The columnar metric targets a collection run produces.
METRIC_COLUMNS = ("total_time_s", "mem_step", "cmp_step", "ovh_step")


def stable_mix(*parts) -> int:
    """Deterministic 32-bit seed from structured parts (order-sensitive)."""
    payload = json.dumps(parts, sort_keys=True, default=str).encode()
    return int.from_bytes(hashlib.sha256(payload).digest()[:4], "big")


def batch_seed(seed: int, batch_index: int) -> int:
    """Seed of one probe-size batch's RandomState (strategy + noise)."""
    return stable_mix("collect.batch", int(seed), int(batch_index))


def batch_budgets(n_batches: int, budget, max_configs_per_size: int,
                  repeats: int) -> list:
    """The per-batch ``SearchBudget``s of one collect run: no total budget
    means ``max_configs_per_size * repeats`` executions per size; a total
    budget is split evenly across the sizes."""
    from ..search import SearchBudget

    if budget is not None and not isinstance(budget, SearchBudget):
        raise TypeError(
            f"budget must be a SearchBudget, got {type(budget).__name__}")
    if budget is None:
        return [SearchBudget(max_executions=max_configs_per_size * repeats)
                for _ in range(n_batches)]
    return budget.split(n_batches)


@dataclass
class CollectedData:
    """Columnar probe dataset: one ndarray per variable and per metric.

    ``columns`` holds one (n,) array for every data parameter and every
    program parameter; ``metrics`` holds the derived per-step targets.
    ``stage_bytes`` is each probe's on-chip stage footprint (shared memory
    per block here).
    """

    spec_name: str
    data_params: tuple[str, ...]
    program_params: tuple[str, ...]
    columns: dict[str, np.ndarray]
    metrics: dict[str, np.ndarray]
    grid_steps: np.ndarray
    stage_bytes: np.ndarray
    n_probe_executions: int
    probe_device_seconds: float
    collect_wall_seconds: float

    def __len__(self) -> int:
        return int(self.grid_steps.shape[0])

    @classmethod
    def empty(cls, spec: KernelSpec) -> "CollectedData":
        """A dataset of no samples and no probe executions (what a build
        that found its driver in the cache collected)."""
        return cls(
            spec_name=spec.name,
            data_params=tuple(spec.data_params),
            program_params=tuple(spec.program_params),
            columns={v: np.empty(0) for v in
                     (*spec.data_params, *spec.program_params)},
            metrics={m: np.empty(0) for m in METRIC_COLUMNS},
            grid_steps=np.empty(0, dtype=np.int64),
            stage_bytes=np.empty(0, dtype=np.int64),
            n_probe_executions=0,
            probe_device_seconds=0.0,
            collect_wall_seconds=0.0,
        )

    def matrix(self, metric: str, var_names: Sequence[str]
               ) -> tuple[np.ndarray, np.ndarray]:
        """Design points X over ``var_names`` and targets y for ``metric``."""
        X = np.stack(
            [np.asarray(self.columns[v], dtype=np.float64)
             for v in var_names], axis=1)
        y = np.asarray(self.metrics[metric], dtype=np.float64)
        return X, y


def from_reference_collected(d: Mapping) -> CollectedData:
    """The JAX package's ``CollectedData.to_json()`` dict as the port's.

    Reads the plain JSON form (lists or numpy arrays), never the reference
    package: its ``vmem_stage_bytes`` column (the TPU's stage footprint)
    lands in ``stage_bytes``.
    """
    return CollectedData(
        spec_name=d["spec_name"],
        data_params=tuple(d["data_params"]),
        program_params=tuple(d["program_params"]),
        columns={k: np.asarray(v, dtype=np.int64)
                 for k, v in d["columns"].items()},
        metrics={k: np.asarray(v, dtype=np.float64)
                 for k, v in d["metrics"].items()},
        grid_steps=np.asarray(d["grid_steps"], dtype=np.int64),
        stage_bytes=np.asarray(d["vmem_stage_bytes"], dtype=np.int64),
        n_probe_executions=int(d["n_probe_executions"]),
        probe_device_seconds=float(d["probe_device_seconds"]),
        collect_wall_seconds=float(d["collect_wall_seconds"]),
    )


@dataclass
class BatchShard:
    """One probe-size batch's worth of collected samples, in probe order."""

    batch_index: int
    D: dict
    columns: dict[str, np.ndarray]
    metrics: dict[str, np.ndarray]
    grid_steps: np.ndarray
    stage_bytes: np.ndarray
    n_candidates: int
    n_probe_executions: int
    probe_device_seconds: float


def default_probe_data(spec: KernelSpec,
                       sizes: Sequence[int] = (256, 512, 1024)
                       ) -> list[dict[str, int]]:
    """Small-size probe grid: every data param swept over ``sizes``."""
    return [dict(zip(spec.data_params, combo))
            for combo in itertools.product(sizes, repeat=len(spec.data_params))]


def _cat(blocks, dtype=None):
    blocks = [b for b in blocks if b.size]
    if not blocks:
        return np.empty(0, dtype=dtype or np.float64)
    return np.concatenate(blocks)


def collect_batch(
    spec: KernelSpec,
    device: DeviceModel,
    D: Dims,
    hw: HardwareParams = H100,
    repeats: int = 3,
    max_configs_per_size: int = 32,
    seed: int = 0,
    batch_index: int = 0,
    budget=None,
    strategy=None,
) -> BatchShard:
    """Probe one data size.

    ``budget`` is this batch's own ``SearchBudget``.  Pass a resolved
    ``Strategy`` instance to keep its run lifecycle (``begin_run``) with the
    caller, as ``collect`` does; a name or None is resolved *and* begun
    here.  The batch rng is ``RandomState(batch_seed(seed, batch_index))``
    whoever calls, so the shard depends only on its inputs.
    """
    from ..search import SearchBudget, Strategy, resolve_strategy, \
        search_table

    if not isinstance(strategy, Strategy):
        strategy = resolve_strategy(strategy)
        strategy.begin_run()
    if budget is None:
        budget = SearchBudget(max_executions=max_configs_per_size * repeats)
    rng = np.random.RandomState(batch_seed(seed, batch_index))
    ledger = budget.ledger()

    all_vars = tuple(spec.data_params) + tuple(spec.program_params)
    col_blocks: dict[str, list[np.ndarray]] = {v: [] for v in all_vars}
    met_blocks: dict[str, list[np.ndarray]] = {m: [] for m in METRIC_COLUMNS}
    steps_blocks: list[np.ndarray] = []
    stage_blocks: list[np.ndarray] = []

    with trace_span("collect.batch", kernel=spec.name, D=dict(D),
                    batch_index=batch_index,
                    strategy=dict(strategy.fingerprint())) as bsp:
        table = spec.candidates(D, hw)
        if len(table):
            def record(indices: np.ndarray, probe) -> None:
                n = int(indices.size)
                t_tot = probe.total_time_s
                t_mem = probe.mem_time_s
                t_cmp = probe.compute_time_s
                steps = np.maximum(probe.grid_steps, 1)
                res = np.maximum(probe.blocks_resident, 1)
                skeleton = np.where(res >= 2, np.maximum(t_mem, t_cmp),
                                    t_mem + t_cmp)
                ovh = np.maximum((t_tot - skeleton) / steps, 1e-9)
                for d, v in D.items():
                    col_blocks[d].append(np.full(n, int(v), dtype=np.int64))
                for p in spec.program_params:
                    col_blocks[p].append(table[p][indices])
                met_blocks["total_time_s"].append(t_tot)
                met_blocks["mem_step"].append(t_mem / (steps * res))
                met_blocks["cmp_step"].append(t_cmp / (steps * res))
                met_blocks["ovh_step"].append(ovh)
                steps_blocks.append(steps)
                stage_blocks.append(probe.stage_bytes)

            search_table(spec, device, D, table, strategy, ledger, rng,
                         hw=hw, default_repeats=repeats, observer=record)
        bsp.set(n_candidates=len(table),
                executions=ledger.spent_executions,
                device_seconds=ledger.spent_device_seconds)

    return BatchShard(
        batch_index=int(batch_index),
        D=dict(D),
        columns={v: _cat(col_blocks[v], np.int64) for v in all_vars},
        metrics={m: _cat(met_blocks[m]) for m in METRIC_COLUMNS},
        grid_steps=_cat(steps_blocks, np.int64),
        stage_bytes=_cat(stage_blocks, np.int64),
        n_candidates=len(table),
        n_probe_executions=ledger.spent_executions,
        probe_device_seconds=ledger.spent_device_seconds,
    )


def merge_shards(spec: KernelSpec, shards: Sequence[BatchShard],
                 collect_wall_seconds: float = 0.0) -> CollectedData:
    """Fold per-batch shards into one ``CollectedData`` in ``batch_index``
    order (never completion order); a duplicate batch index is an error."""
    ordered = sorted(shards, key=lambda s: s.batch_index)
    seen: set[int] = set()
    for s in ordered:
        if s.batch_index in seen:
            raise ValueError(f"duplicate shard for batch {s.batch_index}")
        seen.add(s.batch_index)

    all_vars = tuple(spec.data_params) + tuple(spec.program_params)
    n_exec = 0
    device_seconds = 0.0
    for s in ordered:
        n_exec += s.n_probe_executions
        device_seconds += s.probe_device_seconds
    return CollectedData(
        spec_name=spec.name,
        data_params=tuple(spec.data_params),
        program_params=tuple(spec.program_params),
        columns={v: _cat([s.columns[v] for s in ordered], np.int64)
                 for v in all_vars},
        metrics={m: _cat([s.metrics[m] for s in ordered])
                 for m in METRIC_COLUMNS},
        grid_steps=_cat([s.grid_steps for s in ordered], np.int64),
        stage_bytes=_cat([s.stage_bytes for s in ordered], np.int64),
        n_probe_executions=n_exec,
        probe_device_seconds=device_seconds,
        collect_wall_seconds=collect_wall_seconds,
    )


def collect(
    spec: KernelSpec,
    device: DeviceModel,
    probe_data: Sequence[Dims] | None = None,
    hw: HardwareParams = H100,
    repeats: int = 3,
    max_configs_per_size: int = 32,
    seed: int = 0,
    strategy=None,
    budget=None,
) -> CollectedData:
    """Probe the device oracle at strategy-selected (D, P) points.

    ``strategy`` is a search strategy name or instance (default: stratified
    ``random``); ``budget`` a total ``SearchBudget`` split evenly across the
    probe sizes (default: ``max_configs_per_size * repeats`` executions per
    size).
    """
    from ..search import resolve_strategy

    t0 = time.perf_counter()
    probe_data = list(probe_data) if probe_data is not None else \
        default_probe_data(spec)
    strategy = resolve_strategy(strategy)
    strategy.begin_run()
    budgets = batch_budgets(len(probe_data), budget,
                            max_configs_per_size, repeats)
    budget_fp = dict(budget.fingerprint()) if budget is not None else None
    with trace_span("collect", kernel=spec.name, n_batches=len(probe_data),
                    strategy=dict(strategy.fingerprint()),
                    budget=budget_fp) as csp:
        shards = [collect_batch(spec, device, D, hw=hw, repeats=repeats,
                                max_configs_per_size=max_configs_per_size,
                                seed=seed, batch_index=i, budget=b,
                                strategy=strategy)
                  for i, (D, b) in enumerate(zip(probe_data, budgets))]
        csp.set(n_probe_executions=sum(s.n_probe_executions for s in shards),
                probe_device_seconds=float(
                    np.sum([s.probe_device_seconds for s in shards])
                    if shards else 0.0))
    return merge_shards(spec, shards,
                        collect_wall_seconds=time.perf_counter() - t0)
