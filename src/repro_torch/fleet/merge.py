"""The merge layer: worker results -> one canonical CollectedData.

Completion order, worker placement, retries and speculative duplicates
must be invisible in the merged dataset.  The guarantees stack up from
below: jobs are content-keyed and idempotent (fleet.jobs), the board keeps
at most one result per key (first writer wins, duplicates dropped), and
``merge_shards`` (core.collect) concatenates by batch index -- so the fold
here is a pure function of *which jobs ran*, which the tune request fixes.
``collected_equal`` is the bit-identity check the tests gate on under a
seeded oracle; on the card, where times differ between runs,
``collected_rows_equal`` compares only which rows were probed.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

from ..core.collect import BatchShard, CollectedData, merge_shards
from ..core.kernel_spec import KernelSpec

__all__ = ["collected_equal", "collected_rows_equal", "merge_batch_results",
           "merge_kernel_result"]


def merge_batch_results(spec: KernelSpec, results: Sequence[Mapping],
                        ) -> CollectedData:
    """Fold per-batch job results (payloads with ``shard``) into one
    dataset, regardless of the order results arrived in."""
    shards = [BatchShard.from_json(r["shard"]) for r in results]
    return merge_shards(spec, shards)


def merge_kernel_result(result: Mapping) -> CollectedData:
    """Unwrap a whole-kernel job result (payload with ``data``)."""
    return CollectedData.from_json(result["data"])


def collected_rows_equal(a: CollectedData, b: CollectedData) -> list[str]:
    """Which rows were probed, compared exactly: the data and program
    columns (D and configs, in probe order), the grid steps, the stage
    bytes and the executions; never a time.  Returns mismatch descriptions
    (empty = equal)."""
    problems = []
    if a.spec_name != b.spec_name:
        problems.append(f"spec {a.spec_name!r} != {b.spec_name!r}")
    if sorted(a.columns) != sorted(b.columns):
        problems.append(f"columns keys {sorted(a.columns)} != "
                        f"{sorted(b.columns)}")
    else:
        for k in a.columns:
            if not np.array_equal(a.columns[k], b.columns[k]):
                problems.append(f"columns[{k}] differs")
    for k in ("grid_steps", "stage_bytes"):
        if not np.array_equal(getattr(a, k), getattr(b, k)):
            problems.append(f"{k} differs")
    if a.n_probe_executions != b.n_probe_executions:
        problems.append(f"n_probe_executions {a.n_probe_executions} != "
                        f"{b.n_probe_executions}")
    return problems


def collected_equal(a: CollectedData, b: CollectedData,
                    check_stats: bool = True) -> list[str]:
    """Bit-identity comparison; returns mismatch descriptions (empty = equal).

    Wall-clock seconds are never compared (they measure the run, not the
    data); probe stats are exact -- including the float64 device-seconds
    sum, whose addition order the merge preserves.
    """
    problems = []
    if a.spec_name != b.spec_name:
        problems.append(f"spec {a.spec_name!r} != {b.spec_name!r}")
    for name, cols_a, cols_b in (("columns", a.columns, b.columns),
                                 ("metrics", a.metrics, b.metrics)):
        if sorted(cols_a) != sorted(cols_b):
            problems.append(f"{name} keys {sorted(cols_a)} != "
                            f"{sorted(cols_b)}")
            continue
        for k in cols_a:
            if not np.array_equal(cols_a[k], cols_b[k]):
                problems.append(f"{name}[{k}] differs")
    for k in ("grid_steps", "stage_bytes"):
        if not np.array_equal(getattr(a, k), getattr(b, k)):
            problems.append(f"{k} differs")
    if check_stats:
        if a.n_probe_executions != b.n_probe_executions:
            problems.append(f"n_probe_executions {a.n_probe_executions} != "
                            f"{b.n_probe_executions}")
        if a.probe_device_seconds != b.probe_device_seconds:
            problems.append(f"probe_device_seconds "
                            f"{a.probe_device_seconds!r} != "
                            f"{b.probe_device_seconds!r}")
    return problems
