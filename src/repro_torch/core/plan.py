"""Compiled launch plans: the precomputed, O(1) form of a driver's choices.

The paper's runtime contract is one cheap IO call per kernel launch
(Section V-C).  The driver's ``choose`` honours it per shape, but a serving
process re-pays a whole candidate-table evaluation of the rational program
for every distinct shape, in every fresh process.  A *launch plan* removes
that: the driver's rational program is partially evaluated with respect to
the data parameters of a whole traffic envelope -- one ``choose_many`` pass
over a shapes x configs matrix -- and the (shape -> config) map is frozen
into an immutable, array-backed ``LaunchPlanTable``.

The table is the steady-state path: packed int64 shape keys, an
open-addressing linear probe over preallocated ndarrays, the config rows
as one int64 matrix.  A lookup touches a few array cells -- no candidate
enumeration, no rational-function evaluation -- so its cost does not grow
with the candidate table.  A table is stamped with the driver it was
compiled from (``tuning_version``, ``source_hash``) and with the kernel
code that driver serves (``code``, ``cache.code_digest`` of its spec under
the kernel sources): the registry drops a kernel's plans when another
driver is registered for it, and a plan read from the cache is installed
only for that code (``driver._install_plan_if_matching``).

Plans persist through ``core/cache.py`` (``PlanEntry``, stored as
``<kernel>/<key>.plan.json``) and are installed by ``warm_start_from_cache``
and ``get_driver``'s read-through, or compiled and written by
``precompile_plans``.
"""

from __future__ import annotations

import hashlib
import json
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

import numpy as np

from .device_model import HardwareParams

__all__ = ["LaunchPlanTable", "compile_plan", "lattice", "pack_shape",
           "plan_key", "precompile_plans"]

logger = logging.getLogger(__name__)

# The plan-write warning is given once per process: an unwritable cache
# directory is one diagnosis, not one per kernel.
_plan_write_warned = False

Dims = Mapping[str, int]

_EMPTY = np.int64(-1)          # an empty slot of the hash column


def _mix64(x: int) -> int:
    """splitmix64's finalizer: avalanche a 64-bit value (stable across
    runs, unlike Python's salted ``hash``)."""
    x &= 0xFFFFFFFFFFFFFFFF
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & 0xFFFFFFFFFFFFFFFF
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def pack_shape(values: Sequence[int]) -> int:
    """One non-negative int64 key for a shape tuple.

    The dimensions are mixed (a splitmix64 chain) rather than bit-packed,
    so no extent overflows the key; the table checks the raw dimensions on
    every probe, so a collision costs one more probe step, never a wrong
    config.
    """
    h = 0x9E3779B97F4A7C15
    for v in values:
        h = _mix64(h ^ _mix64(int(v)))
    return h >> 1               # positive in a signed int64


def lattice(axes: Mapping[str, Sequence[int]]) -> dict[str, np.ndarray]:
    """Cartesian traffic envelope: per-data-param value lists -> columnar
    shape table (one int64 column per data param, one row per lattice
    point), the ``D_table`` that ``choose_many`` and ``compile_plan``
    take."""
    names = list(axes)
    grids = np.meshgrid(*[np.asarray(list(axes[n]), dtype=np.int64)
                          for n in names], indexing="ij")
    return {n: g.reshape(-1) for n, g in zip(names, grids)}


@dataclass
class LaunchPlanTable:
    """Immutable array-backed (shape -> launch config) map of one kernel.

    An open-addressing hash table over preallocated ndarrays:

      * ``hashes`` -- (capacity,) int64, the packed shape key or -1 (empty),
      * ``dims``   -- (capacity, n_data_params) int64, the raw shape
                      (checked on every probe, so collisions are safe),
      * ``rows``   -- (capacity, n_program_params) int64 config rows.

    The capacity is a power of two at load factor <= 0.5, so probes end
    quickly; the table is built once (``build``) and never changed, so
    concurrent lookups need no lock.
    """

    kernel: str
    hw_name: str
    data_params: tuple[str, ...]
    program_params: tuple[str, ...]
    tuning_version: int
    hashes: np.ndarray = field(repr=False)
    dims: np.ndarray = field(repr=False)
    rows: np.ndarray = field(repr=False)
    n_entries: int = 0
    # The driver this plan was compiled from: the registry keeps a plan
    # only beside that driver.
    source_hash: str = ""
    # The kernel code that driver serves (``cache.code_digest``): a plan
    # read from the cache is installed only under that code.
    code: str = ""

    # -- construction --------------------------------------------------------
    @classmethod
    def build(cls, kernel: str, hw_name: str,
              data_params: Sequence[str], program_params: Sequence[str],
              shapes: Mapping[str, np.ndarray],
              configs: Mapping[str, np.ndarray],
              ok: np.ndarray | None = None,
              tuning_version: int = 0,
              source_hash: str = "", code: str = "") -> "LaunchPlanTable":
        """Freeze columnar (shapes, configs) -- a ``choose_many`` result --
        into a probe table.  Rows where ``ok`` is False are dropped; a
        repeated shape keeps its last config."""
        data_params = tuple(data_params)
        program_params = tuple(program_params)
        shape_cols = [np.asarray(shapes[d], dtype=np.int64).reshape(-1)
                      for d in data_params]
        cfg_cols = [np.asarray(configs[p], dtype=np.int64).reshape(-1)
                    for p in program_params]
        n = shape_cols[0].shape[0] if shape_cols else 0
        keep = (np.ones(n, dtype=bool) if ok is None
                else np.asarray(ok, dtype=bool))
        n_keep = int(np.count_nonzero(keep))
        cap = 1
        while cap < max(2 * n_keep, 2):
            cap *= 2
        table = cls(
            kernel=kernel, hw_name=hw_name, data_params=data_params,
            program_params=program_params, tuning_version=tuning_version,
            hashes=np.full(cap, _EMPTY, dtype=np.int64),
            dims=np.zeros((cap, len(data_params)), dtype=np.int64),
            rows=np.zeros((cap, len(program_params)), dtype=np.int64),
            source_hash=source_hash, code=code,
        )
        for i in range(n):
            if keep[i]:
                table._insert(tuple(int(c[i]) for c in shape_cols),
                              tuple(int(c[i]) for c in cfg_cols))
        return table

    def _insert(self, key: tuple[int, ...], cfg: tuple[int, ...]) -> None:
        cap = self.hashes.shape[0]
        h = pack_shape(key)
        slot = h & (cap - 1)
        while True:
            stored = int(self.hashes[slot])
            if stored == int(_EMPTY):
                self.hashes[slot] = h
                self.dims[slot] = key
                self.rows[slot] = cfg
                self.n_entries += 1
                return
            if stored == h and tuple(int(v) for v in self.dims[slot]) == key:
                self.rows[slot] = cfg          # a repeated shape: last wins
                return
            slot = (slot + 1) & (cap - 1)

    # -- the lookup ----------------------------------------------------------
    def lookup_key(self, key: tuple[int, ...]) -> dict[str, int] | None:
        """The config of an exact shape tuple (``data_params`` order), or
        None."""
        hashes = self.hashes
        cap = hashes.shape[0]
        h = pack_shape(key)
        slot = h & (cap - 1)
        while True:
            stored = int(hashes[slot])
            if stored == int(_EMPTY):
                return None
            if stored == h:
                dims = self.dims[slot]
                for i, v in enumerate(key):
                    if int(dims[i]) != v:
                        break
                else:
                    row = self.rows[slot]
                    return {p: int(row[i])
                            for i, p in enumerate(self.program_params)}
            slot = (slot + 1) & (cap - 1)

    def lookup(self, D: Dims) -> dict[str, int] | None:
        """The config of data parameters ``D`` (other keys ignored), or
        None, also when ``D`` lacks one of this plan's data params."""
        try:
            key = tuple(int(D[d]) for d in self.data_params)
        except (KeyError, TypeError, ValueError):
            return None
        return self.lookup_key(key)

    def __len__(self) -> int:
        return self.n_entries

    def entries(self) -> list[tuple[dict[str, int], dict[str, int]]]:
        """(shape, config) pairs in slot order."""
        out = []
        for slot in np.flatnonzero(self.hashes != _EMPTY):
            out.append((
                {d: int(self.dims[slot][i])
                 for i, d in enumerate(self.data_params)},
                {p: int(self.rows[slot][i])
                 for i, p in enumerate(self.program_params)},
            ))
        return out

    def to_device(self, device="cuda"):
        """This table as a ``DevicePlanTable`` on ``device`` (see
        core/device_plan.py), whose probe is torch ops with no host sync:
        the card unless the caller passes ``"cpu"``."""
        from .device_plan import DevicePlanTable

        return DevicePlanTable.from_table(self, device=device)

    # -- persistence ---------------------------------------------------------
    def to_json(self) -> dict:
        """JSON-able payload: the dense rows, rebuilt into a probe table on
        load (the capacity is not part of the artifact).  ``code`` is
        written only when set, so a plan without it has the JAX package's
        layout."""
        used = np.flatnonzero(self.hashes != _EMPTY)
        raw = {
            "kernel": self.kernel,
            "hw_name": self.hw_name,
            "data_params": list(self.data_params),
            "program_params": list(self.program_params),
            "tuning_version": self.tuning_version,
            "source_hash": self.source_hash,
            "shapes": self.dims[used].tolist(),
            "configs": self.rows[used].tolist(),
        }
        if self.code:
            raw["code"] = self.code
        return raw

    @classmethod
    def from_json(cls, raw: Mapping[str, Any]) -> "LaunchPlanTable":
        data_params = tuple(raw["data_params"])
        program_params = tuple(raw["program_params"])
        shapes = np.asarray(raw["shapes"], dtype=np.int64).reshape(
            -1, len(data_params))
        configs = np.asarray(raw["configs"], dtype=np.int64).reshape(
            -1, len(program_params))
        return cls.build(
            raw["kernel"], raw["hw_name"], data_params, program_params,
            shapes={d: shapes[:, i] for i, d in enumerate(data_params)},
            configs={p: configs[:, i] for i, p in enumerate(program_params)},
            tuning_version=int(raw.get("tuning_version", 0)),
            source_hash=raw.get("source_hash", ""),
            code=raw.get("code", ""),
        )


def plan_key(kernel: str, hw_name: str,
             envelope: Mapping[str, Sequence[int]] | Mapping[str, np.ndarray],
             tuning_version: int = 0, source_hash: str = "",
             code: str = "") -> str:
    """Address of one compiled plan: kernel, card, envelope, the exact
    driver it partially evaluates (source hash and tuning generation) and,
    when given, the kernel code that driver serves -- a refit, a rebuilt
    driver, edited kernel code or another envelope is another artifact."""
    payload = {
        "kernel": kernel,
        "hw_name": hw_name,
        "tuning_version": tuning_version,
        "source_hash": source_hash,
        "envelope": {k: np.asarray(v, dtype=np.int64).reshape(-1).tolist()
                     for k, v in sorted(envelope.items())},
    }
    if code:
        payload["code"] = code
    return hashlib.sha256(json.dumps(
        payload, sort_keys=True, separators=(",", ":")).encode()).hexdigest()


def compile_plan(driver, D_table: Mapping[str, Sequence[int]],
                 margin: float = 0.02,
                 hw: HardwareParams | None = None) -> LaunchPlanTable:
    """Partially evaluate a driver over a traffic envelope into a plan.

    ``D_table`` is columnar: aligned per-data-param value columns, one row
    per shape (``lattice`` builds one from per-axis value lists).  One
    ``choose_many`` pass decides every shape, and the feasible rows are
    frozen into a ``LaunchPlanTable`` stamped with the driver's tuning
    generation, source hash and code digest, for ``hw`` (default the
    hardware the driver was tuned for).
    """
    cols = {d: np.asarray(D_table[d], dtype=np.int64).reshape(-1)
            for d in driver.data_params}
    configs, ok = driver.choose_many(cols, margin=margin)
    return LaunchPlanTable.build(
        kernel=driver.kernel, hw_name=(hw or driver.hw).name,
        data_params=driver.data_params,
        program_params=driver.program_params,
        shapes=cols, configs=configs, ok=ok,
        tuning_version=driver.tuning_version,
        source_hash=driver.source_hash, code=driver.code)


def precompile_plans(envelopes: Mapping[str, Mapping[str, Sequence[int]]],
                     hw: HardwareParams | None = None,
                     cache: bool = True, margin: float = 0.02) -> dict:
    """Plans for a serving process's traffic envelope, compiled or read.

    For each ``kernel -> {data_param: values}`` entry: the kernel's
    registered driver (``warm_start_from_cache`` registers the cached
    ones; a read of the driver cache needs the kernel's spec), then the
    cached plan of that driver, code and envelope, else
    one ``choose_many`` pass over the envelope's lattice, written through
    to the cache (``cache=True``; a failed write warns once and the plan
    still serves this process).  The plan is registered.  A kernel with no
    driver is skipped.  ``hw`` defaults to the hardware each driver was
    tuned for (on the card, ``driver.local_hw()`` for a driver timed
    there), the name ``choose_or_default`` keys its plan probe on.

    Returns a summary: the ``compiled`` / ``loaded`` / ``skipped`` kernel
    lists and the total of ``entries``.
    """
    global _plan_write_warned
    from .cache import PlanEntry, default_cache
    from .driver import get_driver, registry

    store = default_cache() if cache else None
    summary: dict[str, Any] = {"compiled": [], "loaded": [], "skipped": [],
                               "entries": 0}
    for kernel, axes in envelopes.items():
        driver = get_driver(kernel)
        if driver is None:
            summary["skipped"].append(kernel)
            continue
        khw = hw or driver.hw
        key = plan_key(kernel, khw.name, axes, driver.tuning_version,
                       driver.source_hash, driver.code)
        plan = None
        if store is not None:
            entry = store.get_plan(kernel, key)
            if entry is not None:
                try:
                    plan = LaunchPlanTable.from_json(entry.plan)
                    summary["loaded"].append(kernel)
                except (KeyError, ValueError, TypeError):
                    plan = None
        if plan is None:
            plan = compile_plan(driver, lattice(axes), margin=margin, hw=khw)
            summary["compiled"].append(kernel)
            if store is not None:
                try:
                    store.put_plan(PlanEntry(
                        kernel=kernel, key=key, hw_name=khw.name,
                        plan=plan.to_json(), created_at=time.time(),
                        tuning_version=driver.tuning_version))
                except OSError as e:
                    if not _plan_write_warned:
                        _plan_write_warned = True
                        logger.warning(
                            "launch-plan artifact write failed (%s) for "
                            "kernel %s; plans will not persist, so every "
                            "process compiles its envelope anew (point "
                            "KLARAPTOR_CACHE_DIR at a writable directory)",
                            e, kernel)
        registry.register_plan(plan)
        summary["entries"] += len(plan)
    return summary
