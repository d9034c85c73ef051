"""Device-resident launch plans: the on-card form of a compiled plan.

``core/plan.py`` freezes a driver's choices into a host-side
``LaunchPlanTable`` -- an O(1) probe, but a *Python* probe.
``DevicePlanTable`` is its lowering to tensors on a device: the frozen
table's slots become a hash column, a raw-dimension matrix, a config-row
matrix and an occupancy mask, and ``lookup`` is torch ops -- hash the
query dims with a murmur3-finalizer chain, then an *unrolled*
open-addressing probe of ``max_probe`` masked gathers (the longest
displacement chain the build produced; with load factor <= 1/2 a handful).
There is no early exit and no host sync: every probe step is a masked
gather, so the lookup has static shapes and can be captured in a graph.

Why not reuse the host table's splitmix64 keys: the JAX package hashes in
uint32 on both sides (its device arrays are 32-bit), so the device table
keys on a 32-bit fmix32 chain.  torch has no full uint32 arithmetic, so the
chain runs in int64 with each 32 x 32-bit multiply split into two 16-bit
halves that never overflow, masked back to 32 bits: the same values as the
host ``_fmix32`` and the JAX package's ``pack_shape32``.  Like the host
table, every probe step verifies the raw dimensions, so a 32-bit hash
collision costs one masked compare, never a wrong config.

``lookup_dims`` (the host form) runs the same probe over host copies of
the same arrays -- it never touches the device, so a launch decided while a
CUDA graph is being captured can use it -- and returns bit-identical
configs to ``LaunchPlanTable.lookup`` for every shape, hit or miss; the
tests hold ``lookup`` on the device to it.

``BucketedDispatch`` pairs a ``core.buckets.BucketLattice`` with the
device table: raw dims -> bucket (rounded up) -> the bucket's config row
-> a branch index over the table's small static config set, with an
out-of-range or unplanned bucket landing on the trailing default branch.
``branch_index`` makes that decision in torch ops on the table's device;
``host_index`` replays it on the host, bit for bit.  The JAX package feeds
the device index to ``jax.lax.switch`` inside its compiled step; PyTorch
launches from the host, so the port's ops take the branch from
``host_index`` and each branch is one CUDA graph (``kernels/ops.py``,
``in_graph=``).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Mapping, Sequence

import numpy as np
import torch

from .buckets import BucketLattice
from .device_model import resolve_device
from .plan import LaunchPlanTable

__all__ = ["BucketedDispatch", "DevicePlanTable", "build_bucketed_dispatch",
           "pack_shape32"]

logger = logging.getLogger(__name__)

Dims = Mapping[str, int]

_M32 = 0xFFFFFFFF
_SEED32 = 0x9E3779B9
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35


def _fmix32(x: int) -> int:
    """murmur3 32-bit finalizer (host side, plain-int arithmetic)."""
    x &= _M32
    x ^= x >> 16
    x = (x * _C1) & _M32
    x ^= x >> 13
    x = (x * _C2) & _M32
    x ^= x >> 16
    return x


def pack_shape32(values: Sequence[int]) -> int:
    """Pack a shape tuple into one uint32 key (fmix32 chain).

    The 32-bit sibling of ``plan.pack_shape``: same chain structure, but
    every step is exact uint32 arithmetic, so the torch lowering computes
    the identical value.  Collisions are more likely than in 64 bits and
    equally harmless -- the table verifies raw dimensions on every probe.
    """
    h = _SEED32
    for v in values:
        h = _fmix32(h ^ _fmix32(int(v) & _M32))
    return h


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32): the constant split into
    16-bit halves, so no product leaves int64."""
    lo = x * (c & 0xFFFF)                       # < 2^48
    hi = (x * (c >> 16)) & 0xFFFF               # only its low 16 bits count
    return (lo + (hi << 16)) & _M32


def _fmix32_t(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 13)
    x = _mul32(x, _C2)
    return x ^ (x >> 16)


def _pack_shape32_t(keys: torch.Tensor) -> torch.Tensor:
    """uint32 shape hash of int keys (n_data,) as an int64 scalar tensor on
    their device (unrolled over the data params; mirrors ``pack_shape32``
    step for step)."""
    keys = keys.to(torch.int64) & _M32
    h = torch.full((), _SEED32, dtype=torch.int64, device=keys.device)
    for i in range(keys.shape[0]):
        h = _fmix32_t(h ^ _fmix32_t(keys[i]))
    return h


@dataclass
class DevicePlanTable:
    """Tensor lowering of one frozen ``LaunchPlanTable``.

    Tensors on ``device`` (built once, never mutated):

      * ``hashes``   -- (capacity,) int64 holding uint32 packed shape keys,
      * ``occupied`` -- (capacity,) bool slot-in-use mask (any uint32 is a
                        valid hash, so emptiness needs its own column),
      * ``dims``     -- (capacity, n_data_params) int32 raw shape values,
      * ``rows``     -- (capacity, n_program_params) int32 config rows.

    ``max_probe`` is the longest insertion displacement chain + 1: a
    present key is always found within ``max_probe`` steps of its home
    slot, so the unrolled probe needs exactly that many gathers.  ``host``
    holds the same four arrays in numpy, for ``lookup_dims``.
    """

    kernel: str
    hw_name: str
    data_params: tuple[str, ...]
    program_params: tuple[str, ...]
    tuning_version: int
    capacity: int
    max_probe: int
    hashes: torch.Tensor = field(repr=False)
    occupied: torch.Tensor = field(repr=False)
    dims: torch.Tensor = field(repr=False)
    rows: torch.Tensor = field(repr=False)
    n_entries: int = 0
    source_hash: str = ""
    host: tuple = field(default=(), repr=False)

    @classmethod
    def from_table(cls, table: LaunchPlanTable,
                   device: torch.device | str = "cuda") -> "DevicePlanTable":
        """Lower a frozen host table onto ``device`` (the card unless the
        caller passes ``"cpu"``; without a card it raises); re-keys every
        entry under the 32-bit hash (capacities and probe chains differ
        from the host table's, the *content* -- shape -> config -- is
        identical by construction)."""
        device = resolve_device(device)
        entries = table.entries()
        n = len(entries)
        cap = 1
        while cap < max(2 * n, 2):
            cap *= 2
        hashes = np.zeros(cap, dtype=np.int64)
        occupied = np.zeros(cap, dtype=bool)
        dims = np.zeros((cap, len(table.data_params)), dtype=np.int32)
        rows = np.zeros((cap, len(table.program_params)), dtype=np.int32)
        max_probe = 0
        for shape, cfg in entries:
            key = tuple(int(shape[d]) for d in table.data_params)
            h = pack_shape32(key)
            slot = h & (cap - 1)
            steps = 1
            while occupied[slot]:
                # Host-table entries are unique shapes; no duplicate check.
                slot = (slot + 1) & (cap - 1)
                steps += 1
            hashes[slot] = h
            occupied[slot] = True
            dims[slot] = key
            rows[slot] = [int(cfg[p]) for p in table.program_params]
            max_probe = max(max_probe, steps)

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a).to(device)

        return cls(
            kernel=table.kernel, hw_name=table.hw_name,
            data_params=table.data_params,
            program_params=table.program_params,
            tuning_version=table.tuning_version,
            capacity=cap, max_probe=max_probe,
            hashes=put(hashes), occupied=put(occupied), dims=put(dims),
            rows=put(rows), n_entries=n, source_hash=table.source_hash,
            host=(hashes, occupied, dims, rows),
        )

    @property
    def device(self) -> torch.device:
        return self.hashes.device

    # -- the on-device hot path -----------------------------------------------
    def lookup(self, keys) -> tuple[torch.Tensor, torch.Tensor]:
        """Probe in torch ops on the table's device: ``keys`` is the shape
        tuple in ``data_params`` order (tensor or sequence, int32).
        Returns ``(config_row, found)`` -- an int32 (n_program_params,)
        tensor (-1s on a miss) and a bool scalar -- with no host sync."""
        keys = torch.as_tensor(keys, dtype=torch.int32, device=self.device)
        row = torch.full((len(self.program_params),), -1, dtype=torch.int32,
                         device=self.device)
        found = torch.zeros((), dtype=torch.bool, device=self.device)
        if self.max_probe == 0:        # empty table: nothing can be found
            return row, found
        h = _pack_shape32_t(keys)
        slot0 = h & (self.capacity - 1)
        for i in range(self.max_probe):
            slot = (slot0 + i) & (self.capacity - 1)
            hit = (self.occupied[slot]
                   & (self.hashes[slot] == h)
                   & torch.all(self.dims[slot] == keys)
                   & ~found)
            row = torch.where(hit, self.rows[slot], row)
            found = found | hit
        return row, found

    # -- the host form ---------------------------------------------------------
    def lookup_dims(self, D: Dims) -> dict[str, int] | None:
        """The same probe on the host copies, with ``LaunchPlanTable.lookup``
        semantics (extra keys ignored, missing data param -> None): the
        surface the tests hold against the source table and against
        ``lookup`` on the device.  Touches no device."""
        try:
            keys = tuple(int(D[d]) for d in self.data_params)
        except (KeyError, TypeError, ValueError):
            return None
        hashes, occupied, dims, rows = self.host
        h = pack_shape32(keys)
        for i in range(self.max_probe):
            slot = ((h & (self.capacity - 1)) + i) & (self.capacity - 1)
            if occupied[slot] and int(hashes[slot]) == h and \
                    tuple(int(v) for v in dims[slot]) == keys:
                return {p: int(rows[slot][j])
                        for j, p in enumerate(self.program_params)}
        return None

    def __len__(self) -> int:
        return self.n_entries


@dataclass(frozen=True)
class BucketedDispatch:
    """Bucketed config dispatch for one kernel.

    The pieces: a ``BucketLattice`` (raw dims -> bucket keys, identical
    host/device rounding), the bucket plan lowered to a ``DevicePlanTable``
    (bucket keys -> config row), and the table's *distinct* config rows
    frozen as a static tuple.  ``branch_index`` composes them on the
    device: gathered row -> index into the static set, with the trailing
    index (``len(configs)``) reserved for the default branch -- taken on
    an out-of-range raw shape, an unplanned bucket, or (empty table, no
    driver) always.

    A launch per branch, each with one static config over envelope-padded
    operands, then has static shapes: new raw shapes move the *index*,
    never what was captured.  ``host_index`` replays the exact device
    decision on the host -- what the ops launch by, and what the engine's
    per-step bucket stats use.
    """

    lattice: BucketLattice
    table: DevicePlanTable
    configs: tuple[tuple[int, ...], ...]
    default: tuple[int, ...]
    program_params: tuple[str, ...]

    @classmethod
    def build(cls, lattice: BucketLattice,
              table: "LaunchPlanTable | DevicePlanTable",
              default: Mapping[str, int],
              device: torch.device | str = "cuda") -> "BucketedDispatch":
        """Freeze one plan table (host or device form; a host table is
        lowered onto ``device``, the card unless the caller passes
        ``"cpu"``) into a dispatch.

        The static config set is the table's distinct config rows, sorted
        for determinism -- for a tuned kernel over a handful of buckets
        this is small (often smaller than the bucket count: nearby buckets
        share configs), which keeps the branch count, and the captures,
        small.
        """
        if isinstance(table, LaunchPlanTable):
            table = table.to_device(device)
        if tuple(lattice.data_params) != tuple(table.data_params):
            raise ValueError(
                f"bucket lattice params {lattice.data_params} do not match "
                f"plan table params {table.data_params} for "
                f"{table.kernel}")
        _, occupied, _, rows = table.host
        rows = rows[occupied]
        distinct = sorted({tuple(int(v) for v in r) for r in rows})
        default_row = tuple(int(default[p]) for p in table.program_params)
        return cls(lattice=lattice, table=table,
                   configs=tuple(distinct), default=default_row,
                   program_params=tuple(table.program_params))

    # -- introspection -------------------------------------------------------
    @property
    def n_branches(self) -> int:
        return len(self.configs) + 1

    def config_dicts(self) -> list[dict[str, int]]:
        """One config dict per branch, default branch last."""
        out = [dict(zip(self.program_params, c)) for c in self.configs]
        out.append(dict(zip(self.program_params, self.default)))
        return out

    def raw_keys(self, dims) -> torch.Tensor:
        """Normalize raw dims (mapping or tensor / sequence) to the
        (n_params,) int32 key vector in lattice order, on the table's
        device."""
        if isinstance(dims, Mapping):
            dims = [int(dims[d]) for d in self.lattice.data_params]
        return torch.as_tensor(dims, dtype=torch.int32,
                               device=self.table.device)

    # -- the on-device hot path -----------------------------------------------
    def branch_index(self, dims) -> tuple[torch.Tensor, torch.Tensor]:
        """Raw dims -> (branch index int32, hit bool), as torch ops on the
        table's device with no host sync.

        Bucket the raw dims, gather the bucket's row from the device
        table, and match the gathered row against the static config set.
        Every step is a masked compare -- no data-dependent control flow
        -- and a miss of any kind yields index ``len(configs)`` (the
        default branch).
        """
        raw = self.raw_keys(dims)
        keys, in_range = self.lattice.bucket_keys(raw)
        row, found = self.table.lookup(keys)
        hit = found & in_range
        idx = torch.full((), len(self.configs), dtype=torch.int32,
                         device=raw.device)
        for i, cfg in enumerate(self.configs):
            want = torch.tensor(cfg, dtype=torch.int32, device=raw.device)
            match = hit & torch.all(row == want)
            idx = torch.where(match, torch.full_like(idx, i), idx)
        return idx, hit

    # -- host replay ----------------------------------------------------------
    def host_index(self, D: Mapping[str, int]) -> tuple[int, bool]:
        """The exact decision ``branch_index`` makes, replayed on the host
        (bucket via ``bucket_of``, row via ``lookup_dims`` -- both proven
        bit-identical to their device forms)."""
        bucket = self.lattice.bucket_of(D)
        if bucket is None:
            return len(self.configs), False
        cfg = self.table.lookup_dims(bucket)
        if cfg is None:
            return len(self.configs), False
        row = tuple(int(cfg[p]) for p in self.program_params)
        try:
            return self.configs.index(row), True
        except ValueError:          # unreachable: configs spans the table
            return len(self.configs), False

    def host_config(self, D: Mapping[str, int]) -> tuple[dict[str, int], bool]:
        """(config the launch takes, bucket hit?) for raw ``D``."""
        idx, hit = self.host_index(D)
        return self.config_dicts()[idx], hit

    def observe(self, D: Mapping[str, int], n_coalesced: int = 1
                ) -> tuple[bool, float]:
        """Host-side accounting for one dispatch of raw shape ``D``.

        Returns (bucket hit?, padding-waste fraction) and emits one
        ``ChoiceEvent`` with ``source="bucket"`` (``"default"`` on a
        miss) to the process-wide choice listener -- the engine replays
        the decision here at step granularity (a bisect and a table probe).
        """
        cfg, hit = self.host_config(D)
        waste = self.lattice.padding_waste(D) if hit else 0.0
        from .driver import ChoiceEvent, get_choice_listener

        listener = get_choice_listener()
        if listener is not None:
            try:
                listener(ChoiceEvent(
                    kernel=self.table.kernel, D=dict(D), config=dict(cfg),
                    source="bucket" if hit else "default",
                    predicted_s=None, hw_name=self.table.hw_name,
                    n_coalesced=n_coalesced, t_ns=time.monotonic_ns()))
            except Exception:
                logger.warning("choice listener raised during bucket "
                               "observe; event dropped", exc_info=True)
        return hit, waste


def build_bucketed_dispatch(kernel: str, lattice: BucketLattice,
                            default: Mapping[str, int], hw=None,
                            cache: bool = True, margin: float = 0.02,
                            device: torch.device | str = "cuda"
                            ) -> BucketedDispatch:
    """Compile (or load) the lattice's launch plan and freeze it for
    bucketed dispatch on ``device`` (the card unless the caller passes
    ``"cpu"``; without a card it raises before anything is compiled).

    One ``precompile_plans`` pass over the lattice envelope gives a plan
    table covering every bucket the registered driver finds feasible
    (persisted through the driver cache like any plan); the registered
    table is then lowered and frozen.  ``hw`` defaults as
    ``precompile_plans``'s does, to the hardware the driver was tuned for
    (the name the registry keys the kernel on).  With no driver for
    ``kernel`` the table is empty and every shape takes the default
    branch -- still never another capture, which is the contract callers
    rely on.
    """
    from .driver import registry
    from .plan import precompile_plans

    device = resolve_device(device)
    precompile_plans({kernel: lattice.envelope()}, hw=hw, cache=cache,
                     margin=margin)
    hw_name = hw.name if hw is not None else registry.hw_name(kernel)
    plan = registry.plan(kernel, hw_name)
    if plan is None:
        program_params = tuple(default)
        plan = LaunchPlanTable.build(
            kernel, hw_name, lattice.data_params, program_params,
            shapes={d: np.zeros(0, dtype=np.int64)
                    for d in lattice.data_params},
            configs={p: np.zeros(0, dtype=np.int64)
                     for p in program_params})
    return BucketedDispatch.build(lattice, plan, default, device=device)
