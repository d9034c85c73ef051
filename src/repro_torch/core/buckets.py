"""Bucket lattices: the static shape grid that lets one captured step serve
every raw shape.

KLARAPTOR's launch decision is cheap because it is a rational-program
evaluation, not a rebuild -- but a serving step captured as a CUDA graph
holds the shapes, the addresses and the launch configs it was captured with,
so a step for every distinct input shape would re-pay a capture per shape.
The fix is the bucketed-serving contract: raw data parameters are rounded
*up* to a small static lattice (integer log2 steps), tensors are zero-padded
to the bucket envelope, and the launch config for the bucket comes from a
frozen table (``core.device_plan.BucketedDispatch``), so one capture per
config branch serves the whole lattice and a fresh request shape never adds
a capture.

``BucketLattice`` is the host/device-shared piece: per-data-param sorted
value grids with identical "smallest lattice value >= v" rounding on the
host (``bucket_of``) and in torch ops on the device (``bucket_keys``) --
bit-identical by construction.  ``from_spec`` derives the grid from the
spec's feasibility: powers of two trimmed to the values where the kernel
spec still has at least one feasible candidate on the target card, so the
lattice never contains a bucket the kernel could not launch.

This is the JAX package's ``core/buckets.py`` with ``pad_to`` and
``bucket_keys`` on torch tensors and the H100 table as the default
hardware.
"""

from __future__ import annotations

import bisect
import functools
import math
from dataclasses import dataclass
from typing import Mapping, Sequence

import torch
import torch.nn.functional as F

from .device_model import resolve_device

__all__ = ["BucketLattice", "pad_to", "pow2_span"]

Dims = Mapping[str, int]


def pow2_span(lo: int, hi: int) -> tuple[int, ...]:
    """Powers of two covering [lo, hi]: ceil(lo) to ceil(hi) in log2."""
    lo, hi = int(lo), int(hi)
    a = 0 if lo <= 1 else int(math.ceil(math.log2(lo)))
    b = 0 if hi <= 1 else int(math.ceil(math.log2(hi)))
    return tuple(2 ** e for e in range(a, b + 1))


def pad_to(x: torch.Tensor, targets: Sequence[int | None]) -> torch.Tensor:
    """Zero-pad ``x`` up to per-dimension ``targets`` (None keeps a dim).

    Padding is always trailing (the bucket envelope owns the tail), an
    exact match returns ``x`` itself, and a target smaller than the actual
    extent raises rather than silently truncating data.
    """
    pads = []
    for dim, tgt in zip(x.shape, targets):
        if tgt is None:
            pads.append(0)
            continue
        if int(tgt) < int(dim):
            raise ValueError(
                f"pad_to target {tgt} smaller than extent {dim} "
                f"(shape {tuple(x.shape)})")
        pads.append(int(tgt) - int(dim))
    if not any(pads):
        return x
    flat = []
    for p in reversed(pads):         # F.pad takes the last dim first
        flat += [0, p]
    return F.pad(x, flat)


@functools.lru_cache(maxsize=None)
def _axis_values(values: tuple[int, ...], device: torch.device
                 ) -> torch.Tensor:
    """One axis's values as an int32 tensor on ``device``, made once."""
    return torch.tensor(values, dtype=torch.int32, device=device)


@dataclass(frozen=True)
class BucketLattice:
    """Static per-kernel bucket grid over the kernel's data parameters.

    ``axes`` holds (param, sorted distinct values) pairs in the *driver's*
    ``data_params`` order -- the same order ``DevicePlanTable`` hashes
    lookup keys in, so bucket keys feed the table directly.  Rounding is
    "smallest lattice value >= v"; a value above the top of its axis is
    out of range (host: ``bucket_of`` returns None; device: the
    ``in_range`` mask goes False) and dispatch falls to the default
    branch rather than padding data down.
    """

    kernel: str
    axes: tuple[tuple[str, tuple[int, ...]], ...]

    # -- construction --------------------------------------------------------
    @classmethod
    def from_axes(cls, kernel: str,
                  axes: Mapping[str, Sequence[int]]) -> "BucketLattice":
        """Explicit per-param bucket values (deduped, sorted ascending)."""
        cleaned = []
        for name, values in axes.items():
            vals = tuple(sorted({int(v) for v in values}))
            if not vals or vals[0] <= 0:
                raise ValueError(
                    f"bucket axis {name!r} needs positive values, "
                    f"got {values!r}")
            cleaned.append((name, vals))
        return cls(kernel=kernel, axes=tuple(cleaned))

    @classmethod
    def from_spec(cls, spec, ranges: Mapping[str, tuple[int, int]],
                  fixed: Mapping[str, Sequence[int]] | None = None,
                  hw=None) -> "BucketLattice":
        """Feasibility-derived lattice for one kernel spec.

        ``ranges`` maps data params to (lo, hi) raw-value spans; each gets
        the pow2 grid covering the span, then values where the spec has
        *no* feasible candidate on ``hw`` (default the H100 table; every
        config fails the shared-memory / alignment constraints at that
        size, with the other params at their smallest value) are trimmed.
        ``fixed`` params keep their explicit value lists (count-like params
        that never pad).
        """
        from .device_model import H100

        hw = hw if hw is not None else H100
        axes: dict[str, Sequence[int]] = {
            name: pow2_span(lo, hi) for name, (lo, hi) in ranges.items()}
        for name, values in (fixed or {}).items():
            axes[name] = tuple(int(v) for v in values)
        # Re-order to the spec's data_params order: the lattice key order
        # must match the plan/device tables compiled from the same driver.
        ordered = {d: axes[d] for d in spec.data_params if d in axes}
        for name in axes:
            if name not in ordered:
                ordered[name] = axes[name]
        base = {d: int(min(vs)) for d, vs in ordered.items()}
        trimmed: dict[str, tuple[int, ...]] = {}
        for name, values in ordered.items():
            keep = []
            for v in values:
                if name in (fixed or {}):
                    keep.append(int(v))
                    continue
                D = dict(base)
                D[name] = int(v)
                try:
                    feasible = len(spec.candidates(D, hw)) > 0
                except Exception:
                    feasible = False
                if feasible:
                    keep.append(int(v))
            if not keep:
                raise ValueError(
                    f"bucket axis {name!r} of {spec.name} has no feasible "
                    f"values in {values!r} on {hw.name}")
            trimmed[name] = tuple(keep)
        return cls.from_axes(spec.name, trimmed)

    # -- introspection -------------------------------------------------------
    @property
    def data_params(self) -> tuple[str, ...]:
        return tuple(name for name, _ in self.axes)

    @property
    def n_buckets(self) -> int:
        n = 1
        for _, values in self.axes:
            n *= len(values)
        return n

    def envelope(self) -> dict[str, list[int]]:
        """Per-param value lists -- the ``precompile_plans`` envelope that
        makes the plan table cover exactly this lattice."""
        return {name: list(values) for name, values in self.axes}

    def envelope_shape(self) -> dict[str, int]:
        """Top of each axis: the static padding target that lets one
        captured step accept every in-range raw shape."""
        return {name: values[-1] for name, values in self.axes}

    def all_buckets(self) -> list[dict[str, int]]:
        """Every lattice point as a data-param dict (cartesian order)."""
        out: list[dict[str, int]] = [{}]
        for name, values in self.axes:
            out = [{**d, name: v} for d in out for v in values]
        return out

    # -- host rounding -------------------------------------------------------
    def bucket_of(self, D: Dims) -> dict[str, int] | None:
        """Smallest lattice point >= D per axis, or None when any value is
        out of range (missing param, non-positive, or above the top)."""
        out = {}
        for name, values in self.axes:
            v = D.get(name)
            if v is None:
                return None
            v = int(v)
            if v < 1 or v > values[-1]:
                return None
            # first lattice value >= v (values sorted ascending)
            out[name] = values[bisect.bisect_left(values, v)]
        return out

    def bucket_key(self, D: Dims) -> tuple[int, ...] | None:
        b = self.bucket_of(D)
        if b is None:
            return None
        return tuple(b[name] for name, _ in self.axes)

    def padding_waste(self, D: Dims) -> float:
        """Fraction of the padded bucket volume that is padding:
        ``1 - prod(raw) / prod(bucket)``; 0.0 for an out-of-range miss
        (the default branch runs unpadded semantics)."""
        b = self.bucket_of(D)
        if b is None:
            return 0.0
        raw = 1.0
        padded = 1.0
        for name, _ in self.axes:
            raw *= float(D[name])
            padded *= float(b[name])
        return 1.0 - raw / padded if padded > 0 else 0.0

    # -- device rounding -----------------------------------------------------
    def bucket_keys(self, raw, device: torch.device | str = "cuda"
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Device-side rounding: raw dims (n_params,) int32 -> (bucket keys
        (n_params,) int32, in_range bool), as torch ops on ``raw``'s device
        (on ``device``, the card unless the caller says otherwise, for a
        raw that is not a tensor), with no host sync.  Arithmetic mirrors
        ``bucket_of`` exactly -- ``sum(values < v)`` is ``searchsorted
        left`` -- so host and device agree bit for bit on every bucket.
        """
        if not isinstance(raw, torch.Tensor):
            raw = torch.as_tensor(raw, device=resolve_device(device))
        raw = raw.to(torch.int32)
        keys = []
        in_range = torch.ones((), dtype=torch.bool, device=raw.device)
        for i, (_, values) in enumerate(self.axes):
            vals = _axis_values(values, raw.device)
            v = raw[i]
            idx = torch.clamp((vals < v).sum(), max=len(values) - 1)
            keys.append(vals[idx])
            in_range = in_range & (v >= 1) & (v <= values[-1])
        return torch.stack(keys), in_range
