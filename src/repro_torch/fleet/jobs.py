"""Content-keyed probe jobs: the farm's unit of idempotent work.

A ``ProbeJob`` is a JSON document that fully describes one piece of probe
work -- kernel spec (by constructor reference), device oracle (by value),
data shape, seeds, budget -- plus a content key (sha256 of the canonical
payload).  The farm leans on two consequences:

* **idempotence** -- under a seeded oracle (``HopperModel``) executing the
  same job twice gives the same bytes, so a reassigned lease or a
  speculative duplicate cannot corrupt the merge: the second result is
  dropped by key.  On the card (``CudaEventTimer``) two executions time
  the same rows (D, configs, repeats) for the strategies whose rows do not
  read the times, but never to the same bytes; the second result is still
  dropped by key, never merged;
* **dedup** -- resubmitting identical work (a coordinator restart, a
  retry) collapses onto the same spool entry.

Job kinds:

  ``batch``   one probe-size shard of a collect run (``collect_batch``)
  ``kernel``  a whole kernel's collect -- for strategies with cross-size
              state (successive halving's survivors) that cannot shard
  ``rows``    one row chunk of a single probe call (finest grain; noise
              comes from ``chunk_noise_seed`` so placement is invisible)
  ``retune``  a budget-capped drift reaction (search -> refit -> versioned
              cache write-through) for one ledger-fed drift key

The port's payloads carry no ``max_stages``: the Hopper collect has no
TPU stage count (core/collect.py).

``WallClockSim`` wraps a simulator so probe calls take wall time in
proportion to the simulated device-seconds they return: the stand-in for
the card in CPU tests of the farm's supervision.  Given ``card_lock`` (a
lock file's path) it holds that ``CardLock`` while it probes, as
``CudaEventTimer`` holds the card's, so CPU tests show workers taking
turns on one card.  Its fingerprint is the inner oracle's, so farm-built
drivers share cache keys with plain single-process builds.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib
import json
import time
from dataclasses import dataclass
from typing import Any, Callable, Mapping

import numpy as np

from ..core.card_lock import CardLock
from ..core.device_model import (H100, CudaEventTimer, DeviceModel,
                                 HardwareParams, HopperModel, RowProbe)

__all__ = [
    "JOB_KINDS", "ProbeJob", "SpecRef", "WallClockSim", "device_from_json",
    "device_to_json", "hw_by_name", "job_key", "make_job", "tier1_spec_refs",
]

JOB_KINDS = ("batch", "kernel", "rows", "retune")


def _card_hw() -> HardwareParams | None:
    """The present card's parameters, or None without a card."""
    import torch

    if not torch.cuda.is_available():
        return None
    return HardwareParams.from_device("cuda")


def hw_by_name(name: str) -> HardwareParams:
    """The port's hardware table by name: ``h100_sxm_cc90`` (the
    compute-capability-9.0 table) or the name of the card present
    (``HardwareParams.from_device()``)."""
    if name == H100.name:
        return H100
    card = _card_hw()
    if card is not None and name == card.name:
        return card
    known = [H100.name] + ([card.name] if card is not None else [])
    raise KeyError(f"unknown hardware {name!r}; known: {known}")


@dataclass(frozen=True)
class SpecRef:
    """A kernel spec by constructor reference (module:function(**kwargs)).

    Jobs must be self-contained JSON, and a ``KernelSpec`` is cheap to
    rebuild from its constructor -- so jobs carry the recipe, not the
    object.  The reference is part of the job's content key.
    """

    module: str
    func: str
    kwargs: tuple = ()

    def build(self):
        fn = getattr(importlib.import_module(self.module), self.func)
        return fn(**dict(self.kwargs))

    def to_json(self) -> dict:
        return {"module": self.module, "func": self.func,
                "kwargs": [list(kv) for kv in self.kwargs]}

    @classmethod
    def from_json(cls, d: Mapping) -> "SpecRef":
        return cls(module=d["module"], func=d["func"],
                   kwargs=tuple((k, v) for k, v in d.get("kwargs", ())))


def tier1_spec_refs() -> dict[str, SpecRef]:
    """The four tier-1 kernels, keyed by their spec names: ``matmul_b16``,
    ``flash_attn_d128_causal``, ``moe_gmm_b16``, ``ssd_scan_h64_n128``."""
    refs = {}
    for func in ("matmul_spec", "flash_attention_spec", "moe_gmm_spec",
                 "ssd_scan_spec"):
        ref = SpecRef("repro_torch.core", func)
        refs[ref.build().name] = ref
    return refs


# -- device oracles over the wire ---------------------------------------------

class WallClockSim(DeviceModel):
    """Wall-clock-faithful wrapper around a simulator oracle.

    Probe results delegate to the inner simulator (the same data, the same
    fingerprint, so the same cache keys), but every ``probe_rows`` call
    sleeps ``scale`` x the simulated device-seconds it produced.  Sleeps
    happen in small slices with ``beat`` called between them, so a live
    worker keeps heartbeating through a long probe while a hung worker
    (which stops beating) is still told apart.
    """

    def __init__(self, inner: DeviceModel, scale: float,
                 beat: Callable[[], None] | None = None,
                 slice_s: float = 0.05, card_lock: str | None = None):
        self.inner = inner
        self.scale = float(scale)
        self.beat = beat
        self.slice_s = float(slice_s)
        self.card_lock = card_lock

    def _on_card(self):
        if self.card_lock is None:
            return contextlib.nullcontext()
        return CardLock(self.card_lock).hold(self.beat)

    @property
    def hw(self) -> HardwareParams:  # type: ignore[override]
        return self.inner.hw

    def fingerprint(self) -> dict:
        return self.inner.fingerprint()    # timing envelope is data-invisible

    def _sleep(self, seconds: float) -> None:
        deadline = time.monotonic() + max(seconds, 0.0)
        while True:
            if self.beat is not None:
                self.beat()
            left = deadline - time.monotonic()
            if left <= 0:
                return
            time.sleep(min(left, self.slice_s))

    def probe_rows(self, table, rng, repeats=1) -> RowProbe:
        with self._on_card():
            probe = self.inner.probe_rows(table, rng, repeats)
            self._sleep(float(np.sum(probe.device_seconds)) * self.scale)
        return probe

    def probe_batch(self, table, rng, repeats=1):
        with self._on_card():
            batch = self.inner.probe_batch(table, rng, repeats)
            self._sleep(float(np.sum(batch.total_time_s)) * self.scale)
        return batch

    def true_time_batch(self, table) -> np.ndarray:
        return self.inner.true_time_batch(table)


def device_to_json(device: DeviceModel) -> dict:
    """Serialize a device oracle into a job payload (by value)."""
    if isinstance(device, WallClockSim):
        out = {"kind": "wallclock", "scale": device.scale,
               "inner": device_to_json(device.inner)}
        if device.card_lock is not None:
            out["card_lock"] = device.card_lock
        return out
    if isinstance(device, HopperModel):
        return {"kind": "hopper_model", "hw": device.hw.name,
                "noise": device.noise, "seed": device._seed}
    if isinstance(device, CudaEventTimer):
        return {"kind": "cuda_event_timer", "hw": device.hw.name,
                "warmup": device.warmup, "timings": device.timings,
                "seed": device.seed}
    raise TypeError(
        f"cannot serialize device oracle {type(device).__name__} into a "
        f"fleet job (teach fleet.jobs.device_to_json about it)")


def device_from_json(d: Mapping,
                     beat: Callable[[], None] | None = None) -> DeviceModel:
    """Rebuild a job's oracle here.  A ``CudaEventTimer`` is rebuilt on this
    process's current card, which must be the card model the job was
    tuned for: another model raises."""
    kind = d.get("kind")
    if kind == "wallclock":
        return WallClockSim(device_from_json(d["inner"]), d["scale"],
                            beat=beat, card_lock=d.get("card_lock"))
    if kind == "hopper_model":
        return HopperModel(hw=hw_by_name(d["hw"]), noise=d["noise"],
                           seed=d["seed"])
    if kind == "cuda_event_timer":
        here = _card_hw()
        if here is None:
            raise RuntimeError(
                f"the job times {d['hw']} on the card and this process "
                f"has no CUDA device")
        if here.name != d["hw"]:
            raise ValueError(
                f"the job was tuned for {d['hw']!r}; this card is "
                f"{here.name!r}")
        return CudaEventTimer(here, warmup=d["warmup"], timings=d["timings"],
                              seed=d["seed"], beat=beat)
    raise KeyError(f"unknown device kind {kind!r}")


# -- jobs ---------------------------------------------------------------------

def _json_default(o: Any):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"Object of type {type(o).__name__} "
                    f"is not JSON serializable")


def _canonical(obj: Any) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      default=_json_default)


def job_key(kind: str, payload: Mapping) -> str:
    """Content address of one job: same work -> same key, always."""
    return hashlib.sha256(
        _canonical({"kind": kind, "payload": payload}).encode()).hexdigest()


@dataclass(frozen=True)
class ProbeJob:
    """One idempotent unit of farm work (see module docstring for kinds)."""

    kind: str
    payload: dict
    key: str

    def to_json(self) -> dict:
        return {"kind": self.kind, "payload": self.payload, "key": self.key}


def make_job(kind: str, payload: Mapping) -> ProbeJob:
    if kind not in JOB_KINDS:
        raise ValueError(f"unknown job kind {kind!r}; known: {JOB_KINDS}")
    payload = json.loads(_canonical(payload))   # normalize (tuples -> lists)
    return ProbeJob(kind=kind, payload=payload,
                    key=job_key(kind, payload))
