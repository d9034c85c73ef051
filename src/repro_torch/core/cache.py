"""Persistent driver cache: tuned drivers survive the process.

KLARAPTOR builds the rational program R once, at compile time, and uses it
at run time in later processes.  This module is that hand-over: each built
driver program is written to disk as a JSON entry addressed by a *build
key*, the SHA-256 of

  * the driver's *code digest* (``code_digest``): the spec's fingerprint
    (``spec_fingerprint``: its grid, operands, FLOPs, threads, registers,
    compute unit, constraints, candidates and, for a derived spec, the
    compiled kernel's ``source_fingerprint``), the hash of the kernel
    library's CUDA sources (``device_model.kernel_sources_digest``) and
    the hash of the fitter's source (``fitter_digest``),
  * the hardware parameters (``dataclasses.asdict(hw)``), and
  * the build's hyperparameters, among them the oracle's ``fingerprint()``,

so any change to the spec, the kernel code, the fitter, the card or the
tuning settings misses by construction.  Each entry also stores its code digest: the
read-through (``lookup_latest`` with ``code``), whose caller knows a kernel
by name but not the build's settings, takes only an entry whose digest is
that of the caller's spec under the current sources, so a driver tuned for
an edited spec or ``.cu``, or fitted by another fitter, is never served.  A second hash, ``content_hash``
over the stored driver source, fits and code digest, is checked on every
read; an entry that fails it (a partial or edited file) is deleted and read
as a miss.  Writes are atomic.

Layout: ``<root>/repro_torch/<kernel>/<key>.json``, with the root
``$KLARAPTOR_CACHE_DIR`` or ``~/.cache/klaraptor``.  The ``repro_torch``
level keeps the port's entries apart from the JAX package's, which live at
``<root>/<kernel>/`` under the same root and share kernel names
(``matmul_b16``): neither package ever reads the other's drivers.

A second kind of entry, ``PlanEntry`` (``<kernel>/<key>.plan.json``),
stores a compiled launch plan (core/plan.py): the (shape -> config) table a
driver's ``choose_many`` gave over a traffic envelope, stamped with that
driver's ``source_hash`` and code digest.  Plan entries carry the same
content hash and ``tuning_version`` order as driver entries, and
``invalidate(below_version=...)`` evicts both kinds together: a plan is
frozen output of its fit generation and must not outlive it.

``Klaraptor.build_driver`` writes through this store; ``core.driver``
reads through it (``get_driver``, ``warm_start_from_cache``, and
``choose_or_default`` when no driver is registered and the caller passes
its spec), installing the newest plan of the driver it serves.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Mapping

from .device_model import HardwareParams, kernel_sources_digest
from .kernel_spec import KernelSpec
from .rational_program import Expr

__all__ = ["CacheEntry", "DriverCache", "PORT_DIR", "PlanEntry",
           "cache_key", "code_digest", "default_cache", "default_cache_dir",
           "driver_source_hash", "fitter_digest", "spec_fingerprint"]

# Version of the entry layout and of the key's recipe: a change to either
# must never find an older entry.
_ENTRY_VERSION = 1
# The port's level under the shared root.
PORT_DIR = "repro_torch"


def default_cache_dir() -> str:
    """The shared root: ``$KLARAPTOR_CACHE_DIR`` or ``~/.cache/klaraptor``
    (read anew on every call, so a process can redirect it)."""
    env = os.environ.get("KLARAPTOR_CACHE_DIR")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "klaraptor")


def _write_json_atomic(path: str, raw: Any) -> None:
    """Publish ``raw`` at ``path`` in one step: a temp file unique to this
    writer, then ``os.replace``, so a reader never sees half a document and
    concurrent writers of one key never interleave (the last one wins)."""
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".",
                               suffix=".tmp", dir=os.path.dirname(path))
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(raw, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def driver_source_hash(source: str) -> str:
    """Identity of a generated driver module (``DriverProgram.source_hash``;
    compiled plans carry it)."""
    return hashlib.sha256(source.encode()).hexdigest()[:16]


def _sha(payload: Any) -> str:
    canonical = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canonical.encode()).hexdigest()


def _expr_or_number(v: float | Expr) -> float | str:
    return v.to_source() if isinstance(v, Expr) else float(v)


def spec_fingerprint(spec: KernelSpec) -> dict:
    """JSON-able description of everything about a spec that shapes the
    built driver: any edit to the spec changes it, and so the key."""
    return {
        "name": spec.name,
        "data_params": list(spec.data_params),
        "program_params": list(spec.program_params),
        "grid": [[a.name, a.data, a.block, a.sequential, a.ragged]
                 for a in spec.grid],
        "operands": [[op.name, list(op.tile), list(op.deps), op.dtype_bytes,
                      op.is_output, op.staged, op.scratch]
                     for op in spec.operands],
        "flops_per_point": _expr_or_number(spec.flops_per_point),
        "threads": spec.threads.to_source(),
        "regs_per_thread": spec.regs_per_thread,
        "compute_unit": spec.compute_unit,
        "constraints": list(spec.constraints),
        "param_candidates": {k: list(v) for k, v in
                             sorted(spec.param_candidates.items())},
        "fit_vars": {k: list(v) for k, v in sorted(spec.fit_vars.items())},
        "source_fingerprint": spec.source_fingerprint,
    }


def fitter_digest() -> str:
    """SHA-256 of the fitter's source (``core/fitting.py``): the same probes
    fitted by an edited fitter may give other fits, and so other choices."""
    return hashlib.sha256(
        (Path(__file__).parent / "fitting.py").read_bytes()).hexdigest()


def code_digest(spec: KernelSpec) -> str:
    """The code a driver of ``spec`` serves: the spec's fingerprint and the
    hashes of the kernel library's sources and of the fitter as they are
    now."""
    return _sha({"spec": spec_fingerprint(spec),
                 "sources": kernel_sources_digest(),
                 "fitter": fitter_digest()})


def cache_key(spec: KernelSpec, hw: HardwareParams,
              hyper: Mapping[str, Any]) -> str:
    """Address of one driver build: its code digest, the hardware and the
    build settings (the oracle's fingerprint among them)."""
    return _sha({
        "version": _ENTRY_VERSION,
        "code": code_digest(spec),
        "hw": dataclasses.asdict(hw),
        "hyper": dict(sorted(hyper.items())),
    })


@dataclass
class CacheEntry:
    kernel: str
    key: str
    source: str                     # the generated driver module
    fits: dict                      # metric -> fitted function and its stats
    code: str                       # code_digest of the spec it was built for
    created_at: float
    hw_name: str
    # Tuning generation: ``lookup_latest`` prefers the highest; 0 is a plain
    # compile-time build.
    tuning_version: int = 0

    def content_hash(self) -> str:
        return _sha({"source": self.source, "fits": self.fits,
                     "code": self.code,
                     "tuning_version": self.tuning_version})


@dataclass
class PlanEntry:
    """One compiled launch plan (``LaunchPlanTable.to_json``)."""

    kernel: str
    key: str
    hw_name: str
    plan: dict                      # the LaunchPlanTable payload
    created_at: float
    tuning_version: int = 0

    @property
    def code(self) -> str:
        """The code digest of the driver the plan was compiled from."""
        return self.plan.get("code", "")

    def content_hash(self) -> str:
        return _sha({"plan": self.plan,
                     "tuning_version": self.tuning_version})


class DriverCache:
    """On-disk, content-addressed store of the port's generated drivers
    and their compiled launch plans."""

    def __init__(self, root: str | None = None):
        self.root = os.path.join(root or default_cache_dir(), PORT_DIR)

    def _kernel_dir(self, kernel: str) -> str:
        return os.path.join(self.root, kernel)

    def path(self, kernel: str, key: str) -> str:
        return os.path.join(self._kernel_dir(kernel), f"{key}.json")

    def plan_path(self, kernel: str, key: str) -> str:
        return os.path.join(self._kernel_dir(kernel), f"{key}.plan.json")

    # -- read ----------------------------------------------------------------
    def get(self, kernel: str, key: str) -> CacheEntry | None:
        """The entry of an exact build key, or None (missing or stale)."""
        return self._load(self.path(kernel, key), expect_key=key)

    def lookup_latest(self, kernel: str, hw_name: str | None = None,
                      code: str | None = None,
                      source_hash: str | None = None) -> CacheEntry | None:
        """The newest valid entry of a kernel (the read-through path, whose
        caller knows the kernel's name but not the build's settings): the
        highest ``tuning_version``, then the latest build.  With ``hw_name``
        only entries tuned for that card count: launch parameters that are
        best on one device are in general not on another.  With ``code``
        only entries of that ``code_digest`` count: a driver built for
        other kernel code may name tiles the kernel no longer takes.  With
        ``source_hash`` only entries of that driver module count (the
        ``DriverProgram.source_hash`` of one build)."""
        best: CacheEntry | None = None
        for entry in self._entries(kernel, hw_name, code):
            if source_hash not in (None, driver_source_hash(entry.source)):
                continue
            if best is None or (entry.tuning_version, entry.created_at) > \
                    (best.tuning_version, best.created_at):
                best = entry
        return best

    def _entries(self, kernel: str, hw_name: str | None = None,
                 code: str | None = None) -> list[CacheEntry]:
        try:
            names = sorted(os.listdir(self._kernel_dir(kernel)))
        except OSError:
            return []
        out = []
        for f in names:
            if not f.endswith(".json") or f.endswith(".plan.json"):
                continue
            entry = self._load(os.path.join(self._kernel_dir(kernel), f))
            if entry is not None and hw_name in (None, entry.hw_name) \
                    and code in (None, entry.code):
                out.append(entry)
        return out

    def _load(self, path: str,
              expect_key: str | None = None) -> CacheEntry | None:
        try:
            with open(path) as f:
                raw = json.load(f)
            entry = CacheEntry(
                kernel=raw["kernel"], key=raw["key"], source=raw["source"],
                fits=raw["fits"], code=raw["code"],
                created_at=raw.get("created_at", 0.0),
                hw_name=raw.get("hw_name", ""),
                tuning_version=int(raw.get("tuning_version", 0)))
        except (OSError, ValueError, KeyError, TypeError):
            return None
        # The stored payload must hash to its recorded content hash, and
        # the entry must live under the key it claims.
        if raw.get("version") != _ENTRY_VERSION or \
                raw.get("content_hash") != entry.content_hash() or \
                (expect_key is not None and entry.key != expect_key):
            try:
                os.remove(path)
            except OSError:
                pass
            return None
        return entry

    # -- compiled launch plans (core/plan.py) --------------------------------
    def get_plan(self, kernel: str, key: str) -> PlanEntry | None:
        """The plan of an exact plan key, or None (missing or stale)."""
        return self._load_plan(self.plan_path(kernel, key), expect_key=key)

    def lookup_latest_plan(self, kernel: str, hw_name: str | None = None,
                           code: str | None = None,
                           source_hash: str | None = None
                           ) -> PlanEntry | None:
        """The newest valid plan of a kernel, ordered as ``lookup_latest``
        orders drivers.  With ``code`` only plans compiled for that kernel
        code count, and with ``source_hash`` only plans of that driver."""
        best: PlanEntry | None = None
        for entry in self._plan_entries(kernel, hw_name):
            if code not in (None, entry.code) or source_hash not in (
                    None, entry.plan.get("source_hash", "")):
                continue
            if best is None or (entry.tuning_version, entry.created_at) > \
                    (best.tuning_version, best.created_at):
                best = entry
        return best

    def _plan_entries(self, kernel: str,
                      hw_name: str | None = None) -> list[PlanEntry]:
        try:
            names = sorted(os.listdir(self._kernel_dir(kernel)))
        except OSError:
            return []
        out = []
        for f in names:
            if not f.endswith(".plan.json"):
                continue
            entry = self._load_plan(os.path.join(self._kernel_dir(kernel), f))
            if entry is not None and hw_name in (None, entry.hw_name):
                out.append(entry)
        return out

    def _load_plan(self, path: str,
                   expect_key: str | None = None) -> PlanEntry | None:
        try:
            with open(path) as f:
                raw = json.load(f)
            entry = PlanEntry(
                kernel=raw["kernel"], key=raw["key"],
                hw_name=raw.get("hw_name", ""), plan=raw["plan"],
                created_at=raw.get("created_at", 0.0),
                tuning_version=int(raw.get("tuning_version", 0)))
        except (OSError, ValueError, KeyError, TypeError):
            return None
        # The same rule as ``_load``: a tampered or misplaced plan is
        # deleted and read as a miss.
        if raw.get("version") != _ENTRY_VERSION or \
                raw.get("content_hash") != entry.content_hash() or \
                (expect_key is not None and entry.key != expect_key):
            try:
                os.remove(path)
            except OSError:
                pass
            return None
        return entry

    def put_plan(self, entry: PlanEntry) -> str:
        """Write a plan atomically; returns its path."""
        os.makedirs(self._kernel_dir(entry.kernel), exist_ok=True)
        path = self.plan_path(entry.kernel, entry.key)
        _write_json_atomic(path, {
            "version": _ENTRY_VERSION,
            "kernel": entry.kernel,
            "key": entry.key,
            "hw_name": entry.hw_name,
            "plan": entry.plan,
            "created_at": entry.created_at or time.time(),
            "tuning_version": entry.tuning_version,
            "content_hash": entry.content_hash(),
        })
        return path

    # -- write ---------------------------------------------------------------
    def put(self, entry: CacheEntry) -> str:
        """Write ``entry`` atomically; returns its path."""
        os.makedirs(self._kernel_dir(entry.kernel), exist_ok=True)
        path = self.path(entry.kernel, entry.key)
        _write_json_atomic(path, {
            "version": _ENTRY_VERSION,
            "kernel": entry.kernel,
            "key": entry.key,
            "source": entry.source,
            "fits": entry.fits,
            "code": entry.code,
            "created_at": entry.created_at or time.time(),
            "hw_name": entry.hw_name,
            "tuning_version": entry.tuning_version,
            "content_hash": entry.content_hash(),
        })
        return path

    # -- maintenance ---------------------------------------------------------
    def invalidate(self, kernel: str, hw_name: str | None = None,
                   below_version: int | None = None) -> int:
        """Delete a kernel's drivers and plans (those of ``hw_name`` only,
        when given; with ``below_version``, only older generations): a
        plan goes with the fit generation it was compiled from.  Returns
        how many went."""
        removed = 0
        doomed = [(self.path(kernel, e.key), e.tuning_version)
                  for e in self._entries(kernel, hw_name)] + \
            [(self.plan_path(kernel, e.key), e.tuning_version)
             for e in self._plan_entries(kernel, hw_name)]
        for path, version in doomed:
            if below_version is not None and version >= below_version:
                continue
            try:
                os.remove(path)
                removed += 1
            except OSError:
                pass            # another process removed it first
        return removed

    def kernels(self) -> list[str]:
        """The kernels with a directory in the port's cache."""
        if not os.path.isdir(self.root):
            return []
        return sorted(k for k in os.listdir(self.root)
                      if os.path.isdir(self._kernel_dir(k)))

    def clear(self) -> None:
        """Delete every entry of the port's cache (the JAX package's, under
        the same root, stay)."""
        for kernel in self.kernels():
            d = self._kernel_dir(kernel)
            for f in os.listdir(d):
                try:
                    os.remove(os.path.join(d, f))
                except OSError:
                    pass
            try:
                os.rmdir(d)
            except OSError:
                pass


def default_cache() -> DriverCache:
    """The cache at the default root, read anew from
    ``$KLARAPTOR_CACHE_DIR`` on every call."""
    return DriverCache()
