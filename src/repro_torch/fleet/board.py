"""The spool job board: durable, lease-based work distribution on a directory.

Layout (all under one spool root, shared by coordinator and workers --
processes on one host or hosts on a shared filesystem):

    jobs/<key>.json              pending work (a ProbeJob document)
    claimed/<key>.<worker>.json  leased work; file *mtime* is the lease
                                 heartbeat (workers os.utime while alive)
    results/<key>.json           completed work (first writer wins)
    results/<key>.<worker>.dropped  one empty marker per duplicate result
                                 dropped (the port's count of them)
    failed/<key>.json            permanently failed work (+ error history)
    stop                         sentinel: workers drain and exit

Claiming is a single atomic ``os.rename`` from jobs/ into claimed/ --
exactly one claimant can win, with no locks and no coordinator round-trip.
Every other transition is likewise one atomic rename or replace, so a
worker or coordinator killed at any instant leaves only whole files: the
board is its own crash-recovery log.  Job keys are content hashes
(``fleet.jobs.job_key``), so resubmitting identical work dedups against
every lifecycle stage, a reassigned lease re-executes the same job (to the
same bytes under a seeded oracle), and a duplicate result is dropped --
counted, never merged twice.  Stdlib only; the layout and JSON are the
reference's, plus the ``.dropped`` markers that count the duplicates.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

from .jobs import ProbeJob

__all__ = ["JobBoard"]

_STAGES = ("jobs", "claimed", "results", "failed")


def _write_json_atomic(path: str, doc: dict) -> None:
    d = os.path.dirname(path)
    fd, tmp = tempfile.mkstemp(prefix=".tmp.", dir=d)
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f)
            f.flush()
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def _read_json(path: str) -> dict | None:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None             # vanished under us / torn: caller skips


class JobBoard:
    """One spool directory's worth of farm state (see module docstring)."""

    def __init__(self, root, max_attempts: int = 3):
        self.root = str(root)
        self.max_attempts = int(max_attempts)
        for stage in _STAGES:
            os.makedirs(os.path.join(self.root, stage), exist_ok=True)

    # -- paths ---------------------------------------------------------------
    def _dir(self, stage: str) -> str:
        return os.path.join(self.root, stage)

    def job_path(self, key: str) -> str:
        return os.path.join(self._dir("jobs"), f"{key}.json")

    def claim_path(self, key: str, worker: str) -> str:
        return os.path.join(self._dir("claimed"), f"{key}.{worker}.json")

    def result_path(self, key: str) -> str:
        return os.path.join(self._dir("results"), f"{key}.json")

    def failed_path(self, key: str) -> str:
        return os.path.join(self._dir("failed"), f"{key}.json")

    @property
    def stop_path(self) -> str:
        return os.path.join(self.root, "stop")

    # -- lifecycle -----------------------------------------------------------
    def submit(self, job: ProbeJob) -> str:
        """Enqueue a job; dedups against every stage.  Returns the stage the
        key is now in ("jobs", "claimed", "results", "failed")."""
        if os.path.exists(self.result_path(job.key)):
            return "results"
        if os.path.exists(self.failed_path(job.key)):
            return "failed"
        if self.claims_for(job.key):
            return "claimed"
        path = self.job_path(job.key)
        if not os.path.exists(path):
            _write_json_atomic(path, {**job.to_json(), "attempts": 0})
        return "jobs"

    def claim(self, worker: str) -> dict | None:
        """Atomically take one pending job; None when nothing is pending.

        Scans in sorted order so claim order is deterministic given board
        contents; the rename is the mutual exclusion -- losing a race just
        moves on to the next candidate.
        """
        jobs_dir = self._dir("jobs")
        try:
            names = sorted(os.listdir(jobs_dir))
        except OSError:
            return None
        for name in names:
            if not name.endswith(".json"):
                continue
            key = name[:-len(".json")]
            if os.path.exists(self.result_path(key)):
                # Stale duplicate (speculation that already resolved):
                # drop it rather than hand out finished work.
                try:
                    os.remove(os.path.join(jobs_dir, name))
                except OSError:
                    pass
                continue
            dst = self.claim_path(key, worker)
            try:
                os.rename(os.path.join(jobs_dir, name), dst)
            except OSError:
                continue        # lost the race; next candidate
            try:
                # rename preserved the *submit* mtime; the lease clock
                # starts now, or queued-but-unclaimed time counts against it
                os.utime(dst)
            except OSError:
                pass
            doc = _read_json(dst)
            if doc is None:
                continue
            return doc

    def heartbeat(self, key: str, worker: str) -> bool:
        """Refresh the lease mtime; False when the lease is gone (the job
        was reassigned -- the worker should abandon or finish knowing its
        result may be dropped as a duplicate)."""
        try:
            os.utime(self.claim_path(key, worker))
            return True
        except OSError:
            return False

    def complete(self, key: str, worker: str, result: dict) -> bool:
        """Record a result; first writer wins.  Returns False when a result
        for the key already existed (duplicate execution -- dropped)."""
        path = self.result_path(key)
        duplicate = os.path.exists(path)
        if not duplicate:
            _write_json_atomic(path, {"key": key, "worker": worker,
                                      **result})
        else:
            open(os.path.join(self._dir("results"),
                              f"{key}.{worker}.dropped"), "a").close()
        try:
            os.remove(self.claim_path(key, worker))
        except OSError:
            pass
        return not duplicate

    def fail(self, key: str, worker: str, error: str) -> str:
        """Record a job failure; requeue until ``max_attempts`` is reached,
        then park it in failed/.  Returns "jobs" or "failed"."""
        doc = _read_json(self.claim_path(key, worker))
        try:
            os.remove(self.claim_path(key, worker))
        except OSError:
            pass
        if doc is None:
            doc = _read_json(self.failed_path(key)) or {"key": key,
                                                        "attempts": 0}
        doc["attempts"] = int(doc.get("attempts", 0)) + 1
        doc.setdefault("errors", []).append({"worker": worker,
                                             "error": error})
        if doc["attempts"] >= self.max_attempts:
            _write_json_atomic(self.failed_path(key), doc)
            return "failed"
        _write_json_atomic(self.job_path(key), doc)
        return "jobs"

    # -- lease management (coordinator side) ---------------------------------
    def claims(self) -> list[tuple[str, str, float]]:
        """All live leases as (key, worker, mtime)."""
        out = []
        d = self._dir("claimed")
        for name in sorted(os.listdir(d)):
            if not name.endswith(".json"):
                continue
            stem = name[:-len(".json")]
            key, _, worker = stem.partition(".")
            try:
                mtime = os.stat(os.path.join(d, name)).st_mtime
            except OSError:
                continue        # completed under us
            out.append((key, worker, mtime))
        return out

    def claims_for(self, key: str) -> list[str]:
        return [w for k, w, _ in self.claims() if k == key]

    def _requeue(self, key: str, worker: str, reason: str) -> str | None:
        """Move one lease back to pending (or failed/ past max_attempts)."""
        src = self.claim_path(key, worker)
        doc = _read_json(src)
        if doc is None:
            return None         # completed or already requeued: nothing to do
        try:
            os.remove(src)
        except OSError:
            return None         # lost the race with complete()/fail()
        if os.path.exists(self.result_path(key)):
            return None         # finished while we were deciding
        doc["attempts"] = int(doc.get("attempts", 0)) + 1
        doc.setdefault("errors", []).append({"worker": worker,
                                             "error": reason})
        if doc["attempts"] >= self.max_attempts:
            _write_json_atomic(self.failed_path(key), doc)
            return "failed"
        _write_json_atomic(self.job_path(key), doc)
        return "jobs"

    def requeue_stale(self, lease_s: float, now: float | None = None
                      ) -> list[str]:
        """Expire leases whose heartbeat is older than ``lease_s``."""
        now = time.time() if now is None else now
        requeued = []
        for key, worker, mtime in self.claims():
            if now - mtime > lease_s:
                if self._requeue(key, worker, f"lease expired "
                                 f"({now - mtime:.2f}s > {lease_s}s)"):
                    requeued.append(key)
        return requeued

    def requeue_worker(self, worker: str, reason: str = "worker lost"
                       ) -> list[str]:
        """Reassign every lease held by one (dead/hung) worker."""
        requeued = []
        for key, w, _ in self.claims():
            if w == worker and self._requeue(key, worker, reason):
                requeued.append(key)
        return requeued

    def speculate(self, key: str) -> bool:
        """Duplicate a leased job back into jobs/ (straggler mitigation).

        The original lease keeps running; whichever execution completes
        first wins the result file and the other is dropped as a
        duplicate.  Safe because jobs are idempotent by construction.
        """
        for k, worker, _ in self.claims():
            if k != key:
                continue
            doc = _read_json(self.claim_path(key, worker))
            if doc is None or os.path.exists(self.result_path(key)) or \
                    os.path.exists(self.job_path(key)):
                return False
            _write_json_atomic(self.job_path(key), doc)
            return True
        return False

    # -- queries -------------------------------------------------------------
    def result(self, key: str) -> dict | None:
        return _read_json(self.result_path(key))

    def failure(self, key: str) -> dict | None:
        return _read_json(self.failed_path(key))

    def dropped(self) -> list[tuple[str, str]]:
        """Every duplicate result dropped so far, as (key, worker)."""
        out = []
        for name in sorted(os.listdir(self._dir("results"))):
            if name.endswith(".dropped"):
                key, _, worker = name[:-len(".dropped")].partition(".")
                out.append((key, worker))
        return out

    def counts(self) -> dict:
        out = {}
        for stage in _STAGES:
            try:
                out[stage] = sum(
                    1 for n in os.listdir(self._dir(stage))
                    if n.endswith(".json"))
            except OSError:
                out[stage] = 0
        return out

    # -- worker stop sentinel ------------------------------------------------
    def request_stop(self) -> None:
        _write_json_atomic(self.stop_path, {"t": time.time()})

    def clear_stop(self) -> None:
        try:
            os.remove(self.stop_path)
        except OSError:
            pass

    def stop_requested(self) -> bool:
        return os.path.exists(self.stop_path)
