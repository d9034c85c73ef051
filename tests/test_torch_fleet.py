"""The port's tuning farm held against the JAX package's.

``repro_torch.fleet`` is the reference's ``repro.fleet`` with the oracle
swapped: ``HopperModel`` (the analytic H100) where the reference has its
TPU simulator, and the card's ``CudaEventTimer`` by value.  The
reference's ``tests/test_fleet.py`` runs here by name (38 tests, its two
process-backend tests with spawned workers and not marked slow), with
the byte gates of ``TestFarmDeterminism`` extended to every mode under
each injected fault.  Then the two packages go through the same inputs:
a ledger written by the reference's telemetry loop ingested by both
``RetuneQueue``s (and the port reading the reference's state file), both
``JobBoard``s through one scripted sequence.  Last, one test per
divergence the card forces (ROADMAP Queue C, "Divergences"):

  H1  process workers are spawned, never forked;
  H2  timed probes on one card take turns (a card lock, here held by
      ``WallClockSim`` as ``CudaEventTimer`` holds the card's);
  H3  the card is an oracle by value, not bit-identically: the farm keeps
      the single-process rows and cache key, and a job -- and, before any
      worker starts, the coordinator -- refuses another card model;
  H4  heartbeats: workers warm the oracle before their first claim (one
      whose warm-up fails fails its jobs instead of crashing), a waiter on
      the card lock keeps beating, results record the longest beat gap;
  H5  a thread worker's retune hot-swap lands in the coordinator's own
      registry (a process worker's is discarded);
  and the payloads carry no ``max_stages``.

Seeds: the oracle ``HopperModel(H100, noise=0.04, seed=7)``, collect seed
3, 6 configs per size, 2 repeats, the first two default probe sizes.  The
gates compare bytes (no tolerance).
"""

import glob
import inspect
import json
import multiprocessing
import os
import threading
import time

import numpy as np
import pytest

import repro.fleet as ref_fleet
from repro.core import V5eSimulator
from repro.core import matmul_spec as ref_matmul_spec
from repro.core.collect import collect as ref_collect
from repro.core.driver import ChoiceEvent as RefChoiceEvent
from repro.core.driver import registry as ref_registry
from repro.search import SearchBudget as RefSearchBudget
from repro.telemetry import Telemetry as RefTelemetry
from repro.telemetry import TelemetryConfig as RefTelemetryConfig

from repro_torch.core import H100, HopperModel
from repro_torch.core.cache import DriverCache
from repro_torch.core.card_lock import (LOG_ENV, CardLock, largest_overlap,
                                        read_intervals)
from repro_torch.core.collect import collect, default_probe_data
from repro_torch.core.tuner import Klaraptor
from repro_torch.fleet import (FaultPlan, FleetConfig, FleetCoordinator,
                               JobBoard, RetuneQueue, SpecRef, WallClockSim,
                               collected_equal, collected_rows_equal,
                               device_from_json, device_to_json,
                               execute_job, hw_by_name, job_key, make_job,
                               tier1_spec_refs)
from repro_torch.fleet.queue import drift_key

SEED = 3
N_CFG = 6


def _pd(spec, n=2):
    return default_probe_data(spec)[:n]


def _device(noise=0.04):
    return HopperModel(H100, noise=noise, seed=7)


def _artifacts(cache_root):
    return sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(cache_root, "**", "*.json"), recursive=True))


def _drift_line(**over):
    d = {"type": "drift", "kernel": "matmul_b16", "hw": "h100_sxm_cc90",
         "bucket": "m=1024|k=512|n=512",
         "D": {"m": 1024, "k": 512, "n": 512},
         "config": {"bm": 128, "bn": 256, "bk": 64},
         "rel_error_ewma": 0.4, "n_samples": 9,
         "predicted_s": 1e-3, "observed_s": 1.4e-3}
    d.update(over)
    return d


class TestJobsAndKeys:
    def test_job_key_canonical(self):
        a = job_key("batch", {"x": 1, "y": [2, 3]})
        b = job_key("batch", {"y": [2, 3], "x": 1})
        assert a == b and len(a) == 64
        assert job_key("batch", {"x": 2, "y": [2, 3]}) != a
        assert job_key("kernel", {"x": 1, "y": [2, 3]}) != a

    def test_make_job_normalizes_payload(self):
        j1 = make_job("batch", {"D": {"m": np.int64(256)}})
        j2 = make_job("batch", {"D": {"m": 256}})
        assert j1.key == j2.key

    def test_spec_ref_roundtrip(self):
        refs = tier1_spec_refs()
        assert sorted(refs) == ["flash_attn_d128_causal", "matmul_b16",
                                "moe_gmm_b16", "ssd_scan_h64_n128"]
        for name, ref in refs.items():
            back = SpecRef.from_json(ref.to_json())
            assert back.build().name == ref.build().name == name

    def test_device_roundtrip_same_fingerprint(self):
        dev = _device()
        back = device_from_json(device_to_json(dev))
        assert back.fingerprint() == dev.fingerprint()

    def test_wallclock_sim_transparent(self):
        inner = _device()
        wc = WallClockSim(inner, scale=0.0)
        # identical cache identity and identical probe bytes
        assert wc.fingerprint() == inner.fingerprint()
        spec = tier1_spec_refs()["matmul_b16"].build()
        D = _pd(spec)[0]
        table = spec.candidates(D, H100)
        tt = spec.traffic_table(D, table, H100)
        idx = np.arange(min(4, len(table)))
        reps = np.full(idx.shape, 2, dtype=np.int64)
        p1 = inner.probe_rows(tt.select(idx), np.random.RandomState(0), reps)
        p2 = wc.probe_rows(tt.select(idx), np.random.RandomState(0), reps)
        np.testing.assert_array_equal(p1.total_time_s, p2.total_time_s)

    def test_wallclock_sim_beats_while_sleeping(self):
        beats = []
        wc = WallClockSim(_device(), scale=0.5, beat=lambda: beats.append(1),
                          slice_s=0.01)
        wc._sleep(0.05)
        assert len(beats) >= 4


class TestJobBoard:
    def _job(self, n=0):
        return make_job("batch", {"n": n})

    def test_claim_is_exclusive(self, tmp_path):
        board = JobBoard(tmp_path / "spool")
        job = self._job()
        assert board.submit(job) == "jobs"
        doc = board.claim("w0")
        assert doc is not None and doc["key"] == job.key
        assert board.claim("w1") is None

    def test_submit_dedups_against_every_stage(self, tmp_path):
        board = JobBoard(tmp_path / "spool")
        job = self._job()
        board.submit(job)
        assert board.submit(job) == "jobs"
        board.claim("w0")
        assert board.submit(job) == "claimed"
        board.complete(job.key, "w0", {"ok": True})
        assert board.submit(job) == "results"
        assert board.counts() == {"jobs": 0, "claimed": 0, "results": 1,
                                  "failed": 0}

    def test_duplicate_result_dropped_not_merged(self, tmp_path):
        board = JobBoard(tmp_path / "spool")
        job = self._job()
        board.submit(job)
        board.claim("w0")
        assert board.complete(job.key, "w0", {"v": "first"}) is True
        assert board.complete(job.key, "w1", {"v": "second"}) is False
        assert board.result(job.key)["v"] == "first"
        # the port counts what it dropped
        assert board.dropped() == [(job.key, "w1")]
        assert board.counts()["results"] == 1

    def test_fail_requeues_then_parks(self, tmp_path):
        board = JobBoard(tmp_path / "spool", max_attempts=2)
        job = self._job()
        board.submit(job)
        board.claim("w0")
        assert board.fail(job.key, "w0", "boom1") == "jobs"
        board.claim("w1")
        assert board.fail(job.key, "w1", "boom2") == "failed"
        doc = board.failure(job.key)
        assert doc["attempts"] == 2
        assert [e["error"] for e in doc["errors"]] == ["boom1", "boom2"]

    def test_requeue_stale_expires_only_old_leases(self, tmp_path):
        board = JobBoard(tmp_path / "spool")
        j1, j2 = self._job(1), self._job(2)
        board.submit(j1), board.submit(j2)
        board.claim("w0")
        time.sleep(0.15)
        board.claim("w1")           # fresh lease
        now = time.time()
        expired = board.requeue_stale(lease_s=0.1, now=now)
        assert expired == [min(j1.key, j2.key)] or len(expired) == 1
        # the expired one is claimable again; the fresh one is not touched
        assert board.counts()["jobs"] == 1
        assert board.counts()["claimed"] == 1

    def test_requeue_worker_reassigns_all_its_leases(self, tmp_path):
        board = JobBoard(tmp_path / "spool")
        jobs = [self._job(i) for i in range(3)]
        for j in jobs:
            board.submit(j)
        board.claim("dead"), board.claim("dead"), board.claim("alive")
        requeued = board.requeue_worker("dead", "killed in test")
        assert len(requeued) == 2
        assert board.counts() == {"jobs": 2, "claimed": 1, "results": 0,
                                  "failed": 0}

    def test_requeue_never_resurrects_completed_work(self, tmp_path):
        board = JobBoard(tmp_path / "spool")
        job = self._job()
        board.submit(job)
        board.claim("w0")
        board.complete(job.key, "w0", {"ok": True})
        assert board.requeue_worker("w0") == []
        assert board.counts()["jobs"] == 0

    def test_speculate_duplicates_lease_first_writer_wins(self, tmp_path):
        board = JobBoard(tmp_path / "spool")
        job = self._job()
        board.submit(job)
        board.claim("slow")
        assert board.speculate(job.key) is True
        assert board.speculate(job.key) is False    # already duplicated
        dup = board.claim("fast")
        assert dup["key"] == job.key                # both now hold it
        assert board.complete(job.key, "fast", {"by": "fast"}) is True
        assert board.complete(job.key, "slow", {"by": "slow"}) is False
        assert board.result(job.key)["by"] == "fast"

    def test_claim_drops_stale_duplicate_of_finished_job(self, tmp_path):
        board = JobBoard(tmp_path / "spool")
        job = self._job()
        board.submit(job)
        board.claim("slow")
        board.speculate(job.key)
        board.complete(job.key, "slow", {"ok": True})
        # the speculative copy must not be handed out after the result
        assert board.claim("fast") is None
        assert board.counts()["jobs"] == 0

    def test_stop_sentinel(self, tmp_path):
        board = JobBoard(tmp_path / "spool")
        assert not board.stop_requested()
        board.request_stop()
        assert board.stop_requested()
        board.clear_stop()
        assert not board.stop_requested()


def _single(cache_dir, name, device=None, **kw):
    ref = tier1_spec_refs()[name]
    spec = ref.build()
    kl = Klaraptor(device or _device(), hw=H100,
                   cache=DriverCache(str(cache_dir)))
    return kl.build_driver(spec, probe_data=_pd(spec),
                           max_configs_per_size=N_CFG, seed=SEED,
                           repeats=2, **kw)


class TestFarmDeterminism:
    """The acceptance gate: farm output == single-process output, bytes."""

    def _single(self, cache_dir, name, **kw):
        return _single(cache_dir, name, **kw)

    def _assert_parity(self, sp, fb, spec):
        assert collected_equal(sp.collected, fb.collected) == []
        D = default_probe_data(spec)[-1]
        assert sp.driver.choose(D) == fb.driver.choose(D)

    def test_all_tier1_under_faults_bit_identical(self, tmp_path):
        """4 workers; one vanishes on its first job, one hangs past its
        lease (-> reassignment + a duplicate completion when it wakes).
        All four tier-1 kernels, one farm run, every byte identical."""
        refs = tier1_spec_refs()
        singles = {n: self._single(tmp_path / "c1", n) for n in refs}
        pd = {n: _pd(r.build()) for n, r in refs.items()}
        faults = {0: FaultPlan(vanish_at_job=1),
                  1: FaultPlan(hang_at_job=1, hang_s=1.5)}
        with FleetCoordinator(
                tmp_path / "spool", _device(), hw=H100,
                cache=DriverCache(str(tmp_path / "c2")),
                config=FleetConfig(n_workers=4, lease_s=0.4,
                                   job_timeout_s=120),
                worker_faults=faults) as fc:
            out = fc.tune(refs, probe_data=pd, repeats=2,
                          max_configs_per_size=N_CFG, seed=SEED)
            stats = fc.stats
        for name, ref in refs.items():
            self._assert_parity(singles[name], out[name], ref.build())
        assert _artifacts(tmp_path / "c1") == _artifacts(tmp_path / "c2")
        # the faults actually happened and were recovered from
        assert stats.worker_deaths >= 1      # the vanished worker
        assert stats.requeues >= 1           # the hung worker's lease
        assert stats.respawns >= 1

    def test_kernel_mode_cross_size_strategy(self, tmp_path):
        name = "matmul_b16"
        sp = self._single(tmp_path / "c1", name,
                          strategy="successive_halving")
        ref = tier1_spec_refs()[name]
        with FleetCoordinator(
                tmp_path / "spool", _device(), hw=H100,
                cache=DriverCache(str(tmp_path / "c2")),
                config=FleetConfig(n_workers=2)) as fc:
            fb = fc.tune({name: ref}, probe_data=_pd(ref.build()),
                         repeats=2, max_configs_per_size=N_CFG, seed=SEED,
                         strategy="successive_halving")[name]
            assert fc.stats.by_kind == {"kernel": 1}
        self._assert_parity(sp, fb, ref.build())
        assert _artifacts(tmp_path / "c1") == _artifacts(tmp_path / "c2")

    def test_batch_mode_refuses_cross_size_strategy(self, tmp_path):
        ref = tier1_spec_refs()["matmul_b16"]
        with FleetCoordinator(tmp_path / "spool", _device(),
                              config=FleetConfig(n_workers=0)) as fc:
            with pytest.raises(ValueError, match="cross-size state"):
                fc.tune({"matmul_b16": ref}, mode="batch",
                        strategy="successive_halving")

    def test_rows_mode_finest_grain(self, tmp_path):
        name = "matmul_b16"
        sp = self._single(tmp_path / "c1", name, shard_rows=4)
        ref = tier1_spec_refs()[name]
        with FleetCoordinator(
                tmp_path / "spool", _device(), hw=H100,
                cache=DriverCache(str(tmp_path / "c2")),
                config=FleetConfig(n_workers=3)) as fc:
            fb = fc.tune({name: ref}, probe_data=_pd(ref.build()),
                         repeats=2, max_configs_per_size=N_CFG, seed=SEED,
                         shard_rows=4, mode="rows")[name]
            assert set(fc.stats.by_kind) == {"rows"}
            assert fc.stats.by_kind["rows"] >= 2
        self._assert_parity(sp, fb, ref.build())
        assert _artifacts(tmp_path / "c1") == _artifacts(tmp_path / "c2")

    def test_killed_process_worker_recovered(self, tmp_path):
        """A real os._exit mid-job (process backend, spawned): the lease
        expires, the job is reassigned, and the merge stays bit-identical."""
        name = "matmul_b16"
        sp = self._single(tmp_path / "c1", name)
        ref = tier1_spec_refs()[name]
        # One worker: it *must* claim the first job and die holding the
        # lease; the respawned replacement finishes everything.
        with FleetCoordinator(
                tmp_path / "spool", _device(), hw=H100,
                cache=DriverCache(str(tmp_path / "c2")),
                config=FleetConfig(n_workers=1, backend="process",
                                   lease_s=0.5, job_timeout_s=120),
                worker_faults={0: FaultPlan(kill_at_job=1)}) as fc:
            fb = fc.tune({name: ref}, probe_data=_pd(ref.build()),
                         repeats=2, max_configs_per_size=N_CFG,
                         seed=SEED)[name]
            assert fc.stats.worker_deaths >= 1
        self._assert_parity(sp, fb, ref.build())

    def test_duplicate_execution_is_bit_identical(self):
        """The idempotence the whole design leans on: the same job
        document executes to the same bytes anywhere, any time."""
        ref = tier1_spec_refs()["matmul_b16"]
        spec = ref.build()
        job = make_job("batch", {
            "spec": ref.to_json(), "device": device_to_json(_device()),
            "hw": "h100_sxm_cc90", "seed": SEED, "repeats": 2,
            "max_configs_per_size": N_CFG, "strategy": None,
            "shard_rows": None,
            "D": {k: int(v) for k, v in _pd(spec)[0].items()},
            "batch_index": 0, "budget": {"max_executions": 12,
                                         "max_device_seconds": None}})
        r1 = execute_job(job.to_json())
        r2 = execute_job(job.to_json())
        assert json.dumps(r1, sort_keys=True) == \
            json.dumps(r2, sort_keys=True)


_MODE_KW = {"batch": {}, "auto": {}, "kernel": {},
            "rows": {"shard_rows": 4}}
_FAULTS = {"vanish": FaultPlan(vanish_at_job=1),
           "hang": FaultPlan(hang_at_job=1, hang_s=1.0)}


@pytest.mark.parametrize("fault", sorted(_FAULTS))
@pytest.mark.parametrize("mode", sorted(_MODE_KW))
def test_every_mode_bit_identical_under_fault(tmp_path, mode, fault):
    """TestFarmDeterminism's gate in each of the four modes under a
    vanish and a hang on every first-generation worker (thread backend):
    the merged bytes, the choice and the cache artifact are the
    single-process build's, and the fault was recovered from."""
    name = "matmul_b16"
    kw = _MODE_KW[mode]
    sp = _single(tmp_path / "c1", name, **kw)
    ref = tier1_spec_refs()[name]
    with FleetCoordinator(
            tmp_path / "spool", _device(), hw=H100,
            cache=DriverCache(str(tmp_path / "c2")),
            config=FleetConfig(n_workers=2, lease_s=0.4, job_timeout_s=120),
            worker_faults={0: _FAULTS[fault], 1: _FAULTS[fault]}) as fc:
        fb = fc.tune({name: ref}, probe_data=_pd(ref.build()), repeats=2,
                     max_configs_per_size=N_CFG, seed=SEED, mode=mode,
                     **kw)[name]
        stats = fc.stats
    assert collected_equal(sp.collected, fb.collected) == []
    D = default_probe_data(ref.build())[-1]
    assert sp.driver.choose(D) == fb.driver.choose(D)
    assert _artifacts(tmp_path / "c1") == _artifacts(tmp_path / "c2")
    assert stats.worker_deaths + stats.requeues >= 1
    expected = "kernel" if mode == "kernel" else \
        "rows" if mode == "rows" else "batch"
    assert set(stats.by_kind) == {expected}


@pytest.mark.parametrize("mode", ["batch", "kernel", "rows"])
def test_every_mode_bit_identical_after_a_kill(tmp_path, mode):
    """A spawned process worker that dies holding its first lease, in the
    batch, kernel and rows modes: recovered, and the bytes unchanged."""
    name = "matmul_b16"
    kw = _MODE_KW[mode]
    sp = _single(tmp_path / "c1", name, **kw)
    ref = tier1_spec_refs()[name]
    with FleetCoordinator(
            tmp_path / "spool", _device(), hw=H100,
            cache=DriverCache(str(tmp_path / "c2")),
            config=FleetConfig(n_workers=1, backend="process", lease_s=0.5,
                               job_timeout_s=120),
            worker_faults={0: FaultPlan(kill_at_job=1)}) as fc:
        fb = fc.tune({name: ref}, probe_data=_pd(ref.build()), repeats=2,
                     max_configs_per_size=N_CFG, seed=SEED, mode=mode,
                     **kw)[name]
        assert fc.stats.worker_deaths >= 1 and fc.stats.respawns >= 1
    assert collected_equal(sp.collected, fb.collected) == []
    assert _artifacts(tmp_path / "c1") == _artifacts(tmp_path / "c2")


class TestRetuneQueue:
    def test_ingest_dedup_and_corrupt_counting(self, tmp_path):
        ledger = tmp_path / "flight.jsonl"
        lines = [json.dumps({"type": "choice", "kernel": "matmul_b16"}),
                 json.dumps(_drift_line()),
                 "{not json",
                 json.dumps(_drift_line(rel_error_ewma=0.6)),
                 json.dumps(_drift_line(kernel="moe_gmm_b16"))]
        ledger.write_text("\n".join(lines) + "\n")
        q = RetuneQueue(tmp_path / "state.json")
        assert q.ingest(ledger) == 2        # two distinct keys
        s = q.summary()
        assert s["pending"] == 2 and s["corrupt_lines"] == 1
        pend = dict(q.pending())
        key = drift_key(_drift_line())
        assert pend[key]["rel_error_ewma"] == 0.6   # freshest event wins
        assert q.state["pending"][key]["n_seen"] == 2

    def test_offsets_only_advance_past_complete_lines(self, tmp_path):
        ledger = tmp_path / "flight.jsonl"
        q = RetuneQueue(tmp_path / "state.json")
        with open(ledger, "w") as f:
            f.write(json.dumps(_drift_line()) + "\n")
            f.write('{"type": "drift", "kernel": "moe')   # torn mid-write
        assert q.ingest(ledger) == 1
        with open(ledger, "a") as f:        # the serving node finishes it
            f.write('_gmm_b16", "hw": "h100_sxm_cc90", "bucket": "g=512"}\n')
        assert q.ingest(ledger) == 1        # whole line seen exactly once
        assert q.summary()["pending"] == 2
        assert q.summary()["corrupt_lines"] == 0

    def test_state_survives_restart(self, tmp_path):
        ledger = tmp_path / "flight.jsonl"
        ledger.write_text(json.dumps(_drift_line()) + "\n")
        q = RetuneQueue(tmp_path / "state.json")
        q.ingest(ledger)
        q2 = RetuneQueue(tmp_path / "state.json")   # restart
        assert q2.summary()["pending"] == 1
        assert q2.ingest(ledger) == 0               # offset persisted

    def test_done_keys_count_re_drifts_not_requeue(self, tmp_path):
        ledger = tmp_path / "flight.jsonl"
        ledger.write_text(json.dumps(_drift_line()) + "\n")
        q = RetuneQueue(tmp_path / "state.json")
        q.ingest(ledger)
        key = q.pending()[0][0]
        q.mark_done(key, {"succeeded": True})
        with open(ledger, "a") as f:
            f.write(json.dumps(_drift_line()) + "\n")
        assert q.ingest(ledger) == 0
        assert q.summary()["re_drifts"] == 1
        assert q.summary()["pending"] == 0

    def test_unreadable_state_starts_fresh(self, tmp_path):
        state = tmp_path / "state.json"
        state.write_text("{torn")
        q = RetuneQueue(state)
        assert q.summary()["pending"] == 0

    def test_priority_drain_is_traffic_weighted(self, tmp_path):
        """Drain order is drift magnitude x (1 + ledger traffic): a hot
        mildly-drifted key outranks a cold badly-drifted one."""
        ledger = tmp_path / "flight.jsonl"
        # real ledger drift lines carry bucket_label(shape_bucket(D))
        mild = _drift_line(rel_error_ewma=0.2, bucket="k9,m10,n9")
        bad = _drift_line(kernel="moe_gmm_b16", rel_error_ewma=0.5,
                          bucket="k9,m10,n9")
        ledger.write_text(json.dumps(mild) + "\n" + json.dumps(bad) + "\n")
        q = RetuneQueue(tmp_path / "state.json")
        q.ingest(ledger)
        # no traffic yet: pure magnitude, the worse fit first
        assert q.pending()[0][0] == drift_key(bad)
        # choice lines carry raw D; the tally must bucket it to the same
        # key the drift events use (bucket_label(shape_bucket(D)))
        with open(ledger, "a") as f:
            f.write(json.dumps({"type": "choice", "kernel": "matmul_b16",
                                "hw": "h100_sxm_cc90", "D": mild["D"],
                                "n_coalesced": 10}) + "\n")
        assert q.ingest(ledger) == 0        # traffic enqueues nothing
        assert q.state["traffic"][drift_key(mild)] == 10
        assert q.priority(drift_key(mild)) == pytest.approx(0.2 * 11)
        assert q.priority(drift_key(bad)) == pytest.approx(0.5)
        assert q.pending()[0][0] == drift_key(mild)     # hot path first

    def test_choice_with_explicit_bucket_and_bare_lines(self, tmp_path):
        ledger = tmp_path / "flight.jsonl"
        lines = [{"type": "choice", "kernel": "k", "hw": "h",
                  "bucket": "m=64"},
                 {"type": "choice", "kernel": "k", "hw": "h",
                  "bucket": "m=64", "n_coalesced": 4},
                 {"type": "choice"}]        # bare line must not crash
        ledger.write_text("".join(json.dumps(e) + "\n" for e in lines))
        q = RetuneQueue(tmp_path / "state.json")
        assert q.ingest(ledger) == 0
        assert q.state["traffic"]["k|h|m=64"] == 5
        assert q.state["traffic"]["?|?|?"] == 1
        assert q.summary()["traffic_keys"] == 2

    def test_done_key_requeues_after_repeated_re_drifts(self, tmp_path):
        """One stray re-drift stays an operator decision; hitting
        ``requeue_after`` (default 2) re-enqueues the key automatically."""
        ledger = tmp_path / "flight.jsonl"
        ledger.write_text(json.dumps(_drift_line()) + "\n")
        q = RetuneQueue(tmp_path / "state.json")
        q.ingest(ledger)
        key = q.pending()[0][0]
        q.mark_done(key, {"succeeded": True})
        with open(ledger, "a") as f:        # first re-drift: counted only
            f.write(json.dumps(_drift_line()) + "\n")
        assert q.ingest(ledger) == 0
        assert q.summary()["pending"] == 0 and q.summary()["requeued"] == 0
        with open(ledger, "a") as f:        # second: the refit did not take
            f.write(json.dumps(_drift_line(rel_error_ewma=0.7)) + "\n")
        assert q.ingest(ledger) == 1
        s = q.summary()
        assert s["pending"] == 1 and s["requeued"] == 1
        assert key not in q.state["done"]
        assert dict(q.pending())[key]["rel_error_ewma"] == 0.7
        # the requeue survives a restart
        assert RetuneQueue(tmp_path / "state.json").summary()["pending"] == 1

    def test_requeue_after_one_requeues_immediately(self, tmp_path):
        ledger = tmp_path / "flight.jsonl"
        ledger.write_text(json.dumps(_drift_line()) + "\n")
        q = RetuneQueue(tmp_path / "state.json", requeue_after=1)
        q.ingest(ledger)
        key = q.pending()[0][0]
        q.mark_done(key, {"succeeded": True})
        with open(ledger, "a") as f:
            f.write(json.dumps(_drift_line()) + "\n")
        assert q.ingest(ledger) == 1
        assert q.summary()["pending"] == 1 and q.summary()["requeued"] == 1


def _retune_setup(tmp_path):
    cache = DriverCache(str(tmp_path / "cache"))
    refs = tier1_spec_refs()
    spec = refs["matmul_b16"].build()
    kl = Klaraptor(_device(), hw=H100, cache=cache)
    kl.build_driver(spec, probe_data=_pd(spec), repeats=2,
                    max_configs_per_size=N_CFG, seed=SEED, register=False)
    ledger = tmp_path / "flight.jsonl"
    ledger.write_text(json.dumps(_drift_line()) + "\n")
    q = RetuneQueue(tmp_path / "state.json")
    assert q.ingest(ledger) == 1
    return cache, refs, q


class TestRetuneEndToEnd:
    def test_ledger_to_versioned_cache_without_touching_serving(
            self, tmp_path):
        """Drift key -> farm probe -> refit -> versioned write-through; the
        coordinator process's registry (the 'serving' side here, thanks to
        the spawned process backend) never sees the swap."""
        from repro_torch.core.driver import registry
        from repro_torch.search import SearchBudget

        cache, refs, q = _retune_setup(tmp_path)
        v0 = _artifacts(tmp_path / "cache")
        gen_before = registry.generation
        with FleetCoordinator(
                tmp_path / "spool", _device(), hw=H100, cache=cache,
                config=FleetConfig(n_workers=2, backend="process",
                                   job_timeout_s=120)) as fc:
            outcomes = fc.retune(
                q, refs, budget=SearchBudget(max_executions=600), seed=SEED)
        assert registry.generation == gen_before    # serving untouched
        assert len(outcomes) == 1 and outcomes[0]["succeeded"]
        assert outcomes[0]["cache_version"] >= 1
        assert q.summary() == {**q.summary(), "done": 1, "pending": 0}
        # the durable outcome: a new artifact generation in the cache
        assert _artifacts(tmp_path / "cache") != v0
        assert cache.latest_version("matmul_b16", H100.name) == \
            outcomes[0]["cache_version"]

    def test_unknown_kernel_marked_failed(self, tmp_path):
        ledger = tmp_path / "flight.jsonl"
        ledger.write_text(
            json.dumps(_drift_line(kernel="no_such_kernel")) + "\n")
        q = RetuneQueue(tmp_path / "state.json")
        q.ingest(ledger)
        with FleetCoordinator(tmp_path / "spool", _device(),
                              cache=DriverCache(str(tmp_path / "cache")),
                              config=FleetConfig(n_workers=0)) as fc:
            assert fc.retune(q, tier1_spec_refs()) == []
        assert q.summary()["failed"] == 1


class TestCacheAtomicity:
    def test_concurrent_same_key_puts_never_tear(self, tmp_path):
        """Hammer one entry from many threads while readers poll: every
        read sees a complete JSON document, and no temp files leak."""
        from repro_torch.core.cache import _write_json_atomic

        cache = DriverCache(str(tmp_path / "cache"))
        spec = tier1_spec_refs()["matmul_b16"].build()
        kl = Klaraptor(_device(), hw=H100, cache=cache)
        built = kl.build_driver(spec, probe_data=_pd(spec), repeats=2,
                                max_configs_per_size=N_CFG, seed=SEED,
                                register=False)
        paths = glob.glob(os.path.join(str(tmp_path / "cache"), "**",
                                       "*.json"), recursive=True)
        assert len(paths) == 1
        doc = json.load(open(paths[0]))
        stop = threading.Event()
        torn = []

        def reader():
            while not stop.is_set():
                try:
                    json.load(open(paths[0]))
                except ValueError as e:
                    torn.append(repr(e))

        def writer():
            for _ in range(50):
                _write_json_atomic(paths[0], doc)

        threads = [threading.Thread(target=reader) for _ in range(2)] + \
                  [threading.Thread(target=writer) for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.3)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert torn == []
        leftovers = [p for p in os.listdir(os.path.dirname(paths[0]))
                     if p.endswith(".tmp")]
        assert leftovers == []
        assert built is not None


class TestFleetCLI:
    def test_status_with_nothing_to_show(self, capsys):
        from repro_torch.launch.fleet import main
        assert main(["status"]) == 1

    def test_tune_cli_smoke(self, tmp_path, capsys):
        from repro_torch.launch.fleet import main
        rc = main(["tune", "--spool", str(tmp_path / "spool"),
                   "--workers", "2", "--kernels", "matmul_b16",
                   "--max-configs-per-size", "4", "--repeats", "2",
                   "--cache", str(tmp_path / "cache"), "--device", "cpu"])
        out = capsys.readouterr().out
        assert rc == 0
        assert "matmul_b16" in out and "farmed" in out

    def test_worker_id_with_dot_rejected(self, tmp_path):
        from repro_torch.launch.fleet import main
        with pytest.raises(SystemExit):
            main(["worker", "--spool", str(tmp_path / "spool"),
                  "--id", "bad.id"])

    def test_retune_cli_empty_queue(self, tmp_path, capsys):
        from repro_torch.launch.fleet import main
        rc = main(["retune", "--spool", str(tmp_path / "spool"),
                   "--state", str(tmp_path / "state.json")])
        assert rc == 0
        assert "nothing pending" in capsys.readouterr().out


# -- the two packages on the same inputs --------------------------------------

def _reference_ledger(tmp_path, monkeypatch):
    """A ledger written by the JAX package's closed telemetry loop (its TPU
    simulator, refit on): choices, probes, a drift and a refit."""
    monkeypatch.setenv("KLARAPTOR_CACHE_DIR", str(tmp_path / "refcache"))
    path = tmp_path / "ref.jsonl"
    cfg = RefTelemetryConfig(probe_every=1, min_samples=2,
                             drift_threshold=0.2, ewma_alpha=1.0,
                             refit_budget=RefSearchBudget(max_executions=24),
                             refit_repeats=1, refit_max_configs_per_size=4)
    tel = RefTelemetry([ref_matmul_spec()], V5eSimulator(seed=3), config=cfg,
                       cache=False, ledger=str(path))
    D = {"m": 1024, "n": 1024, "k": 1024}
    try:
        for i in range(6):
            tel._on_choice(RefChoiceEvent(
                kernel="matmul_b16", D=dict(D),
                config={"bm": 128, "bn": 512, "bk": 512}, source="driver",
                predicted_s=1e-9, hw_name="tpu_v5e", n_coalesced=1 + i,
                t_ns=1_000 + i))
        tel.note_bucket_step(False, 0.0, kernel="matmul_b16")
    finally:
        tel.ledger.close()
        ref_registry.clear()
    # a second drifted key, so the drain order has something to rank
    with open(path, "a") as f:
        f.write(json.dumps({"type": "drift", "kernel": "moe_gmm_b16",
                            "hw": "tpu_v5e", "bucket": "e3,g9,k9,n9",
                            "rel_error_ewma": 0.3}) + "\n")
    return path


def test_queue_ingests_a_reference_ledger_as_the_reference(
        tmp_path, monkeypatch):
    """One ledger the reference's telemetry wrote, ingested by both
    queues: the same new keys, pending order, priorities and state file
    bytes; the port then reads the reference's state file as its own."""
    path = _reference_ledger(tmp_path, monkeypatch)
    types = {json.loads(line)["type"] for line in open(path)}
    assert {"choice", "drift", "refit"} <= types
    ref = ref_fleet.RetuneQueue(tmp_path / "ref_state.json")
    port = RetuneQueue(tmp_path / "port_state.json")
    assert port.ingest(path) == ref.ingest(path) == 2
    assert port.pending() == ref.pending()
    assert [port.priority(k) for k, _ in port.pending()] == \
        [ref.priority(k) for k, _ in ref.pending()]
    assert port.summary() == ref.summary()
    assert (tmp_path / "port_state.json").read_bytes() == \
        (tmp_path / "ref_state.json").read_bytes()
    back = RetuneQueue(tmp_path / "ref_state.json")
    assert back.state == ref.state and back.pending() == ref.pending()
    assert back.ingest(path) == 0          # the reference's offset holds
    key = ref.pending()[0][0]
    back.mark_done(key, {"succeeded": True})
    ref.mark_done(key, {"succeeded": True})
    assert back.state == ref.state


def _board_script(mod, root) -> list:
    """Submit, claim, speculate, complete twice, fail, requeue and expire
    on one board: the counts and every stage's file names after each
    step."""
    board = mod.JobBoard(root, max_attempts=2)
    jobs = [mod.make_job("batch", {"n": i}) for i in range(4)]
    trace = []

    def snap(label):
        stages = {s: sorted(os.listdir(os.path.join(root, s)))
                  for s in ("jobs", "claimed", "results", "failed")}
        stages["results"] = [n for n in stages["results"]
                             if n.endswith(".json")]
        trace.append((label, board.counts(), stages))

    for j in jobs:
        board.submit(j)
    snap("submit")
    a = board.claim("w0")["key"]
    b = board.claim("w1")["key"]
    snap("claim")
    board.speculate(a)
    c = board.claim("w2")["key"]
    snap("speculate")
    board.complete(a, "w2", {"by": "w2"})
    board.complete(a, "w0", {"by": "w0"})
    snap("complete")
    trace.append(("result", board.result(a)["by"], None))
    board.fail(b, "w1", "boom")
    snap("fail")
    d = board.claim("w1")["key"]
    board.requeue_worker("w1", "lost")
    snap("requeue_worker")
    board.claim("w3")
    time.sleep(0.05)
    board.requeue_stale(lease_s=0.0)
    snap("requeue_stale")
    trace.append(("failure", board.failure(b) is None, None))
    board.request_stop()
    trace.append(("stop", board.stop_requested(), c == d))
    return trace


def test_board_script_ends_in_the_reference_states(tmp_path):
    port = _board_script(__import__("repro_torch.fleet", fromlist=["x"]),
                         str(tmp_path / "port"))
    ref = _board_script(ref_fleet, str(tmp_path / "ref"))
    assert port == ref


# -- divergences the card forces (H1-H5, max_stages) --------------------------

def test_h1_process_backend_spawns_and_a_spawned_worker_runs_a_job(
        tmp_path):
    """H1: the process backend starts its workers with ``spawn`` (a child
    forked after the parent touched CUDA cannot use CUDA); a spawned
    worker rebuilds the oracle from the job's JSON and completes a batch
    job to the single-process bytes."""
    name = "matmul_b16"
    sp = _single(tmp_path / "c1", name)
    ref = tier1_spec_refs()[name]
    with FleetCoordinator(
            tmp_path / "spool", _device(), hw=H100,
            cache=DriverCache(str(tmp_path / "c2")),
            config=FleetConfig(n_workers=1, backend="process",
                               job_timeout_s=120)) as fc:
        handle = fc.workers[0].handle
        assert isinstance(handle, multiprocessing.context.SpawnProcess)
        assert handle._start_method == "spawn"      # noqa: SLF001
        fb = fc.tune({name: ref}, probe_data=_pd(ref.build()), repeats=2,
                     max_configs_per_size=N_CFG, seed=SEED)[name]
        assert fc.stats.by_kind == {"batch": 2}
        workers = {fc.board.result(k)["worker"]
                   for k in (n[:-5] for n in os.listdir(
                       os.path.join(fc.board.root, "results"))
                             if n.endswith(".json"))}
    assert workers == {"w0"}
    assert collected_equal(sp.collected, fb.collected) == []
    src = inspect.getsource(
        __import__("repro_torch.fleet.coordinator", fromlist=["x"]))
    assert 'get_context("fork")' not in src


@pytest.mark.parametrize("backend", ["thread", "process"])
def test_h2_timed_probes_on_one_card_take_turns(tmp_path, monkeypatch,
                                                backend):
    """H2: two workers (threads, or spawned processes) probing through an
    oracle that holds one card's lock, as ``CudaEventTimer`` holds the
    card's: every held interval is logged (``KLARAPTOR_CARD_LOCK_LOG``),
    both workers held it, and no two intervals overlap.  The farm's bytes
    stay the single-process build's."""
    log = tmp_path / "lock.log"
    monkeypatch.setenv(LOG_ENV, str(log))
    lock = str(tmp_path / "card.lock")
    name = "matmul_b16"
    sp = _single(tmp_path / "c1", name)
    ref = tier1_spec_refs()[name]
    # ~5 s of simulated card time in 8 jobs: the later of two spawned
    # workers starts long before the first could drain the spool
    oracle = WallClockSim(_device(), scale=2000.0, slice_s=0.005,
                          card_lock=lock)
    probes = default_probe_data(ref.build())[:8]
    with FleetCoordinator(
            tmp_path / "spool", oracle, hw=H100,
            cache=DriverCache(str(tmp_path / "c2")),
            config=FleetConfig(n_workers=2, backend=backend,
                               job_timeout_s=120)) as fc:
        fb = fc.tune({name: ref}, probe_data=probes, repeats=2,
                     max_configs_per_size=N_CFG, seed=SEED)[name]
    single = collect(ref.build(), _device(), probe_data=probes, hw=H100,
                     repeats=2, max_configs_per_size=N_CFG, seed=SEED)
    assert collected_equal(single, fb.collected) == []
    intervals = read_intervals(log)
    holders = {(r["pid"], r["thread"]) for r in intervals}
    assert len(holders) >= 2, holders
    assert len(intervals) >= len(probes)
    assert largest_overlap(intervals) == 0.0
    assert sp is not None


def test_h2_largest_overlap_sees_an_overlap():
    """The check the H2 gates read: touching intervals do not overlap,
    nested and crossing ones do, by the shared length."""
    iv = [{"t0": 0.0, "t1": 1.0}, {"t0": 1.0, "t1": 2.0}]
    assert largest_overlap(iv) == 0.0
    iv.append({"t0": 1.5, "t1": 1.75})
    assert largest_overlap(iv) == pytest.approx(0.25)
    iv.append({"t0": 0.5, "t1": 3.0})
    assert largest_overlap(iv) == pytest.approx(1.0)


def test_h3_the_card_contract_keeps_rows_and_cache_key(tmp_path):
    """H3: on the card two runs never time the same bytes, so the farm's
    card contract is weaker: the rows (D, configs, executions) equal a
    single-process collect of the same seed for strategies whose rows do
    not read times (the default sweep, random, lhs), and the farm lands
    under the single-process cache key.  Shown with two oracles whose
    times differ (noise 0.08 and 0.04)."""
    name = "matmul_b16"
    ref = tier1_spec_refs()[name]
    spec = ref.build()
    for strategy in (None, "random", "lhs"):
        single = collect(spec, _device(noise=0.08), probe_data=_pd(spec),
                         hw=H100, repeats=2, max_configs_per_size=N_CFG,
                         seed=SEED, strategy=strategy)
        root = tmp_path / str(strategy)
        with FleetCoordinator(
                root / "spool", _device(), hw=H100,
                cache=DriverCache(str(root / "cache")),
                config=FleetConfig(n_workers=2)) as fc:
            fb = fc.tune({name: ref}, probe_data=_pd(spec), repeats=2,
                         max_configs_per_size=N_CFG, seed=SEED,
                         strategy=strategy)[name]
        assert collected_rows_equal(single, fb.collected) == []
        assert collected_equal(single, fb.collected) != []
        # the farm's driver is the one a single-process build keys
        again = Klaraptor(_device(), hw=H100,
                          cache=DriverCache(str(root / "cache"))
                          ).build_driver(spec, probe_data=_pd(spec),
                                         repeats=2,
                                         max_configs_per_size=N_CFG,
                                         seed=SEED, strategy=strategy)
        assert again.from_cache
        assert again.driver.source == fb.driver.source


def test_h3_a_card_job_refuses_other_hardware_and_never_falls_back():
    """H3: ``hw_by_name`` knows the port's names (the cc-9.0 table, and
    the card's own where one is present), not the TPU's; a job that times
    on the card is rebuilt only on a card (no fall-back to
    ``HopperModel``) of the model it was tuned for."""
    assert hw_by_name("h100_sxm_cc90") == H100
    with pytest.raises(KeyError):
        hw_by_name("tpu_v5e")
    job = {"kind": "cuda_event_timer", "hw": "NVIDIA H100 80GB HBM3",
           "warmup": 1, "timings": 3, "seed": 0}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_from_json(job)
    with pytest.raises(TypeError, match="cannot serialize"):
        device_to_json(object())


def _timer_of(hw):
    """A ``CudaEventTimer`` as the coordinator sees it (its settings), made
    without a card: the constructor needs one."""
    from repro_torch.core import CudaEventTimer

    timer = CudaEventTimer.__new__(CudaEventTimer)
    timer.hw, timer.warmup, timer.timings, timer.seed = hw, 1, 3, 0
    return timer


def test_h3_the_coordinator_refuses_a_timer_of_another_card(tmp_path,
                                                           monkeypatch):
    """H3: a coordinator given a ``CudaEventTimer`` tuned for another card
    model than the one present (here the cc-9.0 table's ``h100_sxm_cc90``
    on a card named otherwise) raises at construction -- before any
    worker starts -- and so does one on a host with no card."""
    import dataclasses

    import repro_torch.fleet.jobs as jobs

    card = dataclasses.replace(H100, name="NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(jobs, "_card_hw", lambda: card)
    with pytest.raises(ValueError, match="tuned for 'h100_sxm_cc90'"):
        FleetCoordinator(tmp_path / "spool", _timer_of(H100))
    monkeypatch.setattr(jobs, "_card_hw", lambda: None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FleetCoordinator(tmp_path / "spool", _timer_of(card))
    assert not (tmp_path / "spool").exists()     # refused before the board


def test_h4_a_worker_whose_warm_up_fails_fails_its_jobs(tmp_path,
                                                        monkeypatch):
    """H4: a worker whose warm-up raises (its oracle is a timer of another
    card model) stays up and fails every job it claims with that error, so
    the board parks the job in failed/ after ``max_attempts``; the worker
    is neither crashed nor respawned."""
    import dataclasses

    import repro_torch.fleet.jobs as jobs
    from repro_torch.fleet import run_worker

    card = dataclasses.replace(H100, name="NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(jobs, "_card_hw", lambda: card)
    warm = device_to_json(_timer_of(H100))
    board = JobBoard(tmp_path / "spool")
    job = make_job("batch", {"spec": tier1_spec_refs()["matmul_b16"]
                             .to_json(), "device": warm, "hw": H100.name})
    board.submit(job)
    done = run_worker(tmp_path / "spool", "w0", poll_s=0.005,
                      idle_exit_s=0.3, warm=warm)
    assert done == 0
    fail = board.failure(job.key)
    assert fail is not None and fail["attempts"] == board.max_attempts
    assert all("warm-up failed" in e["error"] and "tuned for" in e["error"]
               for e in fail["errors"])
    assert board.result(job.key) is None


def test_h4_workers_warm_before_the_first_claim(tmp_path, monkeypatch):
    """H4: a worker builds the coordinator's oracle and calls its
    ``warm()`` (on the card: the kernel libraries and the CUDA context)
    before it claims anything, so no lease runs through a build."""
    events = []
    monkeypatch.setattr(
        HopperModel, "warm",
        lambda self: events.append(("warm", threading.get_ident())),
        raising=False)
    orig = JobBoard.claim

    def claim(self, worker):
        doc = orig(self, worker)
        if doc is not None:
            events.append(("claim", threading.get_ident()))
        return doc

    monkeypatch.setattr(JobBoard, "claim", claim)
    name = "matmul_b16"
    ref = tier1_spec_refs()[name]
    with FleetCoordinator(
            tmp_path / "spool", _device(), hw=H100,
            cache=DriverCache(str(tmp_path / "c2")),
            config=FleetConfig(n_workers=2)) as fc:
        fc.tune({name: ref}, probe_data=_pd(ref.build(), 4), repeats=2,
                max_configs_per_size=N_CFG, seed=SEED)
    warmed = [t for k, t in events if k == "warm"]
    assert len(warmed) == len(set(warmed)) == 2
    claimers = {t for k, t in events if k == "claim"}
    assert claimers and claimers <= set(warmed)
    for t in claimers:
        mine = [k for k, tt in events if tt == t]
        assert mine[0] == "warm" and mine.count("warm") == 1


def test_h4_a_waiter_on_the_card_lock_keeps_beating(tmp_path):
    """H4: a worker queued behind another's probe keeps its lease: it
    calls ``beat`` while it waits for the card's lock."""
    lock = CardLock(tmp_path / "card.lock")
    beats = []
    held = threading.Event()
    release = threading.Event()

    def holder():
        with lock.hold():
            held.set()
            release.wait(5.0)

    t = threading.Thread(target=holder)
    t.start()
    assert held.wait(5.0)
    waiter_done = threading.Event()

    def waiter():
        with lock.hold(lambda: beats.append(time.monotonic())):
            waiter_done.set()

    w = threading.Thread(target=waiter)
    w.start()
    time.sleep(0.2)
    assert not waiter_done.is_set()     # excluded while the other holds
    assert len(beats) >= 10
    release.set()
    t.join(5.0)
    w.join(5.0)
    assert waiter_done.is_set() and not t.is_alive() and not w.is_alive()


def test_h4_results_record_the_longest_beat_gap(tmp_path):
    """H4: every result carries ``max_beat_gap_s``, the longest gap between
    two heartbeats of its job: short under ``WallClockSim``'s sliced
    sleeps, the hang's length under a hang fault."""
    name = "matmul_b16"
    ref = tier1_spec_refs()[name]
    oracle = WallClockSim(_device(), scale=50.0, slice_s=0.01)
    with FleetCoordinator(
            tmp_path / "spool", oracle, hw=H100,
            cache=DriverCache(str(tmp_path / "c2")),
            config=FleetConfig(n_workers=1, lease_s=5.0),
            worker_faults={0: FaultPlan(hang_at_job=2, hang_s=0.6)}) as fc:
        fc.tune({name: ref}, probe_data=_pd(ref.build(), 3), repeats=2,
                max_configs_per_size=N_CFG, seed=SEED)
        docs = [fc.board.result(n[:-5]) for n in os.listdir(
            os.path.join(fc.board.root, "results")) if n.endswith(".json")]
    gaps = sorted(d["max_beat_gap_s"] for d in docs)
    assert len(gaps) == 3
    assert gaps[-1] >= 0.6 > gaps[0]


def test_h5_a_thread_workers_retune_swaps_in_the_coordinators_registry(
        tmp_path):
    """H5: the reference's retune job hot-swaps the refit driver into the
    registry of the process it runs in.  With process workers that is
    discarded with the worker (the end-to-end test above); with thread
    workers it is the coordinator's own registry, which the swap moves --
    kept as the reference has it, and documented."""
    from repro_torch.core.driver import registry
    from repro_torch.search import SearchBudget

    cache, refs, q = _retune_setup(tmp_path)
    registry.clear()
    gen_before = registry.generation
    try:
        with FleetCoordinator(
                tmp_path / "spool", _device(), hw=H100, cache=cache,
                config=FleetConfig(n_workers=1, job_timeout_s=120)) as fc:
            outcomes = fc.retune(
                q, refs, budget=SearchBudget(max_executions=600), seed=SEED)
        assert outcomes[0]["succeeded"]
        assert registry.generation > gen_before
        assert registry.get("matmul_b16") is not None
    finally:
        registry.clear()


def test_payloads_carry_no_max_stages(tmp_path):
    """The port's ``collect`` has no ``max_stages`` (its Hopper tables carry
    no TPU stage count), so neither do its jobs; the reference's do."""
    assert "max_stages" in inspect.signature(ref_collect).parameters
    assert "max_stages" not in inspect.signature(collect).parameters
    ref = tier1_spec_refs()["matmul_b16"]
    with FleetCoordinator(tmp_path / "spool", _device(), hw=H100,
                          cache=DriverCache(str(tmp_path / "c")),
                          config=FleetConfig(n_workers=1)) as fc:
        fc.tune({"matmul_b16": ref}, probe_data=_pd(ref.build()),
                repeats=2, max_configs_per_size=N_CFG, seed=SEED)
        docs = [fc.board.result(n[:-5]) for n in os.listdir(
            os.path.join(fc.board.root, "results")) if n.endswith(".json")]
    assert docs
    for d in docs:
        assert "shard" in d["payload"]
    job = make_job("batch", fc._common_payload(ref, SEED, 2, N_CFG, None,
                                               None))
    assert "max_stages" not in job.payload
    assert set(job.payload) == {"spec", "device", "hw", "seed", "repeats",
                                "max_configs_per_size", "strategy",
                                "shard_rows"}
