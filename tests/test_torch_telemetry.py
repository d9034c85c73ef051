"""The port's telemetry loop held against the JAX package's.

``repro_torch.telemetry`` is the reference's ``repro.telemetry`` with the
oracle swapped: shadow probes and refits run on ``HopperModel`` here and
on ``CudaEventTimer`` on the card, and ``Telemetry.hw`` defaults to the
oracle's hardware.  The reference's ``tests/test_telemetry.py`` runs here
whole, by name and with its bars, on the f32 matmul (``matmul_spec(4)``,
88 feasible tiles at 1024^3; the bf16 spec is the 9 compiled tiles).  Its
corrupted driver is fitted on ``HopperModel`` over an H100 with three
times the memory rate and peaks, named as the H100 -- the reference's
v5p-as-v5e build.  Then the hardware-free parts are held against the JAX
package on the same inputs: the recorder's primitives and budget slices
exactly, one hand-built choice sequence through both recorders and drift
detectors (EWMAs to 1e-12).  Last, the port's own rule: a probe decided
while a CUDA graph is being captured waits for the capture's end.
"""

import dataclasses
import json
import logging

import numpy as np
import pytest

from repro.core import V5E
from repro.core.driver import ChoiceEvent as RefChoiceEvent
from repro.search import SearchBudget as RefSearchBudget
from repro.telemetry import DriftDetector as RefDriftDetector
from repro.telemetry import EWMA as RefEWMA
from repro.telemetry import LaunchRecorder as RefLaunchRecorder
from repro.telemetry import RingBuffer as RefRingBuffer
from repro.telemetry import TelemetryConfig as RefTelemetryConfig
from repro.telemetry import refit_probe_shapes as ref_refit_probe_shapes
from repro.telemetry import scale_budget as ref_scale_budget
from repro.telemetry import shape_bucket as ref_shape_bucket

import repro_torch.telemetry.loop as loop_mod
from repro_torch.core import (H100, CandidateTable, HopperModel, Klaraptor,
                              code_digest, exhaustive_search, matmul_spec,
                              registry)
from repro_torch.core.cache import CacheEntry, DriverCache
from repro_torch.core.driver import (ChoiceEvent, choose_or_default,
                                     get_choice_listener, set_choice_listener,
                                     warm_start_from_cache)
from repro_torch.search import SearchBudget
from repro_torch.telemetry import (EWMA, DriftDetector, LaunchRecorder,
                                   RingBuffer, Telemetry, TelemetryConfig,
                                   refit_probe_shapes, scale_budget,
                                   shape_bucket)

D_SMALL = {"m": 1024, "n": 1024, "k": 1024}
# A feasible f32 SIMT tile that no tuned driver takes at 1024^3.
MM_DEFAULT = {"bm": 32, "bn": 32, "bk": 8}
KERNEL = "matmul_b32"
# The H100 with three times its memory rate and peaks, under its name: a
# driver fitted on it warm-starts on the H100 and mispredicts it.
OFF_PHYSICS = dataclasses.replace(
    H100, hbm_bw=3 * H100.hbm_bw, peak_flops_f32=3 * H100.peak_flops_f32,
    peak_flops_bf16=3 * H100.peak_flops_bf16)


@pytest.fixture()
def clean(tmp_path, monkeypatch):
    """Isolated cache dir, empty registry, no leftover choice listener."""
    monkeypatch.setenv("KLARAPTOR_CACHE_DIR", str(tmp_path / "cache"))
    registry.clear()
    set_choice_listener(None)
    yield str(tmp_path / "cache")
    set_choice_listener(None)
    registry.clear()


def _event(D, predicted=1e-3, source="driver", kernel=KERNEL, config=None):
    return ChoiceEvent(kernel=kernel, D=dict(D),
                       config=config or dict(MM_DEFAULT), source=source,
                       predicted_s=predicted, hw_name=H100.name)


def _corrupted_build(register=True, seed=7):
    """A driver fitted against other physics under the H100's name: it
    warm-starts on the H100 and mispredicts it (the reference's v5p
    physics masquerading as v5e)."""
    kl = Klaraptor(HopperModel(OFF_PHYSICS, noise=0.04, seed=seed),
                   device="cpu", hw=OFF_PHYSICS)
    return kl.build_driver(matmul_spec(4), repeats=2,
                           max_configs_per_size=16, seed=seed,
                           register=register)


class TestRecorderPrimitives:
    def test_shape_bucket_is_log2_and_order_insensitive(self):
        assert shape_bucket({"m": 1024, "n": 1500}) == \
            shape_bucket({"n": 1500, "m": 1024})
        b = dict(shape_bucket({"m": 1024, "n": 1500, "e": 1}))
        assert b == {"m": 10, "n": 11, "e": 0}
        assert dict(shape_bucket({"m": 513}))["m"] == 10
        assert dict(shape_bucket({"m": 4096}))["m"] == 12

    def test_ring_buffer_wraps_oldest_first(self):
        rb = RingBuffer(3)
        for x in (1.0, 2.0):
            rb.push(x)
        assert len(rb) == 2 and list(rb.values()) == [1.0, 2.0]
        for x in (3.0, 4.0):
            rb.push(x)
        assert len(rb) == 3 and list(rb.values()) == [2.0, 3.0, 4.0]
        assert rb.total_pushed == 4

    def test_recorder_samples_first_then_every_nth(self):
        rec = LaunchRecorder(TelemetryConfig(probe_every=3))
        probes = [rec.observe_choice(_event(D_SMALL))[1] for _ in range(7)]
        assert probes == [True, False, False, True, False, False, True]
        _, p = rec.observe_choice(_event(D_SMALL, predicted=None,
                                         source="default"))
        assert p is False

    def test_scale_budget_slices_never_sum_past_total(self):
        for total in (100, 7, 2, 1):
            b = SearchBudget(max_executions=total, max_device_seconds=2.0)
            parts = [scale_budget(b, f) for f in (0.45, 0.5, 0.05)]
            assert sum(p.max_executions for p in parts) <= total
        assert sum(p.max_device_seconds for p in parts) <= 2.0 + 1e-12

    def test_refit_budget_slices_sum_exactly_to_total(self):
        from repro_torch.telemetry import RefitController
        kl = Klaraptor(HopperModel(noise=0.03, seed=5), device="cpu",
                       cache=False)
        ctl = RefitController(kl)
        for total in (200, 7, 2, 1):
            parts = ctl._budgets(SearchBudget(max_executions=total))
            assert sum(p.max_executions for p in parts) == total

    def test_refit_probe_shapes_live_ray(self):
        shapes = refit_probe_shapes({"m": 4096, "k": 4096, "e": 1})
        assert shapes[0] == {"m": 4096, "k": 4096, "e": 1}
        assert {"m": 2048, "k": 2048, "e": 1} in shapes
        assert all(s["e"] == 1 for s in shapes)


class TestDriftDetector:
    def _loop(self, rel_err, n, cfg):
        rec = LaunchRecorder(cfg)
        det = DriftDetector(cfg)
        events = []
        for _ in range(n):
            stats, _ = rec.observe_choice(_event(D_SMALL))
            rec.record_probe(stats, 1e-3, 1e-3 * (1.0 + rel_err))
            events.append(det.update(stats))
        return events

    def test_no_fire_below_threshold(self):
        cfg = TelemetryConfig(drift_threshold=0.25, min_samples=3,
                              probe_every=1)
        assert all(e is None for e in self._loop(0.1, 8, cfg))

    def test_fires_only_after_min_samples(self):
        cfg = TelemetryConfig(drift_threshold=0.25, min_samples=3,
                              probe_every=1)
        events = self._loop(0.8, 4, cfg)
        assert events[0] is None and events[1] is None
        assert events[2] is not None
        assert events[2].rel_error_ewma > 0.25
        assert events[2].D == D_SMALL

    def test_cooldown_and_circuit_breaker(self):
        cfg = TelemetryConfig(drift_threshold=0.25, min_samples=1,
                              probe_every=1, cooldown_choices=5,
                              max_refits_per_key=2)
        events = self._loop(0.8, 14, cfg)
        fired = [i for i, e in enumerate(events) if e is not None]
        assert fired[0] == 0
        assert fired[1] - fired[0] >= 5
        assert len(fired) == 2

    def test_monitoring_mode_keeps_reporting_drift(self):
        cfg = TelemetryConfig(drift_threshold=0.25, min_samples=1,
                              probe_every=1, cooldown_choices=2,
                              max_refits_per_key=2, refit_enabled=False)
        events = self._loop(0.8, 12, cfg)
        fired = [i for i, e in enumerate(events) if e is not None]
        assert len(fired) > 2


class CountingModel(HopperModel):
    """``HopperModel`` counting its ``probe_rows`` calls."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.probe_rows_calls = 0

    def probe_rows(self, table, rng, repeats=1):
        self.probe_rows_calls += 1
        return super().probe_rows(table, rng, repeats)


class TestSearchMemoScoping:
    """The per-shape search memo is keyed by strategy and budget: another
    strategy or a raised budget searches again."""

    def test_strategy_and_budget_scope_the_memo(self, clean):
        sim = CountingModel(noise=0.03, seed=5)
        spec = matmul_spec(4)
        kw = dict(spec=spec, device=sim)

        choose_or_default(spec.name, D_SMALL, MM_DEFAULT, strategy="random",
                          budget=SearchBudget(max_executions=16), **kw)
        n1 = sim.probe_rows_calls
        assert n1 > 0
        choose_or_default(spec.name, D_SMALL, MM_DEFAULT, strategy="random",
                          budget=SearchBudget(max_executions=16), **kw)
        assert sim.probe_rows_calls == n1
        choose_or_default(spec.name, D_SMALL, MM_DEFAULT, strategy="lhs",
                          budget=SearchBudget(max_executions=16), **kw)
        n2 = sim.probe_rows_calls
        assert n2 > n1
        choose_or_default(spec.name, D_SMALL, MM_DEFAULT, strategy="random",
                          budget=SearchBudget(max_executions=48), **kw)
        assert sim.probe_rows_calls > n2


class TestWarmStartTolerance:
    """One bad cached driver must not stop a serving process at start:
    one warning, then it is skipped."""

    def _put_bad_entry(self, spec):
        cache = DriverCache()
        cache.put(CacheEntry(
            kernel=spec.name, key="0" * 64,
            source="def broken(:\n",          # valid hash, invalid python
            fits={}, code=code_digest(spec), created_at=1.0,
            hw_name=H100.name))
        return cache

    def test_warm_start_skips_and_warns_once(self, clean, caplog,
                                             monkeypatch):
        import repro_torch.core.driver as driver_mod
        monkeypatch.setattr(driver_mod, "_bad_entry_warned", False)
        spec = matmul_spec(4)
        self._put_bad_entry(spec)
        with caplog.at_level(logging.WARNING,
                             logger="repro_torch.core.driver"):
            assert warm_start_from_cache([spec]) == []
            assert warm_start_from_cache([spec]) == []
        warns = [r for r in caplog.records if "failed to load" in r.message]
        assert len(warns) == 1

    def test_choose_or_default_survives_bad_entry(self, clean, monkeypatch):
        import repro_torch.core.driver as driver_mod
        monkeypatch.setattr(driver_mod, "_bad_entry_warned", False)
        spec = matmul_spec(4)
        self._put_bad_entry(spec)
        got = choose_or_default(KERNEL, D_SMALL, MM_DEFAULT, spec=spec)
        assert got == MM_DEFAULT


def _entry(key, source, created_at, version=0):
    return CacheEntry(kernel="k", key=key, source=source, fits={}, code="c",
                      created_at=created_at, hw_name=H100.name,
                      tuning_version=version)


class TestCacheVersioning:
    def test_lookup_prefers_higher_tuning_version(self, clean):
        cache = DriverCache()
        cache.put(_entry("a" * 64, "S0", 100.0))
        cache.put(_entry("b" * 64, "S1", 1.0, version=1))   # older stamp
        assert cache.latest_version("k", H100.name) == 1
        assert cache.lookup_latest("k", H100.name).source == "S1"

    def test_invalidate_below_version(self, clean):
        cache = DriverCache()
        for i, key in enumerate(("a" * 64, "b" * 64, "c" * 64)):
            cache.put(_entry(key, f"S{i}", float(i), version=i))
        assert cache.invalidate("k", H100.name, below_version=2) == 2
        assert cache.lookup_latest("k", H100.name).tuning_version == 2
        assert cache.latest_version("k", H100.name) == 2

    def test_tampered_version_is_evicted(self, clean):
        cache = DriverCache()
        path = cache.put(_entry("a" * 64, "S", 1.0, version=1))
        raw = json.load(open(path))
        raw["tuning_version"] = 99
        json.dump(raw, open(path, "w"))
        assert cache.lookup_latest("k", H100.name) is None


class TestClosedLoop:
    """Corrupted fit -> drift detected -> budget-capped refit -> hot swap
    -> versioned write-through read by a fresh registry."""

    @pytest.fixture()
    def loop(self, clean):
        corrupted = _corrupted_build()
        sim = HopperModel(noise=0.04, seed=11)
        budget = SearchBudget(max_executions=160, max_device_seconds=1.0)
        tel = Telemetry([matmul_spec(4)], sim, seed=3, config=TelemetryConfig(
            probe_every=2, refit_budget=budget)).install()
        for _ in range(24):
            choose_or_default(KERNEL, D_SMALL, MM_DEFAULT)
            if tel.refits:
                break
        yield tel, sim, corrupted, budget
        tel.uninstall()

    def test_drift_detected_and_refit_runs(self, loop):
        tel, sim, corrupted, _ = loop
        assert len(tel.drift_events) == 1
        drift = tel.drift_events[0]
        assert drift.kernel == KERNEL
        assert drift.rel_error_ewma > tel.config.drift_threshold
        assert len(tel.refits) == 1 and tel.refits[0].succeeded

    def test_refit_budget_never_exceeded(self, loop):
        tel, _, _, budget = loop
        r = tel.refits[0]
        assert r.total_executions <= budget.max_executions
        assert r.total_device_seconds <= budget.max_device_seconds
        assert r.search_device_seconds <= budget.max_device_seconds
        assert r.fit_device_seconds <= budget.max_device_seconds

    def test_hot_swap_improves_serving_choice(self, loop):
        tel, sim, corrupted, _ = loop
        drv = registry.get(KERNEL)
        assert drv is not None
        assert drv.source != corrupted.driver.source
        cfg = choose_or_default(KERNEL, D_SMALL, MM_DEFAULT)
        assert cfg != MM_DEFAULT
        spec = matmul_spec(4)
        one = CandidateTable.from_rows(spec.program_params, [cfg])
        t = float(sim.true_time_batch(
            spec.traffic_table(D_SMALL, one, H100))[0])
        _, best_t, _, _ = exhaustive_search(spec, sim, D_SMALL, H100)
        assert best_t / t >= 0.90

    def test_fresh_registry_picks_up_versioned_entry(self, loop):
        tel, sim, corrupted, _ = loop
        cache = DriverCache()
        assert cache.latest_version(KERNEL, H100.name) == 1
        entry = cache.lookup_latest(KERNEL, H100.name)
        assert entry.tuning_version == 1
        assert entry.source != corrupted.driver.source
        registry.clear()
        assert warm_start_from_cache([matmul_spec(4)]) == [KERNEL]
        assert registry.get(KERNEL).source == entry.source
        assert registry.get(KERNEL).tuning_version == 1

    def test_counters_and_exporter_consistent(self, loop):
        tel, *_ = loop
        snap = tel.snapshot()
        c = snap["counters"]
        assert c["drift_events_total"] == 1
        assert c["refits_total"] == 1
        assert c["shadow_probes_total"] >= tel.config.min_samples
        assert c["probe_device_seconds_total"] > 0
        assert c["refit_device_seconds_total"] == pytest.approx(
            tel.refits[0].total_device_seconds)
        assert sum(c["choices_by_source"].values()) == c["choices_total"]
        assert snap["refits"][0]["succeeded"] is True


class TestFailedRefit:
    def test_failed_refit_keeps_old_driver_and_pins_override(self, clean,
                                                             monkeypatch):
        corrupted = _corrupted_build()
        sim = HopperModel(noise=0.04, seed=11)
        tel = Telemetry([matmul_spec(4)], sim, seed=3, config=TelemetryConfig(
            probe_every=1, min_samples=2,
            refit_budget=SearchBudget(max_executions=64)))

        def broken_build(*a, **k):
            raise RuntimeError("collect blew up")

        monkeypatch.setattr(tel.klaraptor, "build_driver", broken_build)
        with tel:
            for _ in range(8):
                choose_or_default(KERNEL, D_SMALL, MM_DEFAULT)
                if tel.refits:
                    break
        r = tel.refits[0]
        assert not r.succeeded and "fit:" in r.error
        drv = registry.get(KERNEL)
        assert drv is not None
        assert drv.source == corrupted.driver.source
        assert r.override == r.searched_config is not None
        assert registry.override(KERNEL, H100.name, D_SMALL) == r.override
        assert choose_or_default(KERNEL, D_SMALL, MM_DEFAULT) == r.override


class TestExporter:
    def test_snapshot_deterministic_and_json_stable(self, clean):
        tel = Telemetry([matmul_spec(4)], HopperModel(noise=0.04, seed=1),
                        cache=False)
        with tel:
            for _ in range(3):
                choose_or_default("nosuchkernel", D_SMALL, MM_DEFAULT)
        assert tel.snapshot() == tel.snapshot()
        assert tel.exporter.json() == tel.exporter.json()
        c = tel.snapshot()["counters"]
        assert c["choices_total"] == 3
        assert c["fallback_default_total"] == 3

    def test_prometheus_format(self, clean):
        tel = Telemetry([matmul_spec(4)], HopperModel(noise=0.04, seed=1),
                        cache=False)
        with tel:
            choose_or_default("nosuchkernel", D_SMALL, MM_DEFAULT)
        text = tel.prometheus()
        assert text == tel.prometheus()
        assert 'klaraptor_choices_total{source="default"} 1' in text
        assert "# TYPE klaraptor_drift_events_total counter" in text
        assert text.endswith("\n")

    def test_listener_errors_never_break_serving(self, clean, monkeypatch):
        import repro_torch.core.driver as driver_mod
        monkeypatch.setattr(driver_mod, "_listener_error_warned", False)

        def bomb(event):
            raise RuntimeError("telemetry bug")

        set_choice_listener(bomb)
        assert choose_or_default(KERNEL, D_SMALL, MM_DEFAULT) == MM_DEFAULT
        assert get_choice_listener() is bomb


class TestOverridePath:
    def test_override_outranks_driver(self, clean):
        build = _corrupted_build()
        pinned = {"bm": 64, "bn": 64, "bk": 16}
        registry.note_override(KERNEL, H100.name, D_SMALL, pinned)
        assert choose_or_default(KERNEL, D_SMALL, MM_DEFAULT) == pinned
        other = {"m": 2048, "n": 2048, "k": 2048}
        assert choose_or_default(KERNEL, other, MM_DEFAULT) == \
            build.driver.choose(other)

    def test_invalidate_kernel_clears_override(self, clean):
        _corrupted_build()
        registry.note_override(KERNEL, H100.name, D_SMALL,
                               {"bm": 64, "bn": 64, "bk": 16})
        registry.invalidate_kernel(KERNEL)
        assert registry.override(KERNEL, H100.name, D_SMALL) is None
        assert registry.get(KERNEL) is None


# -- the hardware-free parts against the JAX package --------------------------

def _shapes(rng, n):
    return [{"m": int(rng.choice([300, 1024, 1500, 4096])),
             "n": int(rng.choice([512, 2048])), "k": 1 + int(rng.randint(8))}
            for _ in range(n)]


def test_recorder_primitives_identical_to_reference():
    rng = np.random.RandomState(0)
    for D in _shapes(rng, 40):
        assert shape_bucket(D) == ref_shape_bucket(D)
        assert refit_probe_shapes(D) == ref_refit_probe_shapes(D)
        assert refit_probe_shapes(D, (1, 3, 8)) == \
            ref_refit_probe_shapes(D, (1, 3, 8))
    values = rng.lognormal(size=50)
    for cap in (1, 3, 8, 64):
        port, ref = RingBuffer(cap), RefRingBuffer(cap)
        for x in values:
            port.push(x)
            ref.push(x)
            assert np.array_equal(port.values(), ref.values())
            assert (len(port), port.total_pushed) == \
                (len(ref), ref.total_pushed)
    for alpha in (0.1, 0.3, 1.0):
        port, ref = EWMA(alpha), RefEWMA(alpha)
        assert [port.update(x) for x in values] == \
            [ref.update(x) for x in values]
    for total in (1, 2, 7, 100, 160):
        for secs in (None, 0.25, 1.0):
            for frac in (0.05, 0.45, 0.475, 0.5, 1.0):
                got = scale_budget(SearchBudget(total, secs), frac)
                want = ref_scale_budget(RefSearchBudget(total, secs), frac)
                assert (got.max_executions, got.max_device_seconds) == \
                    (want.max_executions, want.max_device_seconds)


def test_recorder_and_detector_sequence_identical_to_reference():
    """One seeded sequence of choices (buckets, coalesced counts, missing
    predictions) with fixed observed times through both packages'
    recorder and drift detector: the same probe decisions, the same drift
    events, the same EWMAs."""
    rng = np.random.RandomState(7)
    kw = dict(probe_every=3, min_samples=2, drift_threshold=0.3,
              ewma_alpha=0.4, cooldown_choices=5, max_refits_per_key=2)
    port_rec, port_det = (LaunchRecorder(TelemetryConfig(**kw)),
                          DriftDetector(TelemetryConfig(**kw)))
    ref_rec, ref_det = (RefLaunchRecorder(RefTelemetryConfig(**kw)),
                        RefDriftDetector(RefTelemetryConfig(**kw)))
    shapes = _shapes(rng, 4)
    for i in range(300):
        D = shapes[rng.randint(len(shapes))]
        pred = None if rng.rand() < 0.1 else float(rng.lognormal(-7, 0.5))
        n = int(rng.choice([1, 1, 1, 64]))
        cfg = {"bm": 64, "bn": int(rng.choice([64, 128])), "bk": 16}
        observed = float(rng.lognormal(-7, 0.8))
        outs = []
        for rec, det, cls, hw in ((port_rec, port_det, ChoiceEvent,
                                   H100.name),
                                  (ref_rec, ref_det, RefChoiceEvent,
                                   V5E.name)):
            ev = cls(kernel="mm", D=dict(D), config=dict(cfg),
                     source="driver" if pred else "default",
                     predicted_s=pred, hw_name=hw, n_coalesced=n)
            stats, probe = rec.observe_choice(ev)
            ewma = drift = None
            if probe:
                ewma = rec.record_probe(stats, pred, observed)
                drift = det.update(stats)
            outs.append((probe, ewma, stats.n_choices,
                         None if drift is None else (
                             drift.bucket, drift.D, drift.config,
                             drift.rel_error_ewma, drift.n_samples,
                             drift.predicted_s, drift.observed_s)))
        (p_probe, p_ewma, p_n, p_drift), (r_probe, r_ewma, r_n, r_drift) = \
            outs
        assert (p_probe, p_n) == (r_probe, r_n), i
        assert (p_ewma is None) == (r_ewma is None), i
        if p_ewma is not None:
            assert p_ewma == pytest.approx(r_ewma, rel=1e-12, abs=0)
        assert (p_drift is None) == (r_drift is None), i
        if p_drift is not None:
            assert p_drift[:3] == r_drift[:3] and p_drift[4:] == r_drift[4:]
            assert p_drift[3] == pytest.approx(r_drift[3], rel=1e-12, abs=0)
    assert [(s.bucket, s.n_choices, s.n_probes) for s in port_rec.keys()] \
        == [(s.bucket, s.n_choices, s.n_probes) for s in ref_rec.keys()]


# -- the port's own rules -----------------------------------------------------

def test_hw_defaults_to_the_oracles(clean):
    """Without ``hw`` the loop probes and refits on the oracle's hardware
    (the reference defaults to V5E when the oracle names none)."""
    half = dataclasses.replace(H100, name="half_smem",
                               smem_per_block_optin=H100.smem_per_block_optin
                               // 2, smem_per_sm=H100.smem_per_sm // 2)
    tel = Telemetry([matmul_spec(4)], HopperModel(half), cache=False)
    assert tel.hw is half and tel.klaraptor.hw is half
    assert Telemetry([matmul_spec(4)], HopperModel(half), hw=H100,
                     cache=False).hw is H100


def _deferral_run(monkeypatch, capture_first: int):
    """Twelve driver choices through one loop, the first ``capture_first``
    of them while a capture is running (the predicate patched); returns the
    loop, the oracle's probe calls when the capture ended, and what the
    drain ran."""
    registry.clear()
    capturing = [capture_first > 0]
    monkeypatch.setattr(loop_mod, "_capturing", lambda: capturing[0])
    sim = CountingModel(noise=0.04, seed=3)
    tel = Telemetry([matmul_spec(4)], sim, seed=3, cache=False,
                    config=TelemetryConfig(
                        probe_every=1, min_samples=2, drift_threshold=0.2,
                        ewma_alpha=0.5,
                        refit_budget=SearchBudget(max_executions=32),
                        refit_repeats=1, refit_max_configs_per_size=4))
    events = [_event(D_SMALL, predicted=1e-6 * (1 + i)) for i in range(12)]
    calls = ran = None
    for i, ev in enumerate(events):
        if i == capture_first:
            calls = sim.probe_rows_calls
            capturing[0] = False
            ran = tel.drain_deferred()
        tel._on_choice(ev)
    return tel, calls, ran


def _outcome(tel):
    return ([(d.D, d.config, d.rel_error_ewma, d.n_samples, d.observed_s)
             for d in tel.drift_events],
            [(r.succeeded, r.searched_config, r.driver_config, r.override,
              r.total_executions) for r in tel.refits],
            [(s.n_probes, s.rel_error_ewma, list(s.observed.values()))
             for s in tel.recorder.keys()],
            tel.counters.shadow_probes_total)


def test_probe_queued_during_capture_drains_with_the_same_outcome(
        clean, monkeypatch):
    """A probe decided while the stream captures launches nothing; it is
    queued, and the drain after the capture runs the probes (and the
    drift and refit they set off) in order, with the reference's
    synchronous outcome."""
    sync, _, _ = _deferral_run(monkeypatch, capture_first=0)
    assert sync.deferred_total == 0 and sync.drift_events and sync.refits
    deferred, calls, ran = _deferral_run(monkeypatch, capture_first=5)
    assert calls == 0                      # nothing probed in the capture
    assert ran == deferred.deferred_total == 5
    assert deferred.deferred_run_total == 5 and not deferred._deferred
    assert _outcome(deferred) == _outcome(sync)
    counters = deferred.snapshot()["counters"]
    assert counters["choices_total"] == 12


def test_a_later_decision_drains_the_queue_first(clean, monkeypatch):
    capturing = [True]
    monkeypatch.setattr(loop_mod, "_capturing", lambda: capturing[0])
    sim = CountingModel(noise=0.04, seed=3)
    tel = Telemetry([matmul_spec(4)], sim, cache=False,
                    config=TelemetryConfig(probe_every=1,
                                           refit_enabled=False))
    tel._on_choice(_event(D_SMALL))
    tel._on_choice(_event(D_SMALL))
    assert tel.drain_deferred() == 0       # still capturing: nothing runs
    assert sim.probe_rows_calls == 0 and len(tel._deferred) == 2
    capturing[0] = False
    tel._on_choice(_event(D_SMALL))
    assert sim.probe_rows_calls == 3 and tel.deferred_run_total == 2
    assert tel.counters.shadow_probes_total == 3


def test_serve_main_writes_the_trace_the_ledger_and_the_dump(
        clean, tmp_path, capsys):
    from repro_torch.launch import serve
    from repro_torch.trace import read_ledger

    trace, ledger = tmp_path / "t.json", tmp_path / "l.jsonl"
    done = serve.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
                       "--requests", "2", "--max-new", "2", "--telemetry",
                       "--trace", str(trace), "--ledger", str(ledger)])
    out = capsys.readouterr().out
    assert len(done) == 2
    assert "# TYPE klaraptor_shadow_probes_total counter" in out
    assert "klaraptor_warm_started_kernels 0" in out
    assert 'klaraptor_span_duration_seconds_count{span="engine.decode"}' \
        in out
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]
             if e["ph"] == "X"}
    assert {"warm_start", "build_step_plan", "engine.prefill",
            "engine.step", "engine.decode"} <= names
    events = read_ledger(ledger)
    assert events[0]["type"] == "session"
    assert {e["name"] for e in events if e["type"] == "span"} == names
    assert get_choice_listener() is None
