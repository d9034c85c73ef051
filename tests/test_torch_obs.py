"""The port's observatory held against the JAX package's.

``repro_torch.obs`` is the reference's ``repro.obs``: the windowed series
and metrics bus, the burn-rate SLO engine, the scorecard and the
``Observatory`` that wires them over the fleet's ``RetuneQueue``.  The
reference's ``tests/test_obs.py`` runs here by name (series, bus, replay,
SLO transitions acting on the ledger and the queue, the scorecard's rows,
the Observatory's install contract).  Then a ledger written by the JAX
package's closed telemetry loop is replayed into both packages: the same
bus snapshot and Prometheus text byte for byte, and, through
``replay_ledgers`` with ``default_rules()`` and a queue each, the same SLO
alerts, scorecard rows, queue state and ``snapshot()``.
"""

import json
import threading
import time

import pytest

import repro.obs.series as ref_series
from repro.core import V5eSimulator
from repro.core import matmul_spec as ref_matmul_spec
from repro.core.driver import ChoiceEvent as RefChoiceEvent
from repro.core.driver import registry as ref_registry
from repro.search import SearchBudget as RefSearchBudget
from repro.telemetry import Telemetry as RefTelemetry
from repro.telemetry import TelemetryConfig as RefTelemetryConfig

import repro.fleet as ref_fleet
import repro.obs as ref_obs

from repro_torch.core import HopperModel, matmul_spec
from repro_torch.fleet import RetuneQueue
from repro_torch.obs import (GaugeRule, MetricsBus, Observatory, RatioRule,
                             SLOEngine, WindowedCounter, WindowedGauge,
                             WindowedHistogram, default_rules,
                             get_metrics_bus, label_str, parse_label_str,
                             replay_into, replay_ledgers, set_metrics_bus)
from repro_torch.telemetry import Telemetry
from repro_torch.trace import Ledger, merge_ledgers, read_ledger

W = 10 ** 9          # 1 s windows everywhere below
T0 = 1_000_000 * W   # an arbitrary wall epoch, far from zero


@pytest.fixture(autouse=True)
def no_ambient_bus():
    set_metrics_bus(None)
    yield
    set_metrics_bus(None)


# -- windowed series primitives -----------------------------------------------

def test_counter_rotation_and_rate():
    c = WindowedCounter(W, n_windows=5)
    for i in range(8):
        c.add(T0 + i * W, 2.0)
    assert c.total == 16.0
    assert sorted(c.windows) == [T0 // W + i for i in range(3, 8)]
    now = T0 + 8 * W - 1
    assert c.sum_over(now, 3 * W) == 6.0
    assert c.rate(now, 3 * W) == pytest.approx(2.0)


def test_empty_window_queries():
    now = T0
    c = WindowedCounter(W, 5)
    g = WindowedGauge(W, 5)
    h = WindowedHistogram(W, 5)
    assert c.sum_over(now, 3 * W) == 0.0
    assert c.rate(now, 3 * W) == 0.0
    assert g.last_over(now, 3 * W) is None
    assert h.quantile(0.5) is None
    assert h.quantile_over(now, 3 * W, 0.5) is None
    c.add(T0, 1.0)
    g.set(T0, 4.0)
    h.add(T0, 1e-3)
    later = T0 + 100 * W
    assert c.sum_over(later, 3 * W) == 0.0
    assert g.last_over(later, 3 * W) is None
    assert h.quantile_over(later, 3 * W, 0.5) is None


def test_clock_step_backward_lands_in_retained_window():
    c = WindowedCounter(W, n_windows=10)
    c.add(T0 + 5 * W)
    c.add(T0)
    assert c.total == 2.0
    assert c.windows[T0 // W] == 1.0
    assert c.sum_over(T0 + 5 * W, 6 * W) == 2.0


def test_clock_step_forward_retires_history():
    c = WindowedCounter(W, n_windows=4)
    for i in range(4):
        c.add(T0 + i * W)
    c.add(T0 + 1000 * W)
    assert c.total == 5.0
    assert list(c.windows) == [T0 // W + 1000]


def test_gauge_ewma_and_window_last():
    g = WindowedGauge(W, 10, alpha=0.5)
    g.set(T0, 1.0)
    g.set(T0, 3.0)
    g.set(T0 + W, 5.0)
    assert g.last == 5.0
    assert g.ewma == pytest.approx(0.5 * 5 + 0.5 * (0.5 * 3 + 0.5 * 1))
    assert g.last_over(T0 + W, 2 * W) == 5.0
    assert g.last_over(T0, W) == 3.0


def test_histogram_quantiles_deterministic():
    h = WindowedHistogram(W, 10)
    for v in (2e-4, 3e-4, 5e-4, 2e-3):
        h.add(T0, v)
    assert h.count == 4
    p50 = h.quantile(0.50)
    assert 1e-4 < p50 <= 1e-3
    h2 = WindowedHistogram(W, 10)
    for v in (2e-4, 3e-4, 5e-4, 2e-3):
        h2.add(T0, v)
    assert h2.quantile(0.50) == p50
    assert h.quantile_over(T0, W, 0.50) == p50


def test_histogram_merge_disjoint_windows_and_bounds_mismatch():
    a = WindowedHistogram(W, 100)
    b = WindowedHistogram(W, 100)
    a.add(T0, 1e-4)
    b.add(T0 + 50 * W, 1e-2)
    a.merge(b)
    assert a.count == 2
    assert sorted(a.windows) == [T0 // W, T0 // W + 50]
    assert a.quantile_over(T0 + 50 * W, 60 * W, 0.99) > 1e-3
    assert a.quantile_over(T0, W, 0.99) <= 1e-3
    c = WindowedHistogram(W, 100)
    c.add(T0, 1e-4)
    a.merge(c)
    assert a.windows[T0 // W][a._bucket_of(1e-4)] == 2
    with pytest.raises(ValueError):
        a.merge(WindowedHistogram(W, 100, bounds_s=(1.0, 2.0)))


def test_concurrent_shard_writes_vs_exporter_merges():
    n_threads, n_each = 4, 3000
    shards = [WindowedHistogram(W, 600) for _ in range(n_threads)]
    stop = threading.Event()
    errors = []

    def writer(shard, seed):
        for i in range(n_each):
            shard.add(T0 + (i % 120) * W, (1 + seed) * 1e-5)

    def reader():
        while not stop.is_set():
            try:
                merged = WindowedHistogram(W, 600)
                for s in shards:
                    merged.merge(s)
                merged.quantile(0.95)
                merged.quantile_over(T0 + 119 * W, 60 * W, 0.5)
            except Exception as e:     # pragma: no cover - the failure mode
                errors.append(e)
                return

    threads = [threading.Thread(target=writer, args=(s, i))
               for i, s in enumerate(shards)]
    r = threading.Thread(target=reader)
    r.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stop.set()
    r.join()
    assert errors == []
    final = WindowedHistogram(W, 600)
    for s in shards:
        final.merge(s)
    assert final.count == n_threads * n_each


def test_concurrent_bus_ingest_vs_snapshot_reads():
    bus = MetricsBus(window_s=1.0, n_windows=600)
    stop = threading.Event()
    errors = []

    def writer(k):
        for i in range(2000):
            bus.ingest({"type": "choice", "kernel": f"k{k}",
                        "source": "plan", "wall_ns": T0 + (i % 60) * W})

    def reader():
        while not stop.is_set():
            try:
                bus.snapshot()
                bus.prometheus()
            except Exception as e:     # pragma: no cover
                errors.append(e)
                return

    threads = [threading.Thread(target=writer, args=(k,)) for k in range(4)]
    r = threading.Thread(target=reader)
    r.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stop.set()
    r.join()
    assert errors == []
    assert bus.counter("choices", {"source": "plan"}).total == 8000


# -- label keys ---------------------------------------------------------------

def test_label_round_trip_with_comma_valued_bucket():
    labels = {"kernel": "flash", "hw": "h100", "bucket": "bh5,skv7,sq7"}
    assert parse_label_str(label_str(labels)) == labels
    assert parse_label_str("") == {}


def test_sum_counters_matches_comma_valued_label():
    bus = MetricsBus()
    bus.counter("x", {"bucket": "a,b,c", "kernel": "mm"}).add(T0, 3.0)
    bus.counter("x", {"bucket": "d", "kernel": "mm"}).add(T0, 1.0)
    assert bus.sum_counters("x", T0, W, bucket="a,b,c") == 3.0
    assert bus.sum_counters("x", T0, W, kernel="mm") == 4.0
    assert bus.sum_counters("x", T0, W, kernel="nope") == 0.0


# -- bus routing and anchors --------------------------------------------------

def test_bus_routes_and_anchor_alignment():
    bus = MetricsBus()
    bus.ingest({"type": "session", "pid": 1, "wall_ns": T0, "mono_ns": 0})
    bus.ingest({"type": "choice", "kernel": "mm", "source": "plan",
                "n_coalesced": 4, "t_ns": 3 * W})
    assert bus.last_wall_ns == T0 + 3 * W
    assert bus.counter("choices", {"source": "plan"}).total == 4.0
    assert bus.counter("launches", {"kernel": "mm"}).total == 4.0
    assert bus.counter("fallback").total == 0.0
    bus.ingest({"type": "choice", "kernel": "mm", "source": "default",
                "t_ns": 5 * W, "wall_ns": T0 + 9 * W})
    assert bus.last_wall_ns == T0 + 9 * W
    assert bus.counter("fallback").total == 1.0
    assert bus.wall_ns_of({"t_ns": bus.mono_ns_of_wall(T0 + 7 * W)}) \
        == T0 + 7 * W


def test_bus_routes_every_event_type():
    bus = MetricsBus()
    t = {"wall_ns": T0}
    bus.ingest({"type": "probe", "kernel": "mm", "hw": "h100", "bucket": "b",
                "rel_error_ewma": 0.12, **t})
    bus.ingest({"type": "drift", "kernel": "mm", **t})
    bus.ingest({"type": "refit", "succeeded": True, "wall_seconds": 2.0,
                "total_device_seconds": 0.5, **t})
    bus.ingest({"type": "alert", "slo": "s", "state": "breach", **t})
    bus.ingest({"type": "bucket_step", "hit": False, "waste": 0.4,
                "kernel": "mm", **t})
    bus.ingest({"type": "span", "name": "decode", "dur_s": 1e-3, **t})
    snap = bus.snapshot()
    assert snap["n_events"] == 6
    assert bus.counter("probes", {"kernel": "mm"}).total == 1.0
    assert bus.gauge("rel_error_ewma", {"kernel": "mm", "hw": "h100",
                                        "bucket": "b"}).last == 0.12
    assert bus.counter("drift_events", {"kernel": "mm"}).total == 1.0
    assert bus.counter("refits", {"outcome": "ok"}).total == 1.0
    assert bus.histogram("refit_wall_s").count == 1
    assert bus.counter("alerts", {"slo": "s", "state": "breach"}).total == 1.0
    assert bus.counter("bucket_steps", {"kernel": "mm",
                                        "outcome": "miss"}).total == 1.0
    assert bus.counter("padding_waste_sum",
                       {"kernel": "mm"}).total == pytest.approx(0.4)
    assert bus.histogram("span_duration_s", {"name": "decode"}).count == 1


def test_prometheus_exposition_shape():
    bus = MetricsBus()
    bus.ingest({"type": "choice", "kernel": 'm"m', "source": "plan",
                "wall_ns": T0})
    bus.ingest({"type": "span", "name": "step", "dur_s": 5e-4,
                "wall_ns": T0})
    text = bus.prometheus()
    assert '# TYPE klaraptor_obs_choices_total counter' in text
    assert 'kernel="m\\"m"' in text
    assert 'le="+Inf"' in text
    assert text.count("span_duration_s_bucket") == 9


# -- replay: bit identity and cross-process merge order -----------------------

def _emit_demo_run(tmp_path, name="run.jsonl"):
    """Forty choices and eight probes into a ledger and a live bus fed the
    ledger's session anchor first (as the reference's ``Observatory``)."""
    led = Ledger(tmp_path / name)
    bus = MetricsBus()
    bus.ingest({"type": "session", "pid": 0, **led.anchor})
    for i in range(40):
        t = i * W
        ev = {"type": "choice", "kernel": "mm", "hw": "h100_sxm_cc90",
              "D": {"m": 512, "n": 512, "k": 512},
              "config": {"bm": 128, "bn": 128, "bk": 64},
              "source": "plan" if i % 4 else "default",
              "predicted_s": 1e-4, "n_coalesced": 2, "t_ns": t}
        led.append(ev)
        bus.ingest(ev)
        if i % 5 == 0:
            ev = {"type": "probe", "kernel": "mm", "hw": "h100_sxm_cc90",
                  "bucket": "m9,n9,k9", "predicted_s": 1e-4,
                  "observed_s": 1e-4 * (2.5 if i >= 20 else 1.05),
                  "rel_error_ewma": 1.5 if i >= 20 else 0.05, "t_ns": t}
            led.append(ev)
            bus.ingest(ev)
    led.close()
    return bus


def test_single_ledger_replay_is_bit_identical(tmp_path):
    live = _emit_demo_run(tmp_path)
    replayed = MetricsBus()
    replay_into(replayed, tmp_path / "run.jsonl")
    assert live.snapshot_json() == replayed.snapshot_json()
    assert live.prometheus() == replayed.prometheus()


def test_cross_process_merge_ordering(tmp_path):
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    with open(a, "w") as f:
        f.write(json.dumps({"type": "session", "pid": 1,
                            "wall_ns": T0, "mono_ns": 7_000 * W}) + "\n")
        for i in (0, 2, 4):
            f.write(json.dumps({"type": "choice", "kernel": f"a{i}",
                                "source": "plan",
                                "t_ns": 7_000 * W + i * W}) + "\n")
    with open(b, "w") as f:
        f.write(json.dumps({"type": "session", "pid": 2,
                            "wall_ns": T0 + W, "mono_ns": 3 * W}) + "\n")
        for i in (0, 2):
            f.write(json.dumps({"type": "choice", "kernel": f"b{i}",
                                "source": "plan",
                                "t_ns": 3 * W + i * W}) + "\n")
    merged = [e for e in merge_ledgers([a, b]) if e["type"] == "choice"]
    assert [e["kernel"] for e in merged] == ["a0", "b0", "a2", "b2", "a4"]
    assert [e["wall_ns"] for e in merged] == [T0 + i * W for i in range(5)]
    bus = MetricsBus()
    replay_into(bus, [a, b])
    c = bus.counter("choices", {"source": "plan"})
    assert {i - T0 // W for i in c.windows} == {0, 1, 2, 3, 4}


def test_replay_strict_flag_propagates(tmp_path):
    p = tmp_path / "bad.jsonl"
    with open(p, "w") as f:
        f.write('{"type": "choice", "source": "plan"}\n')
        f.write("{torn")
        f.write("\n")
        f.write('{"type": "choice", "source": "plan"}\n')
    bus = MetricsBus()
    assert replay_into(bus, p) == 2
    with pytest.raises(ValueError):
        replay_into(MetricsBus(), p, strict=True)


def test_telemetry_note_bucket_step_reaches_bus_without_ledger():
    tel = Telemetry([matmul_spec(4)], HopperModel(), cache=False)
    obs = Observatory()
    with obs:
        tel.note_bucket_step(True, 0.25, kernel="mm")
    tel.note_bucket_step(True, 0.25, kernel="mm")   # bus gone: no ingest
    assert get_metrics_bus() is None
    assert obs.bus.counter("bucket_steps",
                           {"kernel": "mm", "outcome": "hit"}).total == 1.0
    assert tel.exporter.snapshot()["counters"]["bucket_hits"] == 2


# -- SLO engine ---------------------------------------------------------------

def _burnable_bus(frac_default=0.2, n=50):
    bus = MetricsBus()
    bus.ingest({"type": "session", "pid": 1, "wall_ns": T0, "mono_ns": 0})
    n_def = int(n * frac_default)
    for i in range(n):
        bus.ingest({"type": "choice", "kernel": "mm", "source":
                    "default" if i < n_def else "plan", "t_ns": i * W // 4})
    return bus


def test_slo_breach_fires_once_and_resolves():
    engine = SLOEngine(rules=[RatioRule(
        name="fallback_rate", objective=0.02,
        num=("choices", {"source": "default"}), den=("choices", {}))])
    bus = _burnable_bus(frac_default=0.2)
    alerts = engine.evaluate(bus)
    assert [a.state for a in alerts] == ["breach"]
    assert alerts[0].burn_fast >= 2.0 and alerts[0].burn_slow >= 1.0
    # sustained breach: no new transition on the next tick
    assert engine.evaluate(bus) == []
    assert ("fallback_rate", "") in engine.firing
    # the bad window ages out of both windows -> resolve transition
    later = bus.last_wall_ns + 1_000 * W
    bus.ingest({"type": "choice", "kernel": "mm", "source": "plan",
                "wall_ns": later})
    resolved = engine.evaluate(bus, now_ns=later)
    assert [a.state for a in resolved] == ["resolve"]
    assert engine.firing == {}


def test_slo_fast_window_gate_blocks_stale_breach():
    """Burn in the slow window only (the incident is over) must not page."""
    engine = SLOEngine(rules=[RatioRule(
        name="fallback_rate", objective=0.02,
        num=("choices", {"source": "default"}), den=("choices", {}))])
    bus = MetricsBus()
    bus.ingest({"type": "session", "pid": 1, "wall_ns": T0, "mono_ns": 0})
    for i in range(20):    # all defaults, but 100+ seconds ago
        bus.ingest({"type": "choice", "source": "default",
                    "wall_ns": T0 + i * W})
    now = T0 + 200 * W
    for i in range(20):    # recent traffic is clean
        bus.ingest({"type": "choice", "source": "plan",
                    "wall_ns": now - 20 * W + i * W})
    assert engine.evaluate(bus, now_ns=now) == []


def test_slo_alert_lands_in_ledger_and_enqueues_retune(tmp_path):
    led = Ledger(tmp_path / "slo.jsonl")
    q = RetuneQueue(tmp_path / "q.json")
    rule = GaugeRule(name="drift_ewma", objective=0.25,
                     gauge="rel_error_ewma", retune=True, retune_boost=1e3)
    engine = SLOEngine(rules=[rule], ledger=led, queue=q,
                       enrich=lambda key: {"D": {"m": 64}})
    bus = MetricsBus()
    bus.ingest({"type": "session", "pid": 1, "wall_ns": T0, "mono_ns": 0})
    bus.ingest({"type": "probe", "kernel": "mm", "hw": "h100_sxm_cc90",
                "bucket": "b1,b2", "rel_error_ewma": 2.0, "t_ns": 0})
    alerts = engine.evaluate(bus)
    led.close()
    assert len(alerts) == 1 and alerts[0].state == "breach"
    # the alert line is in the ledger AND was ingested back into the bus
    events = read_ledger(tmp_path / "slo.jsonl")
    ledger_alerts = [e for e in events if e["type"] == "alert"]
    assert len(ledger_alerts) == 1
    assert ledger_alerts[0]["key"] == {"kernel": "mm", "hw": "h100_sxm_cc90",
                                       "bucket": "b1,b2"}
    assert bus.counter("alerts", {"slo": "drift_ewma",
                                  "state": "breach"}).total == 1.0
    # the breached key is pending in the retune queue, boosted and enriched
    pend = q.pending()
    assert len(pend) == 1
    key, ev = pend[0]
    assert key == "mm|h100_sxm_cc90|b1,b2"
    assert ev["slo"] == "drift_ewma" and ev["D"] == {"m": 64}
    assert q.state["pending"][key]["boost"] == 1e3


def test_default_rules_cover_the_documented_invariants():
    names = {r.name for r in default_rules()}
    assert names == {"fallback_rate", "bucket_miss_rate", "padding_waste",
                     "drift_ewma", "refit_latency"}
    waste = next(r for r in default_rules() if r.name == "padding_waste")
    assert waste.retune and waste.group_by == ("kernel",)


# -- scorecard ----------------------------------------------------------------

def test_scorecard_ratio_refit_and_enrich():
    bus = MetricsBus()
    obs = Observatory()
    obs.bus = bus     # not installed; just wiring the subscriber
    card = obs.scorecard
    card.attach(bus)
    t = {"wall_ns": T0}
    bus.ingest({"type": "choice", "kernel": "mm", "hw": "h100_sxm_cc90",
                "D": {"m": 512, "n": 512, "k": 512},
                "config": {"bm": 128}, "n_coalesced": 3, **t})
    for obs_s in (1.1e-4, 1.2e-4, 3.0e-4):
        bus.ingest({"type": "probe", "kernel": "mm", "hw": "h100_sxm_cc90",
                    "bucket": "k9,m9,n9", "predicted_s": 1e-4,
                    "observed_s": obs_s, "rel_error_ewma": 0.3, **t})
    row = card.rows["mm|h100_sxm_cc90|k9,m9,n9"]
    assert row.probes == 3
    cal = row.calibration()
    assert cal["p50"] == pytest.approx(1.2)
    assert card.within_slo(row) is True
    # enrichment resolves a coarse (kernel-only) key to the busiest row
    extra = card.enrich({"kernel": "mm"})
    assert extra["hw"] == "h100_sxm_cc90" and extra["bucket"] == "k9,m9,n9"
    assert extra["observed_s"] == pytest.approx(3.0e-4)
    # a successful refit wipes the ring and stamps the version
    bus.ingest({"type": "refit", "kernel": "mm", "succeeded": True,
                "cache_version": 7, **t})
    assert len(row.ratios) == 0 and row.tuning_version == 7
    assert card.within_slo(row) is None
    # corpus rows carry the full labeled example
    rows = card.corpus_rows()
    assert len(rows) == 3
    assert rows[0]["config"] == {"bm": 128}
    text = card.render_text()
    assert "mm" in text and "ratio p50" in text


def test_scorecard_corpus_write(tmp_path):
    bus = MetricsBus()
    from repro_torch.obs import Scorecard
    card = Scorecard().attach(bus)
    bus.ingest({"type": "probe", "kernel": "mm", "hw": "h100_sxm_cc90",
                "bucket": "b", "predicted_s": 1e-4, "observed_s": 2e-4,
                "wall_ns": T0})
    p = tmp_path / "corpus.jsonl"
    assert card.write_corpus(p) == 1
    row = json.loads(p.read_text().strip())
    assert row["observed_s"] == 2e-4 and row["tuning_version"] is None


# -- observatory lifecycle ----------------------------------------------------

def test_observatory_install_uninstall_and_zero_cost_default():
    assert get_metrics_bus() is None
    obs = Observatory()
    with obs:
        assert get_metrics_bus() is obs.bus
    assert get_metrics_bus() is None
    # installing a second observatory then uninstalling the first must not
    # tear down the second's bus
    o1, o2 = Observatory(), Observatory()
    o1.install()
    o2.install()
    o1.uninstall()
    assert get_metrics_bus() is o2.bus
    o2.uninstall()


def test_observatory_counts_session_header_like_replay(tmp_path):
    led = Ledger(tmp_path / "x.jsonl")
    obs = Observatory(ledger=led)
    led.close()
    # live bus saw exactly the one event replay will read back
    assert obs.bus.n_events == 1
    replayed = replay_ledgers(tmp_path / "x.jsonl")
    assert obs.bus.snapshot_json() == replayed.bus.snapshot_json()


def test_observatory_sinks_the_tracers_spans(tmp_path):
    """``install()`` makes the bus the tracer's span sink, ``uninstall()``
    detaches it: spans reach the bus only while installed."""
    from repro_torch.trace import Tracer, trace_span

    with Tracer() as tracer:
        obs = Observatory().install()
        with trace_span("fleet.tune", kernels=["mm"]):
            pass
        assert tracer.span_sink == obs.bus.ingest
        obs.uninstall()
        assert tracer.span_sink is None
        with trace_span("fleet.tune"):
            pass
    spans = obs.bus.snapshot()["histograms"]
    assert obs.bus.n_events == 1 and spans


# -- a JAX-written ledger replayed into both packages -------------------------

def test_reference_ledger_replays_identically_in_both_packages(
        tmp_path, monkeypatch):
    """The JAX package's telemetry loop (v5e simulator, refit on) writes a
    ledger with choices, probes, a drift and a refit; replayed into both
    packages' buses it gives the same snapshot and exposition."""
    monkeypatch.setenv("KLARAPTOR_CACHE_DIR", str(tmp_path / "cache"))
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
    types = {json.loads(line)["type"] for line in open(path)}
    assert {"session", "choice", "probe", "drift", "refit",
            "bucket_step"} <= types
    port, ref = MetricsBus(), ref_series.MetricsBus()
    assert replay_into(port, path) == ref_series.replay_into(ref, path)
    assert port.snapshot_json() == ref.snapshot_json()
    assert port.prometheus() == ref.prometheus()
    two = [path, path]
    port2, ref2 = MetricsBus(), ref_series.MetricsBus()
    replay_into(port2, two)
    ref_series.replay_into(ref2, two)
    assert port2.snapshot_json() == ref2.snapshot_json()


def test_observatory_over_a_reference_ledger_as_the_reference(
        tmp_path, monkeypatch):
    """``replay_ledgers`` of one ledger the reference's telemetry loop
    wrote, with ``default_rules()`` and a retune queue in each package:
    one SLO evaluation gives the same alerts (ledger-ready events), the
    same boosted keys in the queue, the same scorecard rows and text, and
    the same ``snapshot()``."""
    monkeypatch.setenv("KLARAPTOR_CACHE_DIR", str(tmp_path / "cache"))
    path = tmp_path / "ref.jsonl"
    cfg = RefTelemetryConfig(probe_every=1, min_samples=2,
                             drift_threshold=0.2, ewma_alpha=1.0,
                             refit_budget=RefSearchBudget(max_executions=24),
                             refit_repeats=1, refit_max_configs_per_size=4,
                             refit_enabled=False)
    tel = RefTelemetry([ref_matmul_spec()], V5eSimulator(seed=3), config=cfg,
                       cache=False, ledger=str(path))
    D = {"m": 1024, "n": 1024, "k": 1024}
    try:
        for i in range(6):
            tel._on_choice(RefChoiceEvent(
                kernel="matmul_b16", D=dict(D),
                config={"bm": 128, "bn": 512, "bk": 512},
                source="default" if i % 3 == 0 else "driver",
                predicted_s=1e-9, hw_name="tpu_v5e", n_coalesced=1 + i,
                t_ns=time.monotonic_ns()))
        for i in range(4):
            tel.note_bucket_step(i % 2 == 0, 0.6, kernel="matmul_b16")
    finally:
        tel.ledger.close()
        ref_registry.clear()
    types = {json.loads(line)["type"] for line in open(path)}
    assert {"choice", "probe", "drift", "bucket_step"} <= types
    port_q = RetuneQueue(tmp_path / "port_q.json")
    ref_q = ref_fleet.RetuneQueue(tmp_path / "ref_q.json")
    port = replay_ledgers([path], rules=default_rules(), queue=port_q)
    ref = ref_obs.replay_ledgers([path], rules=ref_obs.default_rules(),
                                 queue=ref_q)
    port_alerts = [a.to_event() for a in port.evaluate()]
    ref_alerts = [a.to_event() for a in ref.evaluate()]
    assert port_alerts == ref_alerts
    assert {a["slo"] for a in port_alerts} >= {"drift_ewma",
                                               "fallback_rate"}
    assert port_q.state == ref_q.state and port_q.pending()
    assert port.scorecard.as_rows() == ref.scorecard.as_rows()
    assert port.scorecard.render_text() == ref.scorecard.render_text()
    assert port.scorecard.corpus_rows() == ref.scorecard.corpus_rows()
    assert port.snapshot() == ref.snapshot()
    assert port.prometheus() == ref.prometheus()
    # a second tick transitions nothing, in both
    assert port.evaluate() == [] and ref.evaluate() == []
