"""The port's tracing held against the JAX package's.

``repro_torch.trace`` is the reference's ``repro.trace`` (stdlib only):
spans with thread-local nesting that cost one ``is None`` test when no
tracer is installed, the flight-recorder ring with per-name histograms,
Chrome trace-event export and the JSONL flight ledger.  The reference's
``tests/test_trace.py`` runs here by name, ``TestStatusCLI`` with the
port's ``launch/status.py``, on the f32 matmul (``matmul_spec(4)``) under
``HopperModel``.  Then the two packages are held against each other: the
same spans under the same clock readings give the same Chrome trace, the
same events the same ledger lines, a driver build and a refit the same
span trees, a ledger the same status text; and every span the reference
opens is opened by the port.
"""

import json
import re
import threading
from pathlib import Path

import pytest

import repro.trace as ref_trace
import repro.trace.ledger as ref_ledger_mod
import repro.trace.span as ref_span_mod
from repro.core import Klaraptor as RefKlaraptor
from repro.core import V5E, V5eSimulator
from repro.core import matmul_spec as ref_matmul_spec
from repro.search import SearchBudget as RefSearchBudget
from repro.telemetry import RefitController as RefRefitController
from repro.telemetry import TelemetryConfig as RefTelemetryConfig
from repro.telemetry import shape_bucket as ref_shape_bucket
from repro.telemetry.drift import DriftEvent as RefDriftEvent

import repro_torch.trace.ledger as port_ledger_mod
import repro_torch.trace.span as port_span_mod
from repro_torch.core import H100, HopperModel, Klaraptor, matmul_spec, \
    registry
from repro_torch.core.driver import (ChoiceEvent, choose_or_default,
                                     set_choice_listener)
from repro_torch.search import SearchBudget
from repro_torch.telemetry import (RefitController, Telemetry,
                                   TelemetryConfig, shape_bucket)
from repro_torch.telemetry.drift import DriftEvent
from repro_torch.trace import (HISTOGRAM_BOUNDS_S, Ledger, NULL_SPAN, Tracer,
                               chrome_trace, get_tracer, ledger_summary,
                               read_ledger, set_tracer, trace_span, traced,
                               tracing)

D_SMALL = {"m": 1024, "n": 1024, "k": 1024}
# A feasible f32 SIMT tile that no tuned driver takes at 1024^3.
MM_DEFAULT = {"bm": 32, "bn": 32, "bk": 8}
KERNEL = "matmul_b32"
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def no_ambient_tracer():
    """Every test starts and ends with tracing off, in both packages."""
    set_tracer(None)
    ref_trace.set_tracer(None)
    yield
    set_tracer(None)
    ref_trace.set_tracer(None)


@pytest.fixture()
def clean(tmp_path, monkeypatch):
    monkeypatch.setenv("KLARAPTOR_CACHE_DIR", str(tmp_path / "cache"))
    registry.clear()
    set_choice_listener(None)
    yield str(tmp_path / "cache")
    set_choice_listener(None)
    registry.clear()


class TestSpans:
    def test_disabled_is_shared_noop(self):
        assert get_tracer() is None and not tracing()
        s = trace_span("anything", k=1)
        assert s is NULL_SPAN and trace_span("other") is s
        with s as inner:
            assert inner.set(a=1) is inner

    def test_traced_decorator_disabled_is_passthrough(self):
        @traced("f")
        def f(x):
            return x + 1
        assert f(1) == 2
        with Tracer() as tr:
            assert f(2) == 3
        assert [s.name for s in tr.spans()] == ["f"]

    def test_nesting_depth_attrs_and_order(self):
        with Tracer() as tr:
            with trace_span("outer", kernel="mm") as o:
                with trace_span("inner"):
                    pass
                o.set(result=7)
        inner, outer = tr.spans()
        assert (outer.name, outer.depth) == ("outer", 0)
        assert (inner.name, inner.depth) == ("inner", 1)
        assert outer.attrs == {"kernel": "mm", "result": 7}
        assert outer.t0_ns <= inner.t0_ns <= inner.t1_ns <= outer.t1_ns

    def test_exception_closes_span_and_marks_error(self):
        with Tracer() as tr:
            with pytest.raises(ValueError):
                with trace_span("boom"):
                    raise ValueError("x")
            with trace_span("after"):
                pass
        boom, after = tr.spans()
        assert boom.attrs["error"] == "ValueError"
        assert after.depth == 0

    def test_ring_is_bounded_but_counts_everything(self):
        with Tracer(capacity=4) as tr:
            for i in range(10):
                with trace_span(f"s{i}"):
                    pass
        assert tr.n_spans == 10
        assert [s.name for s in tr.spans()] == ["s6", "s7", "s8", "s9"]
        assert sum(h["count"] for h in tr.histograms().values()) == 10

    def test_threads_get_independent_stacks(self):
        barrier = threading.Barrier(4)
        with Tracer() as tr:
            def work(tag):
                barrier.wait()
                with trace_span("outer", tag=tag):
                    with trace_span("inner", tag=tag):
                        pass
            threads = [threading.Thread(target=work, args=(i,), name=f"w{i}")
                       for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        spans = tr.spans()
        assert len(spans) == 8
        by_thread = {}
        for s in spans:
            by_thread.setdefault(s.thread_name, []).append(s)
        assert set(by_thread) == {f"w{i}" for i in range(4)}
        for group in by_thread.values():
            assert sorted(s.depth for s in group) == [0, 1]
            assert all(s.tid for s in group)

    def test_summary_ranked_by_cumulative_time(self):
        with Tracer() as tr:
            for _ in range(3):
                with trace_span("cheap"):
                    pass
            with trace_span("dear"):
                sum(range(20000))
        rows = tr.summary()
        assert [r["name"] for r in rows] == ["dear", "cheap"]
        assert rows[1]["count"] == 3
        assert rows[0]["max_s"] >= rows[0]["mean_s"] > 0


class TestChromeExport:
    def test_chrome_trace_schema_and_containment(self, tmp_path):
        with Tracer() as tr:
            with trace_span("parent", kernel="mm", cfg={"bm": 128}):
                with trace_span("child", obj=object()):
                    pass
        payload = json.loads(json.dumps(tr.chrome_trace()))
        events = payload["traceEvents"]
        meta = [e for e in events if e["ph"] == "M"]
        assert {m["name"] for m in meta} >= {"process_name", "thread_name"}
        xs = {e["name"]: e for e in events if e["ph"] == "X"}
        assert set(xs) == {"parent", "child"}
        for e in xs.values():
            assert e["ts"] >= 0 and e["dur"] >= 0
            assert isinstance(e["pid"], int) and isinstance(e["tid"], int)
        p, c = xs["parent"], xs["child"]
        assert p["ts"] <= c["ts"]
        assert c["ts"] + c["dur"] <= p["ts"] + p["dur"] + 1e-3
        assert p["args"]["cfg"] == {"bm": 128}
        out = tmp_path / "trace.json"
        assert tr.write_chrome_trace(out) == 2
        assert json.loads(out.read_text())["traceEvents"]


class TestHistogramsAndPrometheus:
    def test_bucket_counts(self):
        from repro_torch.trace import SpanHistogram
        h = SpanHistogram()
        h.add(500)
        h.add(5_000_000)
        h.add(int(20e9))
        assert h.counts[0] == 1 and h.counts[-1] == 1
        assert h.count == 3 and h.max_ns == int(20e9)

    def test_prometheus_span_histogram_lines(self, clean):
        tel = Telemetry({}, HopperModel())
        with Tracer():
            for _ in range(4):
                with trace_span("fit"):
                    pass
            text = tel.prometheus()
        assert "# TYPE klaraptor_span_duration_seconds histogram" in text
        buckets = [int(line.rsplit(" ", 1)[1])
                   for line in text.splitlines()
                   if line.startswith("klaraptor_span_duration_seconds_bucket"
                                      '{span="fit"')]
        assert len(buckets) == len(HISTOGRAM_BOUNDS_S) + 1
        assert buckets == sorted(buckets)
        assert buckets[-1] == 4
        assert 'le="+Inf"' in text
        assert 'klaraptor_span_duration_seconds_count{span="fit"} 4' in text

    def test_prometheus_without_tracer_has_no_span_section(self, clean):
        tel = Telemetry({}, HopperModel())
        assert "span_duration_seconds" not in tel.prometheus()
        assert "spans" not in tel.snapshot()

    def test_label_escaping_regression(self, clean):
        evil = 'mm"42\\x'
        tel = Telemetry({}, HopperModel()).install()
        try:
            choose_or_default(evil, {"m": 8}, MM_DEFAULT)
        finally:
            tel.uninstall()
        text = tel.prometheus()
        line = next(ln for ln in text.splitlines()
                    if ln.startswith("klaraptor_key_choices_total"))
        assert '\\"' in line and "\\\\" in line
        assert evil not in line
        assert tel.snapshot()["keys"][0]["kernel"] == evil


class TestChoiceEventTimestamp:
    def test_t_ns_stamped_when_listener_installed(self, clean):
        seen = []
        set_choice_listener(seen.append)
        choose_or_default(KERNEL, D_SMALL, MM_DEFAULT)
        assert seen and seen[0].t_ns is not None and seen[0].t_ns > 0
        assert ChoiceEvent(kernel="k", D={}, config={}, source="default",
                           predicted_s=None, hw_name=H100.name).t_ns is None


class TestRegistryGauges:
    def test_generation_memo_and_invalidation_gauges(self, clean):
        tel = Telemetry({}, HopperModel()).install()
        try:
            registry.note_override(KERNEL, H100.name, D_SMALL, MM_DEFAULT)
            snap0 = tel.snapshot()
            assert snap0["gauges"]["decision_memo_entries"] == 0
            choose_or_default(KERNEL, D_SMALL, MM_DEFAULT)
            snap1 = tel.snapshot()
            assert snap1["gauges"]["decision_memo_entries"] == 1
            registry.invalidate_kernel(KERNEL)
            snap2 = tel.snapshot()
            assert snap2["gauges"]["registry_generation"] > \
                snap1["gauges"]["registry_generation"]
            assert snap2["gauges"]["decision_memo_entries"] == 0
            assert snap2["counters"]["memo_invalidations"] == \
                snap1["counters"]["memo_invalidations"] + 1
        finally:
            tel.uninstall()
        text = tel.prometheus()
        assert "# TYPE klaraptor_registry_generation gauge" in text
        assert "# TYPE klaraptor_decision_memo_entries gauge" in text
        assert "# TYPE klaraptor_memo_invalidations counter" in text
        assert "# TYPE klaraptor_plan_invalidations counter" in text


def _run_telemetry_with_ledger(tmp_path, refit=False):
    """Drive the real loop (``HopperModel``) with a ledger attached."""
    path = tmp_path / "run.jsonl"
    cfg = TelemetryConfig(probe_every=1, min_samples=2, drift_threshold=0.2,
                          ewma_alpha=1.0, refit_enabled=refit,
                          refit_budget=SearchBudget(max_executions=24),
                          refit_repeats=1, refit_max_configs_per_size=4)
    tel = Telemetry([matmul_spec(4)], HopperModel(seed=3), config=cfg,
                    cache=False, ledger=str(path))
    tel.install()
    try:
        for _ in range(4):
            tel._on_choice(ChoiceEvent(
                kernel=KERNEL, D=dict(D_SMALL), config=dict(MM_DEFAULT),
                source="driver", predicted_s=1e-9, hw_name=H100.name))
    finally:
        tel.uninstall()
        tel.ledger.close()
    return tel, path


class TestLedger:
    def test_round_trip_matches_exporter(self, clean, tmp_path):
        tel, path = _run_telemetry_with_ledger(tmp_path)
        events = read_ledger(path)
        s = ledger_summary(events)
        snap = tel.snapshot()
        assert s["choices_total"] == snap["counters"]["choices_total"]
        assert s["by_type"]["probe"] == \
            snap["counters"]["shadow_probes_total"]
        assert len(s["drift_events"]) == \
            snap["counters"]["drift_events_total"] > 0
        assert s["kernels"][KERNEL]["by_source"]["driver"] == 4
        key = f"{KERNEL} {H100.name} " + \
            list(s["rel_error"])[0].split(" ", 2)[2]
        assert s["rel_error"][key]["probes"] == \
            snap["counters"]["shadow_probes_total"]
        assert s["rel_error"][key]["rel_error_ewma"] == pytest.approx(
            snap["keys"][0]["rel_error_ewma"])

    def test_refit_lines_and_torn_tail(self, clean, tmp_path):
        tel, path = _run_telemetry_with_ledger(tmp_path, refit=True)
        with open(path, "a") as f:
            f.write('{"type": "choice", "torn')
        events = read_ledger(path)
        s = ledger_summary(events)
        assert len(s["refits"]) == tel.counters.refits_total > 0
        extra = dict(next(e for e in events if e["type"] == "choice"))
        extra["n_coalesced"] = 64
        s2 = ledger_summary(events + [extra])
        assert s2["choices_total"] == s["choices_total"] + 64

    def test_mid_file_corruption_strict_vs_lenient(self, tmp_path):
        path = tmp_path / "bad.jsonl"
        path.write_text('{"type": "choice"}\nnot json\n{"type": "probe"}\n')
        events = read_ledger(path)
        assert [e["type"] for e in events] == ["choice", "probe"]
        with pytest.raises(json.JSONDecodeError):
            read_ledger(path, strict=True)
        path.write_text('{"type": "choice"}\n{"type": "torn')
        assert [e["type"] for e in read_ledger(path, strict=True)] == \
            ["choice"]

    def test_tracer_spans_reach_ledger(self, tmp_path):
        path = tmp_path / "spans.jsonl"
        with Ledger(path) as led:
            with Tracer(ledger=led):
                with trace_span("a", kernel="mm"):
                    with trace_span("b"):
                        pass
        events = read_ledger(path)
        assert events[0]["type"] == "session"
        assert {"wall_ns", "mono_ns", "pid"} <= set(events[0])
        spans = [e for e in events if e["type"] == "span"]
        assert [(e["name"], e["depth"]) for e in spans] == \
            [("b", 1), ("a", 0)]
        assert spans[1]["attrs"] == {"kernel": "mm"}
        assert ledger_summary(events)["spans"]["a"]["count"] == 1


def _drift(kernel, D, config, hw_name, event_cls, bucket):
    return event_cls(kernel=kernel, hw_name=hw_name, bucket=bucket(D),
                     D=dict(D), config=dict(config), rel_error_ewma=0.8,
                     n_samples=4, predicted_s=1e-9, observed_s=1e-3)


class TestRefitSpanTree:
    def test_refit_chain_is_one_causal_tree(self, clean):
        kl = Klaraptor(HopperModel(noise=0.02, seed=5), device="cpu",
                       cache=False)
        ctl = RefitController(
            kl, TelemetryConfig(refit_budget=SearchBudget(max_executions=32),
                                refit_repeats=1,
                                refit_max_configs_per_size=4))
        with Tracer() as tr:
            ctl.refit(matmul_spec(4), _drift(KERNEL, D_SMALL, MM_DEFAULT,
                                             H100.name, DriftEvent,
                                             shape_bucket))
        by_name = {s.name: s for s in tr.spans()}
        assert {"refit", "refit.search", "refit.fit", "refit.validate",
                "refit.swap"} <= set(by_name)
        parent = by_name["refit"]
        for child in ("refit.search", "refit.fit", "refit.validate",
                      "refit.swap"):
            s = by_name[child]
            assert s.depth == parent.depth + 1
            assert parent.t0_ns <= s.t0_ns <= s.t1_ns <= parent.t1_ns
        assert "succeeded" in parent.attrs
        assert "executions" in by_name["refit.search"].attrs


# -- the two packages side by side -------------------------------------------

def _patch_clocks(monkeypatch, *modules, start=10_000):
    """Give each module's span clock the same reading sequence."""
    for mod in modules:
        ticks = iter(range(start, start + 10_000, 7))
        monkeypatch.setattr(mod, "_monotonic_ns", lambda t=ticks: next(t))


def _record(trace_pkg):
    tr = trace_pkg.Tracer()
    with tr:
        with trace_pkg.trace_span("build_driver", kernel="mm"):
            with trace_pkg.trace_span("collect", n_batches=2,
                                      budget=None) as sp:
                with trace_pkg.trace_span("collect.batch",
                                          D={"m": 512}, batch_index=0):
                    pass
                sp.set(n_probe_executions=8, strategy={"name": "lhs"})
            with trace_pkg.trace_span("fit", n_samples=3):
                pass
    return tr


def test_chrome_trace_identical_to_reference(monkeypatch):
    import repro_torch.trace as port_trace
    _patch_clocks(monkeypatch, ref_span_mod, port_span_mod)
    ref = _record(ref_trace)
    port = _record(port_trace)
    assert chrome_trace(port.spans()) == ref_trace.chrome_trace(ref.spans())
    assert port.histograms() == ref.histograms()
    assert port.summary() == ref.summary()


def test_ledger_lines_identical_to_reference(tmp_path, monkeypatch):
    import repro_torch.trace as port_trace
    for mod in (ref_ledger_mod, port_ledger_mod):
        monkeypatch.setattr(mod.time, "time_ns", lambda: 1_700_000_000_123)
        monkeypatch.setattr(mod.time, "monotonic_ns", lambda: 42_000)
    _patch_clocks(monkeypatch, ref_span_mod, port_span_mod)
    events = [{"type": "choice", "kernel": "mm", "D": {"m": 1024, "k": 8},
               "config": {"bm": 64}, "source": "driver",
               "predicted_s": 1.5e-4, "n_coalesced": 3, "t_ns": 99},
              {"type": "probe", "kernel": "mm", "hw": "h", "bucket": "k3",
               "observed_s": 2e-4, "rel_error_ewma": 0.25, "t_ns": 100},
              {"type": "refit", "override": None, "error": None,
               "D": (1, 2), "t_ns": 101}]
    lines = {}
    for name, pkg in (("ref", ref_trace), ("port", port_trace)):
        path = tmp_path / f"{name}.jsonl"
        with pkg.Ledger(path) as led:
            for ev in events:
                led.append(dict(ev))
            with pkg.Tracer(ledger=led):
                with pkg.trace_span("engine.step", step_plan=True):
                    pass
        lines[name] = path.read_text()
    assert lines["port"] == lines["ref"]
    assert ledger_summary(read_ledger(tmp_path / "port.jsonl")) == \
        ref_trace.ledger_summary(
            ref_trace.read_ledger(tmp_path / "ref.jsonl"))


PROBE_DATA = [{"m": 256, "n": 256, "k": 256}, {"m": 512, "n": 512, "k": 512},
              {"m": 1024, "n": 1024, "k": 1024}]


def _tree(tracer):
    return [(s.name, s.depth) for s in tracer.spans()]


def test_build_driver_span_tree_matches_reference():
    """One driver build under a tracer in each package: the same spans,
    nested the same way, in the same order."""
    with ref_trace.Tracer() as ref:
        RefKlaraptor(V5eSimulator(noise=0.03, seed=5), cache=False
                     ).build_driver(ref_matmul_spec(), probe_data=PROBE_DATA,
                                    repeats=1, max_configs_per_size=4,
                                    register=False)
    with Tracer() as port:
        Klaraptor(HopperModel(noise=0.03, seed=5), device="cpu", cache=False
                  ).build_driver(matmul_spec(4), probe_data=PROBE_DATA,
                                 repeats=1, max_configs_per_size=4,
                                 register=False)
    assert _tree(port) == _tree(ref)
    assert sorted(n for n, _ in _tree(port)) == sorted(
        ["build_driver", "collect", "fit", "codegen"]
        + ["collect.batch"] * len(PROBE_DATA))
    for s_ref, s_port in zip(ref.spans(), port.spans()):
        assert set(s_port.attrs) == set(s_ref.attrs), s_port.name


def test_refit_span_tree_matches_reference(clean):
    import repro.core.driver as ref_driver
    try:
        with ref_trace.Tracer() as ref:
            RefRefitController(
                RefKlaraptor(V5eSimulator(noise=0.02, seed=5), cache=False),
                RefTelemetryConfig(
                    refit_budget=RefSearchBudget(max_executions=32),
                    refit_repeats=1, refit_max_configs_per_size=4),
            ).refit(ref_matmul_spec(),
                    _drift("matmul_b16", D_SMALL,
                           {"bm": 128, "bn": 512, "bk": 512}, V5E.name,
                           RefDriftEvent, ref_shape_bucket))
    finally:
        ref_driver.registry.clear()
    with Tracer() as port:
        RefitController(
            Klaraptor(HopperModel(noise=0.02, seed=5), device="cpu",
                      cache=False),
            TelemetryConfig(refit_budget=SearchBudget(max_executions=32),
                            refit_repeats=1, refit_max_configs_per_size=4),
        ).refit(matmul_spec(4), _drift(KERNEL, D_SMALL, MM_DEFAULT,
                                       H100.name, DriftEvent, shape_bucket))
    assert _tree(port) == _tree(ref)
    assert [n for n, d in _tree(port) if d == 1] == \
        ["refit.search", "refit.fit", "refit.validate", "refit.swap"]
    for s_ref, s_port in zip(ref.spans(), port.spans()):
        assert set(s_port.attrs) == set(s_ref.attrs), s_port.name


_SPAN_CALL = re.compile(r'trace_span\(\s*"([^"]+)"')


def _span_names(root: Path, skip=()) -> set[str]:
    names = set()
    for path in root.rglob("*.py"):
        if any(part in skip for part in path.relative_to(root).parts):
            continue
        names |= set(_SPAN_CALL.findall(path.read_text()))
    return names


def test_every_reference_span_outside_fleet_is_opened_by_the_port():
    ref = _span_names(REPO / "src" / "repro", skip=("fleet", "trace"))
    port = _span_names(REPO / "src" / "repro_torch", skip=("trace",))
    # the ops' fall-through builds its span without the helper
    port |= set(re.findall(r'Span\(tracer, "([^"]+)"', (
        REPO / "src" / "repro_torch" / "kernels" / "ops.py").read_text()))
    assert "dispatch.choose" in ref and "engine.step" in ref
    assert ref - port == set()


class TestStatusCLI:
    def test_renders_ledger(self, clean, tmp_path, capsys):
        from repro_torch.launch.status import main
        _, path = _run_telemetry_with_ledger(tmp_path, refit=True)
        assert main(["--ledger", str(path)]) == 0
        out = capsys.readouterr().out
        assert "decisions by kernel and source" in out
        assert KERNEL in out
        assert "drift and refits" in out

    def test_renders_snapshot(self, clean, tmp_path, capsys):
        from repro_torch.launch.status import main
        tel = Telemetry({}, HopperModel()).install()
        try:
            choose_or_default(KERNEL, D_SMALL, MM_DEFAULT)
        finally:
            tel.uninstall()
        path = tmp_path / "snap.json"
        path.write_text(tel.exporter.json())
        assert main(["--snapshot", str(path), "--top", "3"]) == 0
        out = capsys.readouterr().out
        assert "decisions by source" in out and "default" in out

    def test_requires_exactly_one_source(self):
        from repro_torch.launch.status import main
        with pytest.raises(SystemExit):
            main([])


def _reference_ledger_with_refit(tmp_path):
    """The reference's own ``_run_telemetry_with_ledger(refit=True)``: its
    loop over its TPU simulator, a fabricated optimistic prediction."""
    from repro.core.driver import ChoiceEvent as RefChoiceEvent
    from repro.core.driver import registry as ref_registry
    from repro.telemetry import Telemetry as RefTelemetry

    path = tmp_path / "ref_run.jsonl"
    cfg = RefTelemetryConfig(probe_every=1, min_samples=2,
                             drift_threshold=0.2, ewma_alpha=1.0,
                             refit_budget=RefSearchBudget(max_executions=24),
                             refit_repeats=1, refit_max_configs_per_size=4)
    tel = RefTelemetry([ref_matmul_spec()], V5eSimulator(seed=3), config=cfg,
                       cache=False, ledger=str(path))
    tel.install()
    try:
        for _ in range(4):
            tel._on_choice(RefChoiceEvent(
                kernel="matmul_b16", D=dict(D_SMALL),
                config={"bm": 128, "bn": 512, "bk": 512}, source="driver",
                predicted_s=1e-9, hw_name=V5E.name))
    finally:
        tel.uninstall()
        tel.ledger.close()
        ref_registry.clear()
    return path


def test_status_text_identical_to_reference(clean, tmp_path, monkeypatch):
    """Both launchers render the same text for the same ledger -- one the
    reference's loop wrote, one the port's (with a tracer's spans and an
    SLO alert appended) -- the same tail line per event, and the same
    snapshot text for the port's exporter dump."""
    import repro.launch.status as ref_status

    import repro_torch.launch.status as port_status

    monkeypatch.setenv("KLARAPTOR_CACHE_DIR", str(tmp_path / "refcache"))
    ref_path = _reference_ledger_with_refit(tmp_path)
    tel, port_path = _run_telemetry_with_ledger(tmp_path, refit=True)
    with open(port_path, "a") as f:
        f.write(json.dumps({"type": "span", "name": "refit", "depth": 0,
                            "dur_ns": 3_000_000, "t_ns": 5}) + "\n")
        f.write(json.dumps({"type": "alert", "slo": "drift_ewma",
                            "state": "breach", "value": 2.5,
                            "objective": 0.25,
                            "key": {"kernel": KERNEL}}) + "\n")
    for path in (ref_path, port_path):
        port_events = read_ledger(path)
        ref_events = ref_trace.read_ledger(path)
        assert port_events == ref_events
        for top in (1, 10):
            assert port_status.render_ledger(port_events, top=top) == \
                ref_status.render_ledger(ref_events, top=top)
        assert [port_status.format_event(e) for e in port_events] == \
            [ref_status.format_event(e) for e in ref_events]
    snap = json.loads(tel.exporter.json())
    assert port_status.render_snapshot(snap) == \
        ref_status.render_snapshot(snap)
    assert port_status.section("x") == ref_status.section("x")
    rows = [["a", "1"], ["bbb", "22"]]
    assert port_status.table(["k", "v"], rows) == \
        ref_status.table(["k", "v"], rows)


def test_follow_ledger_tails_as_the_reference(clean, tmp_path):
    """``follow_ledger`` over one ledger (a torn last line left for the
    next poll) prints the reference's lines and counts the same events."""
    import io

    import repro.launch.status as ref_status

    import repro_torch.launch.status as port_status

    _, path = _run_telemetry_with_ledger(tmp_path, refit=True)
    with open(path, "a") as f:
        f.write('{"type": "drift", "kernel": "x"')      # torn: not read
    outs = []
    for mod in (port_status, ref_status):
        buf = io.StringIO()
        n = mod.follow_ledger(path, interval_s=0.01, max_seconds=0.0,
                              out=buf)
        outs.append((n, buf.getvalue()))
    assert outs[0] == outs[1]
    assert outs[0][0] == len(read_ledger(path))


def test_every_reference_span_is_opened_by_the_port():
    """With ``fleet/`` ported, the reference's spans everywhere (the farm's
    ``fleet.tune`` and ``fleet.retune`` among them) are the port's too."""
    ref = _span_names(REPO / "src" / "repro", skip=("trace",))
    port = _span_names(REPO / "src" / "repro_torch", skip=("trace",))
    port |= set(re.findall(r'Span\(tracer, "([^"]+)"', (
        REPO / "src" / "repro_torch" / "kernels" / "ops.py").read_text()))
    assert {"fleet.tune", "fleet.retune"} <= ref & port
    assert ref - port == set()
