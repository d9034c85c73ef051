"""Metrics export: JSON snapshots and Prometheus-style text.

The exporter is read-only over the telemetry loop's state and fully
deterministic: keys are emitted in sorted order and nothing time-dependent
(timestamps, wall clocks) enters the output, so two exports of the same
state are byte-identical -- the property fleet-side diffing and the tests
rely on.

Counter semantics (all monotonic within a process):
  * ``choices_total`` / ``choices_by_source`` -- every instrumented
    ``choose_or_default`` decision, split by path (driver / override /
    plan / search / search_memo / default, plus ``bucket`` for serving
    steps whose config was fetched in-graph by the bucketed-dispatch
    layer).  Decision-memo hits past the
    full-fidelity window arrive as *coalesced* events
    (``ChoiceEvent.n_coalesced``); these counters account for every launch
    a coalesced event stands for, so totals reflect traffic volume even
    though the listener fires on a sampled subset.
  * ``fallback_default_total`` -- launches served by the static heuristic
    (the "untuned forever" signal the subsystem exists to drive to zero).
  * ``shadow_probes_total`` / ``probe_device_seconds_total`` -- sampled
    observability probes and their bounded device-time cost.
  * ``drift_events_total``, ``refits_total``, ``refit_failures_total``,
    ``refit_device_seconds_total``, ``overrides_total`` -- the adaptive
    loop's activity.
  * ``disk_cache_hits`` / ``disk_cache_misses`` -- driver-artifact cache
    read-throughs (from the registry, so they count even before telemetry
    is installed).
  * ``plan_hits`` / ``plan_misses`` -- compiled-launch-plan dispatches
    (the O(1) hot path of core/plan.py) vs envelope misses that fell back
    to the driver; ``choose_many_calls`` / ``choose_many_rows`` -- batched
    multi-shape selection passes and their total batch size (how much plan
    compilation happened, and how wide).  ``plan`` also appears as its own
    ``choices_by_source`` bucket.
  * ``bucket_hits`` / ``bucket_misses`` -- bucketed in-graph dispatch
    outcomes per (decode step, kernel): hit means the raw shape landed on
    the bucket lattice and the padded bucket's config served the launch;
    miss means the out-of-range default branch ran.  The
    ``padding_waste_frac`` gauge is the mean padded-away volume fraction
    across those steps.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from ..core.driver import registry
from ..trace import HISTOGRAM_BOUNDS_S, get_tracer

from .record import bucket_label

__all__ = ["MetricsExporter", "TelemetryCounters"]


def _escape_label(value) -> str:
    """Escape a label value per the Prometheus text exposition format.

    Inside double-quoted label values, backslash, double-quote and
    newline must be escaped (in that order -- backslash first, or the
    escapes themselves get re-escaped).  Without this, a kernel or hw
    name containing ``"`` or ``\\`` produced an unparseable line.
    """
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


@dataclass
class TelemetryCounters:
    choices_total: int = 0
    choices_by_source: dict = field(default_factory=dict)
    fallback_default_total: int = 0
    shadow_probes_total: int = 0
    probe_device_seconds_total: float = 0.0
    drift_events_total: int = 0
    refits_total: int = 0
    refit_failures_total: int = 0
    refit_device_seconds_total: float = 0.0
    overrides_total: int = 0
    warm_started_kernels: int = 0
    # Bucketed in-graph dispatch (serving engine, core/buckets.py): per
    # decode step and kernel, did the raw shape land on the lattice (hit:
    # the padded bucket's config served in-graph) or fall to the default
    # branch (miss)?  waste_sum accumulates the padding-waste fraction of
    # hits, so waste_sum / (hits + misses) is the mean padded-away volume.
    bucket_hits: int = 0
    bucket_misses: int = 0
    bucket_padding_waste_sum: float = 0.0


class MetricsExporter:
    """Formats one telemetry loop's state for machines and dashboards."""

    def __init__(self, telemetry):
        self._t = telemetry

    # -- JSON ----------------------------------------------------------------
    def snapshot(self) -> dict:
        """Deterministic JSON-able state dump."""
        t = self._t
        c = t.counters
        reg = registry.stats()
        counters = {
            "choices_total": c.choices_total,
            "choices_by_source": dict(sorted(c.choices_by_source.items())),
            "fallback_default_total": c.fallback_default_total,
            "shadow_probes_total": c.shadow_probes_total,
            "probe_device_seconds_total": c.probe_device_seconds_total,
            "drift_events_total": c.drift_events_total,
            "refits_total": c.refits_total,
            "refit_failures_total": c.refit_failures_total,
            "refit_device_seconds_total": c.refit_device_seconds_total,
            "overrides_total": c.overrides_total,
            "warm_started_kernels": c.warm_started_kernels,
            "bucket_hits": c.bucket_hits,
            "bucket_misses": c.bucket_misses,
            "disk_cache_hits": reg["disk_cache_hits"],
            "disk_cache_misses": reg["disk_cache_misses"],
            "plan_hits": reg.get("plan_hits", 0),
            "plan_misses": reg.get("plan_misses", 0),
            "choose_many_calls": reg.get("choose_many_calls", 0),
            "choose_many_rows": reg.get("choose_many_rows", 0),
            "plan_invalidations": reg.get("plan_invalidations", 0),
            "memo_invalidations": reg.get("memo_invalidations", 0),
        }
        # Gauges: point-in-time registry state (hot-swap churn visibility),
        # as opposed to the monotonic counters above.
        n_bucket = c.bucket_hits + c.bucket_misses
        gauges = {
            "registry_generation": registry.generation,
            "decision_memo_entries": registry.memo_size(),
            # Mean fraction of padded bucket volume that was padding, over
            # every bucket-accounted decode step so far (0.0 when the
            # engine is not running bucketed dispatch).
            "padding_waste_frac": (
                c.bucket_padding_waste_sum / n_bucket if n_bucket else 0.0),
        }
        keys = [{
            "kernel": s.kernel,
            "hw": s.hw_name,
            "bucket": bucket_label(s.bucket),
            "n_choices": s.n_choices,
            "n_probes": s.n_probes,
            "rel_error_ewma": s.rel_error_ewma,
            "last_predicted_s": s.last_predicted_s,
            "last_observed_s": s.last_observed_s,
        } for s in t.recorder.keys()]
        refits = [{
            "kernel": r.kernel,
            "D": dict(sorted(r.D.items())),
            "succeeded": r.succeeded,
            "cache_version": r.cache_version,
            "override": (dict(sorted(r.override.items()))
                         if r.override is not None else None),
            "search_device_seconds": r.search_device_seconds,
            "fit_device_seconds": r.fit_device_seconds,
            "validation_device_seconds": r.validation_device_seconds,
            "total_device_seconds": r.total_device_seconds,
            "total_executions": r.total_executions,
            "error": r.error,
        } for r in t.refits]
        out = {
            "config": t.config.fingerprint(),
            "counters": counters,
            "gauges": gauges,
            "keys": keys,
            "refits": refits,
        }
        # Span summaries join the snapshot only when a tracer is installed
        # -- exports without one stay byte-identical to pre-trace output
        # modulo the new counter/gauge keys (and stay deterministic: span
        # totals only move when spans complete, not when snapshots happen).
        tracer = get_tracer()
        if tracer is not None:
            out["spans"] = tracer.summary()
        return out

    def json(self, indent: int | None = 2) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    # -- Prometheus text -----------------------------------------------------
    def prometheus(self, prefix: str = "klaraptor") -> str:
        """Prometheus exposition-format text: counters, gauges, and (when a
        tracer is installed) span-duration histograms."""
        snap = self.snapshot()
        c = snap["counters"]
        lines: list[str] = []

        def counter(name: str, value, labels: str = "") -> None:
            lines.append(f"{prefix}_{name}{labels} {value}")

        lines.append(f"# TYPE {prefix}_choices_total counter")
        for source, n in c["choices_by_source"].items():
            counter("choices_total", n,
                    f'{{source="{_escape_label(source)}"}}')
        for name in ("fallback_default_total", "shadow_probes_total",
                     "probe_device_seconds_total", "drift_events_total",
                     "refits_total", "refit_failures_total",
                     "refit_device_seconds_total", "overrides_total",
                     "bucket_hits", "bucket_misses",
                     "disk_cache_hits", "disk_cache_misses",
                     "plan_hits", "plan_misses",
                     "choose_many_calls", "choose_many_rows",
                     "plan_invalidations", "memo_invalidations",
                     "warm_started_kernels"):
            lines.append(f"# TYPE {prefix}_{name} counter")
            counter(name, c[name])
        for name, value in snap["gauges"].items():
            lines.append(f"# TYPE {prefix}_{name} gauge")
            lines.append(f"{prefix}_{name} {value}")
        lines.append(f"# TYPE {prefix}_rel_error_ewma gauge")
        lines.append(f"# TYPE {prefix}_key_choices_total counter")
        lines.append(f"# TYPE {prefix}_key_probes_total counter")
        for k in snap["keys"]:
            labels = (f'{{kernel="{_escape_label(k["kernel"])}",'
                      f'hw="{_escape_label(k["hw"])}",'
                      f'bucket="{_escape_label(k["bucket"])}"}}')
            if k["rel_error_ewma"] is not None:
                lines.append(
                    f"{prefix}_rel_error_ewma{labels} "
                    f"{k['rel_error_ewma']:.6g}")
            lines.append(
                f"{prefix}_key_choices_total{labels} {k['n_choices']}")
            lines.append(
                f"{prefix}_key_probes_total{labels} {k['n_probes']}")
        lines.extend(self._span_histogram_lines(prefix))
        return "\n".join(lines) + "\n"

    @staticmethod
    def _span_histogram_lines(prefix: str) -> list[str]:
        """Span-duration histograms per the Prometheus histogram
        convention: cumulative ``_bucket{le=...}`` series (including
        ``+Inf``), plus ``_sum`` and ``_count``.  Empty with no tracer
        installed."""
        tracer = get_tracer()
        if tracer is None:
            return []
        hists = tracer.histograms()
        if not hists:
            return []
        metric = f"{prefix}_span_duration_seconds"
        lines = [f"# TYPE {metric} histogram"]
        for name in sorted(hists):
            h = hists[name]
            span = _escape_label(name)
            cum = 0
            for le, n in zip(HISTOGRAM_BOUNDS_S, h["counts"]):
                cum += n
                lines.append(
                    f'{metric}_bucket{{span="{span}",le="{le:g}"}} {cum}')
            cum += h["counts"][-1]
            lines.append(f'{metric}_bucket{{span="{span}",le="+Inf"}} {cum}')
            lines.append(f'{metric}_sum{{span="{span}"}} {h["sum_s"]:.9g}')
            lines.append(f'{metric}_count{{span="{span}"}} {h["count"]}')
        return lines
