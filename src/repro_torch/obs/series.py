"""Windowed time-series and the MetricsBus that feeds them.

The telemetry exporter answers "what are the counters *now*"; this
module answers "what were they *over the last N seconds*", which is what
burn-rate SLOs and a live dashboard need (the reference's ``obs.slo`` and
``launch.dash``; the port's wait, see ROADMAP).  Three
series types, all windowed on wall-clock nanoseconds with fixed-width
windows (default 1 s x 600):

  ``WindowedCounter``    monotone event counts; query ``rate`` / ``sum_over``
  ``WindowedGauge``      last value + EWMA, per-window last for sparklines
  ``WindowedHistogram``  fixed-bucket, mergeable, p50/p95/p99 by
                         deterministic linear interpolation

Windows rotate on *data time*, not on a background thread: every sample
lands in window ``wall_ns // window_ns`` and old windows are pruned as new
ones appear.  That one choice is what makes offline ledger replay
(``replay_into``) reproduce a live run bit-identically -- both paths see
the same event dicts with the same timestamps, so they build the same
windows.

``MetricsBus`` is the ingest front: it accepts the *ledger event dicts*
(choice/probe/drift/refit/alert/bucket_step/span/session) and fans each
into the right series under one short lock.  Live, the telemetry loop and
tracer hand it the same dict object they append to the JSONL ledger;
offline, ``replay_into`` streams one or many ledgers through ``align_events``
into a fresh bus.  Monotonic stamps are wall-aligned through the ledger's
session anchor either way.

Zero-cost-when-off: the process-wide bus is a module global guarded by one
``is None`` check (the driver-listener pattern); with no bus installed the
memoized dispatch path does zero observability work.
"""

from __future__ import annotations

import json
import threading

from ..trace.ledger import event_time_ns, iter_ledger, merge_ledgers

__all__ = ["MetricsBus", "WindowedCounter", "WindowedGauge",
           "WindowedHistogram", "get_metrics_bus", "label_str",
           "parse_label_str", "replay_into", "set_metrics_bus"]

# Histogram bucket upper bounds in seconds -- matches the tracer's span
# histograms so merged views line up (final slot is +Inf overflow).
SERIES_BOUNDS_S = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0)


def label_str(labels: dict) -> str:
    """Canonical key for a label set: sorted ``k=v`` joined by commas."""
    return ",".join(f"{k}={labels[k]}" for k in sorted(labels))


def parse_label_str(key: str) -> dict:
    """Invert ``label_str``: ``"hw=v5e,kernel=mm"`` -> dict.

    Values may themselves contain commas (shape-bucket labels like
    ``"bh5,skv7,sq7"``); a split segment without ``=`` belongs to the
    previous value, since label names never contain ``=``.
    """
    out: dict[str, str] = {}
    last = None
    if key:
        for part in key.split(","):
            if "=" not in part and last is not None:
                out[last] += "," + part
                continue
            k, _, v = part.partition("=")
            out[k] = v
            last = k
    return out


class _Windowed:
    """Shared rotation arithmetic: fixed windows keyed by wall_ns//width."""

    def __init__(self, window_ns: int, n_windows: int):
        self.window_ns = int(window_ns)
        self.n_windows = int(n_windows)
        self.windows: dict[int, object] = {}   # window index -> payload

    def _index(self, wall_ns: int) -> int:
        return int(wall_ns) // self.window_ns

    def _prune(self, newest: int) -> None:
        # Data-time driven: everything older than the retention horizon of
        # the newest *observed* window goes.  A wall-clock step backwards
        # simply lands samples in an older (still-retained) window; a step
        # forward retires history -- either way replay sees identical
        # windows because it replays identical timestamps.
        if len(self.windows) <= self.n_windows:
            return
        floor = newest - self.n_windows + 1
        for idx in [i for i in self.windows if i < floor]:
            del self.windows[idx]

    def _span_indices(self, now_ns: int, span_ns: int) -> range:
        """Window indices covering (now - span, now]."""
        hi = self._index(now_ns)
        lo = self._index(max(0, int(now_ns) - int(span_ns)) + 1)
        return range(lo, hi + 1)


class WindowedCounter(_Windowed):
    """Monotone event counter with a windowed recent history."""

    def __init__(self, window_ns: int, n_windows: int):
        super().__init__(window_ns, n_windows)
        self.total = 0.0

    def add(self, wall_ns: int, n: float = 1.0) -> None:
        self.total += n
        idx = self._index(wall_ns)
        self.windows[idx] = self.windows.get(idx, 0.0) + n
        self._prune(max(self.windows))

    def sum_over(self, now_ns: int, span_ns: int) -> float:
        """Events counted in the trailing ``span_ns`` ending at ``now_ns``."""
        return sum(self.windows.get(i, 0.0)
                   for i in self._span_indices(now_ns, span_ns))

    def rate(self, now_ns: int, span_ns: int) -> float:
        """Events/second over the trailing span."""
        span_s = int(span_ns) / 1e9
        return self.sum_over(now_ns, span_ns) / span_s if span_s > 0 else 0.0

    def as_dict(self) -> dict:
        return {"total": self.total,
                "windows": {str(i): v for i, v in sorted(self.windows.items())}}


class WindowedGauge(_Windowed):
    """Last-value + EWMA gauge; keeps the per-window last for sparklines."""

    def __init__(self, window_ns: int, n_windows: int, alpha: float = 0.3):
        super().__init__(window_ns, n_windows)
        self.alpha = float(alpha)
        self.last: float | None = None
        self.ewma: float | None = None
        self.n = 0

    def set(self, wall_ns: int, value: float) -> None:
        v = float(value)
        self.last = v
        self.ewma = v if self.ewma is None \
            else self.alpha * v + (1.0 - self.alpha) * self.ewma
        self.n += 1
        self.windows[self._index(wall_ns)] = v
        self._prune(max(self.windows))

    def last_over(self, now_ns: int, span_ns: int) -> float | None:
        """Most recent per-window value inside the trailing span."""
        for i in reversed(self._span_indices(now_ns, span_ns)):
            if i in self.windows:
                return self.windows[i]
        return None

    def as_dict(self) -> dict:
        return {"last": self.last, "ewma": self.ewma, "n": self.n,
                "windows": {str(i): v for i, v in sorted(self.windows.items())}}


class WindowedHistogram(_Windowed):
    """Fixed-bucket duration histogram, windowed and mergeable.

    Cumulative totals (``counts``/``sum``/``count``) aggregate forever for
    Prometheus ``_bucket``/``_sum``/``_count`` lines; per-window bucket
    arrays support quantiles over a trailing span.  Quantiles use
    deterministic linear interpolation inside the winning bucket so live
    and replayed runs agree exactly.
    """

    def __init__(self, window_ns: int, n_windows: int,
                 bounds_s: tuple = SERIES_BOUNDS_S):
        super().__init__(window_ns, n_windows)
        self.bounds_s = tuple(float(b) for b in bounds_s)
        self.counts = [0] * (len(self.bounds_s) + 1)
        self.sum = 0.0
        self.count = 0

    def _bucket_of(self, value: float) -> int:
        for i, b in enumerate(self.bounds_s):
            if value <= b:
                return i
        return len(self.bounds_s)

    def add(self, wall_ns: int, value: float) -> None:
        v = float(value)
        b = self._bucket_of(v)
        self.counts[b] += 1
        self.sum += v
        self.count += 1
        idx = self._index(wall_ns)
        win = self.windows.get(idx)
        if win is None:
            win = self.windows[idx] = [0] * (len(self.bounds_s) + 1)
        win[b] += 1
        self._prune(max(self.windows))

    def merge(self, other: "WindowedHistogram") -> None:
        """Fold another shard in (window-aligned; disjoint windows union).

        Requires identical bucket bounds; window widths are assumed equal
        (both sides derive them from the same bus config).
        """
        if other.bounds_s != self.bounds_s:
            raise ValueError("cannot merge histograms with different bounds")
        self.counts = [a + b for a, b in zip(self.counts, other.counts)]
        self.sum += other.sum
        self.count += other.count
        # list() materializes the view in one C call, so a shard owner
        # appending concurrently cannot invalidate this iteration.
        for idx, win in list(other.windows.items()):
            mine = self.windows.get(idx)
            if mine is None:
                self.windows[idx] = list(win)
            else:
                self.windows[idx] = [a + b for a, b in zip(mine, win)]
        if self.windows:
            self._prune(max(self.windows))

    def _quantile_from(self, counts, q: float) -> float | None:
        total = sum(counts)
        if total == 0:
            return None
        target = q * total
        seen = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if seen + c >= target:
                lo = self.bounds_s[i - 1] if i > 0 else 0.0
                hi = self.bounds_s[i] if i < len(self.bounds_s) \
                    else self.bounds_s[-1] * 10.0
                frac = (target - seen) / c
                return lo + frac * (hi - lo)
            seen += c
        return self.bounds_s[-1] * 10.0

    def quantile(self, q: float) -> float | None:
        """All-time quantile estimate (None while empty)."""
        return self._quantile_from(self.counts, q)

    def quantile_over(self, now_ns: int, span_ns: int,
                      q: float) -> float | None:
        """Quantile over the trailing span only."""
        acc = [0] * (len(self.bounds_s) + 1)
        for i in self._span_indices(now_ns, span_ns):
            win = self.windows.get(i)
            if win is not None:
                acc = [a + b for a, b in zip(acc, win)]
        return self._quantile_from(acc, q)

    def as_dict(self) -> dict:
        return {"counts": list(self.counts), "sum": self.sum,
                "count": self.count,
                "p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}


class MetricsBus:
    """Ingest front: ledger-shaped event dicts in, windowed series out.

    One instance per process (install with ``set_metrics_bus``) or per
    replay.  ``anchor`` is the ledger session anchor dict
    (``{"wall_ns", "mono_ns"}``) used to map live events' monotonic
    ``t_ns`` stamps to wall time -- pass the owning ``Ledger.anchor`` so
    live ingestion and ledger replay see identical wall timestamps.
    Replayed ``session`` events update the anchor in-stream.

    Ingest takes one short bus-level lock; with sub-ms hold times and
    event rates already throttled upstream (choice coalescing, probe
    sampling) contention is negligible, and it keeps every series
    internally consistent for concurrent exporter reads.
    """

    def __init__(self, anchor: dict | None = None, window_s: float = 1.0,
                 n_windows: int = 600, ewma_alpha: float = 0.3):
        self.window_ns = int(window_s * 1e9)
        self.n_windows = int(n_windows)
        self.ewma_alpha = float(ewma_alpha)
        self._anchor_wall = int(anchor["wall_ns"]) if anchor else None
        self._anchor_mono = int(anchor["mono_ns"]) if anchor else None
        self._lock = threading.Lock()
        self.counters: dict[str, dict[str, WindowedCounter]] = {}
        self.gauges: dict[str, dict[str, WindowedGauge]] = {}
        self.histograms: dict[str, dict[str, WindowedHistogram]] = {}
        self.n_events = 0
        self.last_wall_ns = 0
        self._subscribers: list = []

    # -- series access -------------------------------------------------------
    def counter(self, name: str, labels: dict | None = None) -> WindowedCounter:
        fam = self.counters.setdefault(name, {})
        key = label_str(labels or {})
        c = fam.get(key)
        if c is None:
            c = fam[key] = WindowedCounter(self.window_ns, self.n_windows)
        return c

    def gauge(self, name: str, labels: dict | None = None) -> WindowedGauge:
        fam = self.gauges.setdefault(name, {})
        key = label_str(labels or {})
        g = fam.get(key)
        if g is None:
            g = fam[key] = WindowedGauge(self.window_ns, self.n_windows,
                                         alpha=self.ewma_alpha)
        return g

    def histogram(self, name: str,
                  labels: dict | None = None) -> WindowedHistogram:
        fam = self.histograms.setdefault(name, {})
        key = label_str(labels or {})
        h = fam.get(key)
        if h is None:
            h = fam[key] = WindowedHistogram(self.window_ns, self.n_windows)
        return h

    def subscribe(self, fn) -> None:
        """Register a callback fed ``(wall_ns, event)`` after each ingest
        (under the bus lock; keep it cheap).  The scorecard attaches here."""
        self._subscribers.append(fn)

    # -- time alignment ------------------------------------------------------
    def wall_ns_of(self, event: dict) -> int:
        """Wall-clock nanoseconds of one event via the session anchor.

        An explicit ``wall_ns`` key wins -- ``merge_ledgers`` injects one
        per event so cross-process streams stay aligned to *their own*
        session anchors even though the merged stream interleaves them.
        """
        w = event.get("wall_ns")
        if w is not None:
            return int(w)
        t = event_time_ns(event)
        if t is not None and self._anchor_mono is not None:
            return self._anchor_wall + (t - self._anchor_mono)
        return self.last_wall_ns

    def mono_ns_of_wall(self, wall_ns: int) -> int | None:
        """Reverse map (wall -> monotonic) for stamping synthesized events
        (SLO alerts) so they replay to the same wall time."""
        if self._anchor_mono is None:
            return None
        return self._anchor_mono + (int(wall_ns) - self._anchor_wall)

    # -- ingest --------------------------------------------------------------
    def ingest(self, event: dict) -> None:
        """Route one ledger-shaped event dict into the series.

        Accepts exactly what ``Ledger.append`` takes -- live taps pass the
        same dict object to both so replay is bit-identical by
        construction.
        """
        etype = event.get("type")
        if etype == "session":
            with self._lock:
                self._anchor_wall = int(event["wall_ns"])
                self._anchor_mono = int(event["mono_ns"])
                self.last_wall_ns = self._anchor_wall
                self.n_events += 1
            return
        with self._lock:
            w = self.wall_ns_of(event)
            self.last_wall_ns = w
            self.n_events += 1
            route = self._ROUTES.get(etype)
            if route is not None:
                route(self, w, event)
            for fn in self._subscribers:
                fn(w, event)

    def _ingest_choice(self, w: int, ev: dict) -> None:
        n = float(ev.get("n_coalesced") or 1)
        self.counter("choices", {"source": ev.get("source", "?")}).add(w, n)
        self.counter("launches", {"kernel": ev.get("kernel", "?")}).add(w, n)
        if ev.get("source") == "default":
            self.counter("fallback").add(w, n)

    def _ingest_probe(self, w: int, ev: dict) -> None:
        self.counter("probes", {"kernel": ev.get("kernel", "?")}).add(w)
        ewma = ev.get("rel_error_ewma")
        if ewma is not None:
            self.gauge("rel_error_ewma",
                       {"kernel": ev.get("kernel", "?"),
                        "hw": ev.get("hw", "?"),
                        "bucket": ev.get("bucket", "?")}).set(w, float(ewma))

    def _ingest_drift(self, w: int, ev: dict) -> None:
        self.counter("drift_events",
                     {"kernel": ev.get("kernel", "?")}).add(w)

    def _ingest_refit(self, w: int, ev: dict) -> None:
        ok = bool(ev.get("succeeded"))
        self.counter("refits", {"outcome": "ok" if ok else "fail"}).add(w)
        ws = ev.get("wall_seconds")
        if ws is not None:
            self.histogram("refit_wall_s").add(w, float(ws))
        ds = ev.get("total_device_seconds")
        if ds is not None:
            self.histogram("refit_device_s").add(w, float(ds))

    def _ingest_alert(self, w: int, ev: dict) -> None:
        self.counter("alerts", {"slo": ev.get("slo", "?"),
                                "state": ev.get("state", "?")}).add(w)

    def _ingest_bucket_step(self, w: int, ev: dict) -> None:
        hit = bool(ev.get("hit"))
        kernel = ev.get("kernel") or "?"
        self.counter("bucket_steps",
                     {"kernel": kernel,
                      "outcome": "hit" if hit else "miss"}).add(w)
        self.counter("padding_waste_sum",
                     {"kernel": kernel}).add(w, float(ev.get("waste") or 0.0))

    def _ingest_span(self, w: int, ev: dict) -> None:
        self.histogram("span_duration_s",
                       {"name": ev.get("name", "?")}).add(
            w, float(ev.get("dur_s") or 0.0))

    _ROUTES = {
        "choice": _ingest_choice,
        "probe": _ingest_probe,
        "drift": _ingest_drift,
        "refit": _ingest_refit,
        "alert": _ingest_alert,
        "bucket_step": _ingest_bucket_step,
        "span": _ingest_span,
    }

    # -- queries -------------------------------------------------------------
    def sum_counters(self, name: str, now_ns: int, span_ns: int,
                     **match) -> float:
        """Sum one counter family over a trailing span, filtered by label
        equality (``source="default"``); no kwargs sums every label set."""
        fam = self.counters.get(name)
        if not fam:
            return 0.0
        total = 0.0
        for key, c in fam.items():
            labels = parse_label_str(key)
            if all(labels.get(k) == str(v) for k, v in match.items()):
                total += c.sum_over(now_ns, span_ns)
        return total

    def snapshot(self) -> dict:
        """Deterministic JSON-able dump of every series (sorted keys) --
        the bit-identity surface replay is compared on."""
        with self._lock:
            return {
                "n_events": self.n_events,
                "counters": {name: {k: c.as_dict()
                                    for k, c in sorted(fam.items())}
                             for name, fam in sorted(self.counters.items())},
                "gauges": {name: {k: g.as_dict()
                                  for k, g in sorted(fam.items())}
                           for name, fam in sorted(self.gauges.items())},
                "histograms": {name: {k: h.as_dict()
                                      for k, h in sorted(fam.items())}
                               for name, fam in sorted(self.histograms.items())},
            }

    def snapshot_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)

    def prometheus(self, prefix: str = "klaraptor_obs_") -> str:
        """Prometheus exposition of the bus series (totals + key gauges)."""
        lines: list[str] = []
        with self._lock:
            for name, fam in sorted(self.counters.items()):
                full = prefix + name + "_total"
                lines.append(f"# TYPE {full} counter")
                for key, c in sorted(fam.items()):
                    lines.append(f"{full}{_prom_labels(key)} {c.total}")
            for name, fam in sorted(self.gauges.items()):
                full = prefix + name
                lines.append(f"# TYPE {full} gauge")
                for key, g in sorted(fam.items()):
                    if g.last is not None:
                        lines.append(f"{full}{_prom_labels(key)} {g.last}")
            for name, fam in sorted(self.histograms.items()):
                full = prefix + name
                lines.append(f"# TYPE {full} histogram")
                for key, h in sorted(fam.items()):
                    base = _prom_label_pairs(key)
                    cum = 0
                    for i, b in enumerate(h.bounds_s):
                        cum += h.counts[i]
                        le = base + [f'le="{b:g}"']
                        lines.append(
                            f"{full}_bucket{{{','.join(le)}}} {cum}")
                    le = base + ['le="+Inf"']
                    lines.append(f"{full}_bucket{{{','.join(le)}}} {h.count}")
                    lines.append(f"{full}_sum{_prom_labels(key)} {h.sum}")
                    lines.append(f"{full}_count{_prom_labels(key)} {h.count}")
        return "\n".join(lines) + "\n"


def _prom_label_pairs(key: str) -> list[str]:
    from ..telemetry.export import _escape_label
    if not key:
        return []
    pairs = []
    for part in key.split(","):
        k, _, v = part.partition("=")
        pairs.append(f'{k}="{_escape_label(v)}"')
    return pairs


def _prom_labels(key: str) -> str:
    pairs = _prom_label_pairs(key)
    return "{" + ",".join(pairs) + "}" if pairs else ""


def replay_into(bus: MetricsBus, paths, strict: bool = False) -> int:
    """Stream one or many JSONL ledgers into ``bus``; returns event count.

    Single ledger: events stream in file order, ``session`` lines update
    the anchor exactly as live ingestion saw it -- so the resulting series
    are bit-identical to the live bus (same dicts, same timestamps, same
    rotation).  Multiple ledgers: ``merge_ledgers`` wall-orders the union
    first (cross-process aggregation; per-file identity still holds since
    windows are keyed on absolute wall time).
    """
    if isinstance(paths, (str, bytes)) or hasattr(paths, "__fspath__"):
        paths = [paths]
    paths = list(paths)
    n = 0
    if len(paths) == 1:
        for ev in iter_ledger(paths[0], strict=strict):
            bus.ingest(ev)
            n += 1
    else:
        # Merged events keep their injected ``wall_ns`` so every event
        # aligns to its own process's anchor (see ``wall_ns_of``).
        for ev in merge_ledgers(paths, strict=strict):
            bus.ingest(ev)
            n += 1
    return n


# The process-wide bus: a module global with one ``is None`` check, the
# same zero-cost-when-off contract as the driver's choice listener and the
# tracer.  Nothing in the dispatch hot path touches this unless installed.
_active_bus: MetricsBus | None = None


def set_metrics_bus(bus: MetricsBus | None) -> MetricsBus | None:
    """Install (or with None remove) the process-wide metrics bus."""
    global _active_bus
    _active_bus = bus
    return bus


def get_metrics_bus() -> MetricsBus | None:
    return _active_bus
