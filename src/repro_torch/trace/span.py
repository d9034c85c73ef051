"""Structured spans: the timing skeleton of the tune->serve pipeline.

KLARAPTOR's runtime half exists because the paper could *see* what every
launch cost (CUPTI); this module is the host-side equivalent for the whole
reproduction pipeline.  A ``Span`` is one timed region with attributes --
``trace_span("collect.batch", kernel=..., strategy=...)`` -- nested per
thread, timed on the monotonic clock, and recorded into a process-wide
``Tracer``:

  * a bounded ring of completed spans (the flight recorder -- always
    queryable, never unbounded),
  * a per-name duration histogram (folded into
    ``MetricsExporter.prometheus()`` as real latency distributions),
  * optionally an append-only JSONL ledger
    (``repro_torch.trace.ledger``) so the record survives the process.

Zero-cost-when-off discipline (same contract as the driver's listener-gated
``_notify``): with no tracer installed, ``trace_span`` is one module-global
``is None`` check returning a shared no-op span -- no allocation beyond the
kwargs dict, no clock read, no lock.  Instrumented hot paths stay hot.
"""

from __future__ import annotations

import bisect
import functools
import threading
import time
from collections import deque

# Bound once: the enabled span path runs these on every enter/exit, and a
# module-global load beats an attribute chain in the hot path.
_monotonic_ns = time.monotonic_ns
_bisect_left = bisect.bisect_left

__all__ = ["HISTOGRAM_BOUNDS_S", "NULL_SPAN", "Span", "SpanHistogram",
           "Tracer", "get_tracer", "set_tracer", "trace_span", "traced",
           "tracing"]

# Histogram bucket upper bounds, in seconds (microseconds to tens of
# seconds: spans range from one engine step to a full driver build).
HISTOGRAM_BOUNDS_S = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0)
_BOUNDS_NS = tuple(int(b * 1e9) for b in HISTOGRAM_BOUNDS_S)


class SpanHistogram:
    """Fixed-bucket duration histogram for one span name.

    ``counts[i]`` counts durations <= ``HISTOGRAM_BOUNDS_S[i]`` (exclusive
    of lower buckets); the final slot is the +Inf overflow.  Kept in raw
    nanoseconds so ``add`` is integer-only.
    """

    __slots__ = ("counts", "sum_ns", "count", "max_ns")

    def __init__(self) -> None:
        self.counts = [0] * (len(_BOUNDS_NS) + 1)
        self.sum_ns = 0
        self.count = 0
        self.max_ns = 0

    def add(self, dur_ns: int) -> None:
        self.counts[_bisect_left(_BOUNDS_NS, dur_ns)] += 1
        self.sum_ns += dur_ns
        self.count += 1
        if dur_ns > self.max_ns:
            self.max_ns = dur_ns

    def as_dict(self) -> dict:
        return {
            "counts": list(self.counts),
            "sum_s": self.sum_ns / 1e9,
            "count": self.count,
            "max_s": self.max_ns / 1e9,
        }


class Span:
    """One timed, attributed region; a context manager.

    ``attrs`` is the span's open attribute dict -- add outcome attributes
    mid-span with ``set(key=value)`` (e.g. how many probes a collect batch
    actually spent).  Timing uses ``time.monotonic_ns`` so spans order
    correctly under wall-clock steps.
    """

    __slots__ = ("name", "attrs", "t0_ns", "t1_ns", "tid", "thread_name",
                 "depth", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        # Timing/thread slots are written by __enter__/__exit__ -- a span is
        # only meaningful once it has run, and the enabled path is hot
        # enough that five dead stores here are worth skipping.
        self._tracer = tracer
        self.name = name
        self.attrs = attrs

    @property
    def duration_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def set(self, **attrs) -> "Span":
        """Attach attributes to the running span (chains)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        local = self._tracer._local
        try:
            stack = local.stack
        except AttributeError:
            # First span on this thread: build its stack, capture the
            # thread identity once (not on every span exit), and register
            # this thread's histogram shard with the tracer.
            stack = self._tracer._init_thread(local)
        self.depth = len(stack)
        stack.append(self)
        # Last before the body so setup cost is outside the measurement.
        self.t0_ns = _monotonic_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        # First after the body, for the same reason.
        t1 = self.t1_ns = _monotonic_ns()
        tracer = self._tracer
        local = tracer._local
        stack = local.stack
        if stack and stack[-1] is self:
            stack.pop()
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self.tid = local.tid
        self.thread_name = local.tname
        # Recording is inlined and lock-free: the ring append is
        # GIL-atomic, and the histogram shard belongs to this thread alone
        # (merged at query time) -- the hot record path touches no shared
        # mutable state under contention.
        dur_ns = t1 - self.t0_ns
        tracer._ring.append(self)
        hist = local.hist
        h = hist.get(self.name)
        if h is None:
            h = hist[self.name] = SpanHistogram()
        h.add(dur_ns)
        led = tracer.ledger
        sink = tracer.span_sink
        if led is not None or sink is not None:
            # One dict serves both consumers, so a live MetricsBus sees
            # byte-identical events to what a ledger replay would read back.
            ev = {
                "type": "span",
                "name": self.name,
                "t0_ns": self.t0_ns,
                "dur_s": dur_ns / 1e9,
                "thread": self.thread_name,
                "depth": self.depth,
                "attrs": self.attrs,
            }
            if led is not None:
                led.append(ev)
            if sink is not None:
                sink(ev)
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.duration_s * 1e6:.1f}us, "
                f"depth={self.depth}, attrs={self.attrs!r})")


class _NullSpan:
    """The shared disabled-tracer span: every operation is a no-op."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class Tracer:
    """Process-wide span collector: flight-recorder ring + histograms.

    ``capacity`` bounds the in-memory ring of completed spans (oldest
    dropped first); histograms aggregate forever (a handful of ints per
    span name).  ``ledger`` (a ``repro_torch.trace.Ledger``) additionally
    persists every completed span as one JSONL line.

    Install with ``tracer.install()`` (or as a context manager) to make
    ``trace_span`` live; uninstalling restores the zero-cost path.
    """

    def __init__(self, capacity: int = 8192, ledger=None):
        self.capacity = int(capacity)
        self.ledger = ledger
        # Optional callable fed the same span-event dict as the ledger
        # line; a ``repro_torch.obs.MetricsBus``'s ``ingest`` fits here.
        self.span_sink = None
        self._ring: deque[Span] = deque(maxlen=max(self.capacity, 1))
        # Histograms are sharded per recording thread (each thread mutates
        # only its own dict, registered in ``_shards`` under ``_lock`` once
        # per thread) so the record path in ``Span.__exit__`` is lock-free;
        # queries merge the shards.
        self._shards: list[dict[str, SpanHistogram]] = []
        self._lock = threading.Lock()
        self._local = threading.local()

    # -- recording -----------------------------------------------------------
    # (Recording itself lives inline in ``Span.__exit__``: GIL-atomic ring
    # append + this thread's histogram shard, no lock taken.)
    def span(self, name: str, attrs: dict | None = None) -> Span:
        return Span(self, name, attrs if attrs is not None else {})

    def _init_thread(self, local) -> list:
        """First span on a thread: stack, cached identity, hist shard."""
        stack = local.stack = []
        th = threading.current_thread()
        local.tid = th.ident or 0
        local.tname = th.name
        local.hist = {}
        with self._lock:
            self._shards.append(local.hist)
        return stack

    # -- querying ------------------------------------------------------------
    @property
    def n_spans(self) -> int:
        """Total completed spans, including ring-evicted ones."""
        return sum(h.count for shard in list(self._shards)
                   for h in list(shard.values()))

    def spans(self) -> list[Span]:
        """Completed spans still in the flight recorder, oldest first."""
        while True:       # lock-free writers: retry if an append races
            try:
                return list(self._ring)
            except RuntimeError:
                continue

    def _merged(self) -> dict[str, SpanHistogram]:
        merged: dict[str, SpanHistogram] = {}
        for shard in list(self._shards):
            for name, h in list(shard.items()):
                m = merged.get(name)
                if m is None:
                    m = merged[name] = SpanHistogram()
                m.counts = [a + b for a, b in zip(m.counts, h.counts)]
                m.sum_ns += h.sum_ns
                m.count += h.count
                m.max_ns = max(m.max_ns, h.max_ns)
        return merged

    def histograms(self) -> dict[str, dict]:
        """Per-span-name duration histograms (JSON-able snapshots),
        merged across thread shards."""
        return {name: h.as_dict() for name, h in self._merged().items()}

    def summary(self, top: int | None = None) -> list[dict]:
        """Per-name cumulative stats, sorted by total time descending."""
        rows = [{
            "name": name,
            "count": h.count,
            "total_s": h.sum_ns / 1e9,
            "mean_s": (h.sum_ns / h.count) / 1e9 if h.count else 0.0,
            "max_s": h.max_ns / 1e9,
        } for name, h in self._merged().items()]
        rows.sort(key=lambda r: (-r["total_s"], r["name"]))
        return rows[:top] if top is not None else rows

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            # In place: recording threads hold references to their shards.
            for shard in self._shards:
                shard.clear()

    # -- export --------------------------------------------------------------
    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON payload (loads in Perfetto)."""
        from .chrome import chrome_trace

        return chrome_trace(self.spans())

    def write_chrome_trace(self, path: str) -> int:
        """Write the flight recorder as Chrome trace-event JSON; returns
        the number of spans exported."""
        from .chrome import write_chrome_trace

        return write_chrome_trace(path, self.spans())

    # -- lifecycle -----------------------------------------------------------
    def install(self) -> "Tracer":
        """Become the process-wide tracer (returns self for chaining)."""
        set_tracer(self)
        return self

    def uninstall(self) -> None:
        if _active is self:
            set_tracer(None)

    def __enter__(self) -> "Tracer":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


# The process-wide tracer.  A plain module global (not a registry field)
# for the same reason as the driver's choice listener: the disabled check
# must cost one load + ``is None`` per instrumented call, nothing more.
_active: Tracer | None = None


def set_tracer(tracer: Tracer | None) -> Tracer | None:
    """Install (or with None remove) the process-wide tracer."""
    global _active
    _active = tracer
    return tracer


def get_tracer() -> Tracer | None:
    return _active


def tracing() -> bool:
    """Is a tracer installed?  (For gating work that only serves tracing,
    e.g. a stream synchronize so device time lands inside the span.)"""
    return _active is not None


def trace_span(name: str, **attrs):
    """Open a span named ``name`` with the given attributes.

    The workhorse context manager: ``with trace_span("fit", kernel=k):``.
    With no tracer installed this returns the shared no-op ``NULL_SPAN``
    and the block runs untimed at (near-)zero cost.
    """
    t = _active
    if t is None:
        return NULL_SPAN
    return Span(t, name, attrs)


def traced(name: str | None = None, **attrs):
    """Decorator form: time every call of the wrapped function.

    ``@traced()`` uses the function's qualname; ``@traced("collect")``
    names the span explicitly.  The disabled path adds one global load and
    one ``is None`` check per call.
    """
    def deco(fn):
        span_name = name if name is not None else fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t = _active
            if t is None:
                return fn(*args, **kwargs)
            with Span(t, span_name, dict(attrs)):
                return fn(*args, **kwargs)
        return wrapper
    return deco
