"""Chrome trace-event export: render spans as a Perfetto-loadable timeline.

Emits the JSON Object Format of the Trace Event specification -- a
``{"traceEvents": [...]}`` payload of complete ("ph": "X") events with
microsecond timestamps, one track per thread, span attributes as ``args``.
Open the file at https://ui.perfetto.dev or ``chrome://tracing`` to see the
tune->serve pipeline as nested bars: engine step -> kernel dispatch ->
(on drift) the refit chain.
"""

from __future__ import annotations

import json
import os

__all__ = ["chrome_trace", "write_chrome_trace"]


def _clean(value):
    """Coerce an attribute value to something JSON-serialisable."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, dict):
        return {str(k): _clean(v) for k, v in value.items()}
    if isinstance(value, (list, tuple, set, frozenset)):
        return [_clean(v) for v in value]
    return str(value)


def chrome_trace(spans, process_name: str = "klaraptor") -> dict:
    """Build the trace-event payload for a list of completed ``Span``s.

    Nesting is implied by the format itself: complete events on the same
    ``tid`` whose [ts, ts+dur) ranges contain one another render as a
    stack, which is exactly the thread-local containment the spans were
    recorded with.
    """
    pid = os.getpid()
    events: list[dict] = [{
        "name": "process_name",
        "ph": "M",
        "pid": pid,
        "tid": 0,
        "args": {"name": process_name},
    }]
    named_tids: set[int] = set()
    for span in spans:
        if span.tid not in named_tids:
            named_tids.add(span.tid)
            events.append({
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": span.tid,
                "args": {"name": span.thread_name or f"thread-{span.tid}"},
            })
        events.append({
            "name": span.name,
            "ph": "X",
            "ts": span.t0_ns / 1e3,      # trace-event timestamps are in us
            "dur": (span.t1_ns - span.t0_ns) / 1e3,
            "pid": pid,
            "tid": span.tid,
            "args": _clean(span.attrs),
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, spans, process_name: str = "klaraptor") -> int:
    """Write ``chrome_trace(spans)`` to ``path``; returns the span count."""
    spans = list(spans)
    payload = chrome_trace(spans, process_name=process_name)
    with open(path, "w") as f:
        json.dump(payload, f, separators=(",", ":"))
        f.write("\n")
    return len(spans)
