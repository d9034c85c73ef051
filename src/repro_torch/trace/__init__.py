"""repro_torch.trace: structured tracing, flight recorder, and timeline export.

The observability layer for the tune->serve pipeline: ``trace_span``
spans with thread-local nesting (zero-cost when no ``Tracer`` is
installed), a bounded flight-recorder ring with per-name duration
histograms, an append-only JSONL ``Ledger`` of decisions / probes /
drift / refits / spans, and Chrome trace-event export for Perfetto.

Intentionally stdlib-only and importing nothing of ``repro_torch``, so
every layer (core, introspect, kernels, telemetry, serving, launch) can
instrument itself without import cycles.  The JAX package's
``repro.trace`` with the same names, event fields and JSON output: a
trace of the port reads like one of the reference.
"""

from .chrome import chrome_trace, write_chrome_trace
from .ledger import (Ledger, LedgerTail, align_events, event_time_ns,
                     iter_ledger, ledger_summary, merge_ledgers, read_ledger)
from .span import (HISTOGRAM_BOUNDS_S, NULL_SPAN, Span, SpanHistogram,
                   Tracer, get_tracer, set_tracer, trace_span, traced,
                   tracing)

__all__ = [
    "HISTOGRAM_BOUNDS_S",
    "Ledger",
    "LedgerTail",
    "NULL_SPAN",
    "Span",
    "SpanHistogram",
    "Tracer",
    "align_events",
    "chrome_trace",
    "event_time_ns",
    "get_tracer",
    "iter_ledger",
    "ledger_summary",
    "merge_ledgers",
    "read_ledger",
    "set_tracer",
    "trace_span",
    "traced",
    "tracing",
    "write_chrome_trace",
]
