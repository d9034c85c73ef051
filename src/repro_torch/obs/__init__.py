"""repro_torch.obs: windowed series over the events the port emits.

``series`` holds the ``MetricsBus`` and its windowed counters, gauges and
histograms, fed the *same* event dicts the flight ledger persists (the
telemetry loop's choices, probes, drift and refits, the tracer's spans),
so offline replay of one or many ledgers rebuilds the live series
bit-identically.  With no bus installed the dispatch path does no
observability work (one module-global ``is None`` check, as for the
choice listener and the tracer).

The reference's ``obs.slo`` (burn-rate rules), ``obs.scorecard`` and the
``Observatory`` that wires them are not ported yet: they feed the fleet's
``RetuneQueue`` (ROADMAP Queue A item 5).
"""

from .series import (MetricsBus, WindowedCounter, WindowedGauge,
                     WindowedHistogram, get_metrics_bus, label_str,
                     parse_label_str, replay_into, set_metrics_bus)

__all__ = [
    "MetricsBus",
    "WindowedCounter",
    "WindowedGauge",
    "WindowedHistogram",
    "get_metrics_bus",
    "label_str",
    "parse_label_str",
    "replay_into",
    "set_metrics_bus",
]
