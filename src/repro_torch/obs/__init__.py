"""repro_torch.obs: the observatory -- series, SLOs, scorecard.

Sits on top of what the telemetry loop and tracing emit and turns it into
operable signal:

  ``series``     windowed time-series (counters / gauges / histograms)
                 behind a ``MetricsBus`` fed the *same* event dicts the
                 flight ledger persists -- so offline replay of one or
                 many ledgers rebuilds the live series bit-identically
  ``slo``        declarative burn-rate SLO rules whose breaches land in
                 the ledger AND jump the fleet's retune queue
  ``scorecard``  the continuously updated Fig. 1-style predicted-vs-observed
                 accuracy table, plus the labeled corpus of probes

``Observatory`` wires the three together for a serving process;
``replay_ledgers`` builds the same stack offline for post-mortems.  With
no bus installed the dispatch path does no observability work (one
module-global ``is None`` check, as for the choice listener and the
tracer).
"""

from __future__ import annotations

import os

from ..trace import Ledger, get_tracer

from .scorecard import Scorecard, ScoreRow
from .series import (MetricsBus, WindowedCounter, WindowedGauge,
                     WindowedHistogram, get_metrics_bus, label_str,
                     parse_label_str, replay_into, set_metrics_bus)
from .slo import (GaugeRule, HistogramQuantileRule, RatioRule, SLOAlert,
                  SLOEngine, SLORule, default_rules)

__all__ = [
    "GaugeRule",
    "HistogramQuantileRule",
    "MetricsBus",
    "Observatory",
    "RatioRule",
    "SLOAlert",
    "SLOEngine",
    "SLORule",
    "Scorecard",
    "ScoreRow",
    "WindowedCounter",
    "WindowedGauge",
    "WindowedHistogram",
    "default_rules",
    "get_metrics_bus",
    "label_str",
    "parse_label_str",
    "replay_into",
    "replay_ledgers",
    "set_metrics_bus",
]


class Observatory:
    """One serving process's observability stack, wired end to end.

    ``ledger`` (or the one already attached to ``telemetry``) anchors the
    bus's wall<->monotonic mapping and receives SLO alert lines; ``queue``
    (a ``fleet.RetuneQueue``) receives boosted keys from retune-marked
    breaches, with the scorecard enriching each key with its freshest
    probe context so the farm gets a workable drift event.

    ``install()`` makes the bus the process-wide metrics bus (taps the
    choice listener / telemetry loop emissions) and attaches it as the
    tracer's span sink if a tracer is installed; ``uninstall()`` restores
    the zero-cost path.  Usable as a context manager.
    """

    def __init__(self, telemetry=None, ledger=None, rules=None, queue=None,
                 window_s: float = 1.0, n_windows: int = 600,
                 band: tuple = (0.8, 1.25)):
        if ledger is None and telemetry is not None:
            ledger = telemetry.ledger
        if ledger is not None and not isinstance(ledger, Ledger):
            ledger = Ledger(ledger)
        self.ledger = ledger
        self.telemetry = telemetry
        self.queue = queue
        self.bus = MetricsBus(window_s=window_s, n_windows=n_windows)
        if ledger is not None and ledger.anchor is not None:
            # Feed the ledger's session anchor through ingest (not the
            # constructor) so the live bus sees the same event stream a
            # replay of this ledger will: anchor, wall alignment and the
            # event count all match bit-for-bit.
            self.bus.ingest({"type": "session", "pid": os.getpid(),
                             **ledger.anchor})
        self.scorecard = Scorecard(band=band).attach(self.bus)
        self.slo = SLOEngine(rules=rules, ledger=ledger, queue=queue,
                             enrich=self.scorecard.enrich)
        self._sank_tracer = None

    # -- lifecycle -----------------------------------------------------------
    def install(self) -> "Observatory":
        set_metrics_bus(self.bus)
        t = get_tracer()
        if t is not None:
            t.span_sink = self.bus.ingest
            self._sank_tracer = t
        return self

    def uninstall(self) -> None:
        if get_metrics_bus() is self.bus:
            set_metrics_bus(None)
        if self._sank_tracer is not None:
            self._sank_tracer.span_sink = None
            self._sank_tracer = None

    def __enter__(self) -> "Observatory":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # -- operation -----------------------------------------------------------
    def evaluate(self, now_ns: int | None = None):
        """One SLO evaluation tick (see ``SLOEngine.evaluate``)."""
        return self.slo.evaluate(self.bus, now_ns)

    def snapshot(self) -> dict:
        """One JSON-able health document: series + scorecard + SLO state."""
        return {
            "series": self.bus.snapshot(),
            "scorecard": self.scorecard.as_rows(),
            "slo": {
                "firing": sorted(f"{r}:{k}" if k else r
                                 for r, k in self.slo.firing),
                "alerts": len(self.slo.alerts),
            },
            "queue": (self.queue.summary()
                      if self.queue is not None else None),
        }

    def prometheus(self, prefix: str = "klaraptor_obs_") -> str:
        return self.bus.prometheus(prefix=prefix)


def replay_ledgers(paths, rules=None, queue=None,
                   band: tuple = (0.8, 1.25), window_s: float = 1.0,
                   n_windows: int = 600, strict: bool = False) -> Observatory:
    """Rebuild an Observatory offline from one or many JSONL ledgers.

    Single ledger: the resulting ``bus.snapshot()`` is bit-identical to
    the live bus that watched the same run (same event dicts, same
    anchored timestamps, same window rotation).  Many ledgers: events are
    wall-ordered across processes first (``merge_ledgers``).  ``rules``
    + ``queue`` let a post-mortem re-run SLO evaluation against history.
    """
    obs = Observatory(rules=rules, queue=queue, band=band,
                      window_s=window_s, n_windows=n_windows)
    replay_into(obs.bus, paths, strict=strict)
    return obs
