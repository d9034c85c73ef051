"""Acting SLOs: burn-rate rules over the metrics bus that *do* something.

A KLARAPTOR serving fleet has a small set of health invariants -- launches
should come from the driver (not the default fallback), bucketed dispatch
should hit its lattice with bounded padding waste, prediction error should
stay under the drift threshold, refits should be fast and rare.  This
module makes each one a declarative ``SLORule`` evaluated against the
windowed series of a ``MetricsBus``, with the SRE-standard multi-window
burn-rate criterion: a rule breaches only when BOTH its fast window (is it
bad *right now*?) and its slow window (has it been bad *long enough to
matter*?) burn their error budget faster than the allowed multiple.  That
double gate is what keeps a single noisy decode step from paging anyone
while still catching real regressions in under a minute.

Breaches *act*, twice:

  1. a structured ``alert`` event is appended to the flight ledger (and
     ingested into the bus through the same dict, so alert history replays
     with everything else), and
  2. rules marked ``retune=True`` push a synthetic drift-shaped event into
     ``fleet.RetuneQueue.enqueue`` with a priority boost, so the breached
     (kernel, hw, bucket) key jumps the farm's drain order -- this is the
     padding-waste SLO surfaced through the fleet retune queue.

``default_rules()`` is the recommended fleet posture; every threshold is a
constructor argument for fleets that disagree.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .series import MetricsBus, parse_label_str as _parse_labels

__all__ = ["GaugeRule", "HistogramQuantileRule", "RatioRule", "SLOAlert",
           "SLOEngine", "SLORule", "default_rules"]


@dataclass
class SLORule:
    """One health invariant: an objective plus burn-rate windows.

    ``objective`` is the *maximum acceptable* value of the measured signal
    (a rate, a fraction, a gauge, a quantile -- subclasses define which).
    Burn rate is ``value / objective``; the rule breaches when the fast
    window burns >= ``fast_burn`` AND the slow window burns >=
    ``slow_burn``, each with at least ``min_events`` contributing samples.
    ``budget_period_s`` sizes the error budget: ``budget_used`` reported
    on alerts is the fraction of one period's budget the slow window's
    burn would consume.
    """

    name: str
    objective: float
    fast_window_s: float = 60.0
    slow_window_s: float = 300.0
    fast_burn: float = 2.0
    slow_burn: float = 1.0
    min_events: float = 1.0
    budget_period_s: float = 3600.0
    severity: str = "page"
    retune: bool = False
    retune_boost: float = 1e3

    def measure(self, bus: MetricsBus, now_ns: int,
                window_ns: int) -> list[tuple[dict | None, float, float]]:
        """Return ``(key_labels, value, n_samples)`` per monitored key.

        ``key_labels`` is None for fleet-global rules, a label dict for
        per-key rules (those can breach independently per key).
        """
        raise NotImplementedError

    def burn(self, value: float) -> float:
        return value / self.objective if self.objective > 0 else float("inf")


@dataclass
class RatioRule(SLORule):
    """num/den over a window: fallback rate, miss rate, padding waste.

    ``num``/``den`` are ``(counter_name, label_match)`` pairs summed with
    ``MetricsBus.sum_counters``.  With ``group_by`` set, the ratio is
    computed independently per distinct value of those labels found in
    the denominator family (per-kernel padding waste, say), and each
    group can breach on its own.
    """

    num: tuple = ("", {})
    den: tuple = ("", {})
    group_by: tuple = ()

    def _groups(self, bus: MetricsBus) -> list[dict | None]:
        if not self.group_by:
            return [None]
        fam = bus.counters.get(self.den[0], {})
        seen: dict[tuple, dict] = {}
        for key in fam:
            labels = _parse_labels(key)
            if all(labels.get(k) == v for k, v in self.den[1].items()):
                g = tuple((k, labels.get(k, "?")) for k in self.group_by)
                seen.setdefault(g, dict(g))
        return sorted(seen.values(), key=str) or []

    def measure(self, bus, now_ns, window_ns):
        out = []
        for group in self._groups(bus):
            extra = group or {}
            n = bus.sum_counters(self.den[0], now_ns, window_ns,
                                 **{**self.den[1], **extra})
            if n <= 0:
                out.append((group, 0.0, 0.0))
                continue
            v = bus.sum_counters(self.num[0], now_ns, window_ns,
                                 **{**self.num[1], **extra})
            out.append((group, v / n, n))
        return out


@dataclass
class GaugeRule(SLORule):
    """Window-last of a gauge family, per label set: drift EWMA.

    Each labeled gauge (one per (kernel, hw, bucket) for drift) is its
    own monitored key; the measured value is the most recent sample that
    landed inside the window.
    """

    gauge: str = ""

    def measure(self, bus, now_ns, window_ns):
        out = []
        fam = bus.gauges.get(self.gauge, {})
        for key in sorted(fam):
            v = fam[key].last_over(now_ns, window_ns)
            if v is None:
                continue
            out.append((_parse_labels(key), abs(v), 1.0))
        return out


@dataclass
class HistogramQuantileRule(SLORule):
    """Windowed quantile of a histogram family: refit latency p95."""

    histogram: str = ""
    q: float = 0.95

    def measure(self, bus, now_ns, window_ns):
        out = []
        fam = bus.histograms.get(self.histogram, {})
        for key in sorted(fam):
            h = fam[key]
            v = h.quantile_over(now_ns, window_ns, self.q)
            if v is None:
                continue
            n = sum(sum(h.windows.get(i, ()))
                    for i in h._span_indices(now_ns, window_ns))
            out.append((_parse_labels(key) or None, v, float(n)))
        return out


def default_rules() -> list[SLORule]:
    """The recommended fleet posture, one rule per health invariant."""
    return [
        # <=2% of launches may fall back to the static default config.
        RatioRule(name="fallback_rate", objective=0.02,
                  num=("choices", {"source": "default"}),
                  den=("choices", {})),
        # <=10% of bucketed decode steps may miss the lattice.
        RatioRule(name="bucket_miss_rate", objective=0.10,
                  num=("bucket_steps", {"outcome": "miss"}),
                  den=("bucket_steps", {})),
        # <=35% mean padding waste per kernel; breaches retune that
        # kernel's keys.
        RatioRule(name="padding_waste", objective=0.35,
                  num=("padding_waste_sum", {}),
                  den=("bucket_steps", {}),
                  group_by=("kernel",), retune=True),
        # drift EWMA per (kernel, hw, bucket) under the detector's own
        # default threshold; breaches jump the retune queue.
        GaugeRule(name="drift_ewma", objective=0.25,
                  gauge="rel_error_ewma", retune=True),
        # refit p95 wall latency <=30s -- a slow refit steals serving time.
        HistogramQuantileRule(name="refit_latency", objective=30.0,
                              histogram="refit_wall_s", q=0.95,
                              min_events=2.0, severity="ticket"),
    ]


@dataclass
class SLOAlert:
    """One breach/resolve transition, ledger-ready via ``to_event``."""

    slo: str
    state: str                  # "breach" | "resolve"
    key: dict | None
    value: float
    objective: float
    burn_fast: float
    burn_slow: float
    budget_used: float
    severity: str
    t_ns: int | None = None
    extras: dict = field(default_factory=dict)

    def to_event(self) -> dict:
        ev = {"type": "alert", "slo": self.slo, "state": self.state,
              "value": self.value, "objective": self.objective,
              "burn_fast": self.burn_fast, "burn_slow": self.burn_slow,
              "budget_used": self.budget_used, "severity": self.severity}
        if self.key:
            ev["key"] = dict(self.key)
        if self.t_ns is not None:
            ev["t_ns"] = self.t_ns
        ev.update(self.extras)
        return ev


class SLOEngine:
    """Evaluate rules against a bus; emit transitions; act on breaches.

    ``ledger``/``queue`` are optional sinks: alerts append to the ledger
    (and ingest into the bus through the same dict -- the one-dict replay
    contract), retune-marked breaches enqueue into the ``RetuneQueue``.
    ``enrich(key_labels)`` (optional) returns extra fields (``D``,
    ``config``, ``rel_error_ewma`` ...) folded into the synthetic drift
    event so the farm can actually retune the key -- the observatory
    wires the scorecard's per-key memory in here.

    State is per (rule, key): only *transitions* emit alerts, so a
    sustained breach is one ledger line, not one per evaluation tick.
    """

    def __init__(self, rules=None, ledger=None, queue=None, enrich=None):
        self.rules: list[SLORule] = (list(rules) if rules is not None
                                     else default_rules())
        self.ledger = ledger
        self.queue = queue
        self.enrich = enrich
        self.firing: dict[tuple[str, str], dict] = {}
        self.alerts: list[SLOAlert] = []

    def evaluate(self, bus: MetricsBus,
                 now_ns: int | None = None) -> list[SLOAlert]:
        """One evaluation tick; returns the transitions it emitted.

        ``now_ns`` is *wall* nanoseconds; default is the bus's last event
        time, which makes offline replay evaluation deterministic (no
        clock read).
        """
        now = int(now_ns) if now_ns is not None else bus.last_wall_ns
        out: list[SLOAlert] = []
        for rule in self.rules:
            fast_ns = int(rule.fast_window_s * 1e9)
            slow_ns = int(rule.slow_window_s * 1e9)
            fast = {self._key_id(k): (k, v, n)
                    for k, v, n in rule.measure(bus, now, fast_ns)}
            slow = {self._key_id(k): (k, v, n)
                    for k, v, n in rule.measure(bus, now, slow_ns)}
            for kid, (key, v_slow, n_slow) in slow.items():
                k_fast = fast.get(kid)
                v_fast, n_fast = (k_fast[1], k_fast[2]) if k_fast \
                    else (0.0, 0.0)
                burn_fast = rule.burn(v_fast)
                burn_slow = rule.burn(v_slow)
                breached = (n_fast >= rule.min_events
                            and n_slow >= rule.min_events
                            and burn_fast >= rule.fast_burn
                            and burn_slow >= rule.slow_burn)
                fid = (rule.name, kid)
                was = fid in self.firing
                if breached == was:
                    continue
                budget_used = burn_slow * (rule.slow_window_s
                                           / rule.budget_period_s)
                alert = SLOAlert(
                    slo=rule.name,
                    state="breach" if breached else "resolve",
                    key=key, value=v_fast if breached else v_slow,
                    objective=rule.objective,
                    burn_fast=burn_fast, burn_slow=burn_slow,
                    budget_used=budget_used, severity=rule.severity,
                    t_ns=bus.mono_ns_of_wall(now))
                if breached:
                    self.firing[fid] = {"alert": alert}
                else:
                    self.firing.pop(fid, None)
                self._emit(bus, alert)
                if breached and rule.retune and self.queue is not None \
                        and key:
                    self._enqueue(rule, key, alert)
                out.append(alert)
                self.alerts.append(alert)
        return out

    @staticmethod
    def _key_id(key: dict | None) -> str:
        return "" if not key else ",".join(
            f"{k}={key[k]}" for k in sorted(key))

    def _emit(self, bus: MetricsBus, alert: SLOAlert) -> None:
        # One dict to both sinks: the ledger line replay reads back is the
        # exact object the live bus ingested.
        ev = alert.to_event()
        if self.ledger is not None:
            self.ledger.append(ev)
        bus.ingest(ev)

    def _enqueue(self, rule: SLORule, key: dict, alert: SLOAlert) -> None:
        """Push the breached key into the retune queue, drift-shaped."""
        event = {"type": "drift",
                 "kernel": key.get("kernel", "?"),
                 "hw": key.get("hw", "?"),
                 "bucket": key.get("bucket", "?"),
                 "rel_error_ewma": alert.value,
                 "slo": rule.name}
        if self.enrich is not None:
            extra = self.enrich(key)
            if extra:
                # Enrichment may pin down the hw/bucket a coarse rule
                # (per-kernel padding waste) could not name itself.
                event.update(extra)
        self.queue.enqueue(event, boost=rule.retune_boost)
