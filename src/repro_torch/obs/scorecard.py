"""The live accuracy scorecard: is the rational program still right?

KLARAPTOR's fig1 claim -- the E(D,P)-chosen config is (near-)optimal --
is reproduced offline by ``benchmarks/fig1_accuracy.py``; this module
keeps that table *continuously* updated from production shadow probes.
One row per (kernel, hw, shape-bucket) key:

  ``ratio``        observed/predicted time of the chosen config (a ring of
                   the last N probes; 1.0 = the model is calibrated)
  ``calibration``  p10/p50/p90 of the ratio ring -- the multiplicative
                   correction band a consumer should apply to predictions
  ``rank``         estimated rank of the chosen config among the driver's
                   current feasible candidates, after calibrating every
                   prediction by the median ratio (1 = still picking the
                   winner; computed on demand, needs the registry)
  ``within_slo``   is the median ratio inside the acceptance band?

The scorecard subscribes to a ``MetricsBus`` (``attach``) so live probes
and ledger replays feed it identically.  A refit for a kernel clears that
kernel's rings -- the new fit deserves a clean record -- and stamps the
rows with the new tuning version.

Every probe also appends one labeled corpus row (bounded ring):
(kernel, hw, bucket, D, config, predicted_s, observed_s, tuning_version)
-- the training records a learned prior over configs would need.
``write_corpus`` dumps them as JSONL.
"""

from __future__ import annotations

import json
from collections import deque

__all__ = ["Scorecard", "ScoreRow"]


def _bucket_of(D: dict) -> str:
    from ..telemetry.record import bucket_label, shape_bucket
    return bucket_label(shape_bucket(D))


def _bucket_str(b) -> str:
    # Live telemetry emits the label string ("k12,m12,n12"); other
    # producers (DriftEvent, JSON round-trips) may carry the tuple form
    # (("k", 12), ...) or a plain list of parts.  Normalize so row keys
    # match across sources.
    if isinstance(b, (list, tuple)):
        return ",".join(
            f"{p[0]}{p[1]}" if isinstance(p, (list, tuple)) and len(p) == 2
            else str(p) for p in b)
    return str(b)


class ScoreRow:
    """Accumulated accuracy state for one (kernel, hw, bucket) key."""

    __slots__ = ("kernel", "hw", "bucket", "ratios", "launches", "probes",
                 "drifts", "refits", "last_D", "last_config",
                 "last_predicted_s", "last_observed_s", "rel_error_ewma",
                 "tuning_version")

    def __init__(self, kernel: str, hw: str, bucket: str, ring: int):
        self.kernel = kernel
        self.hw = hw
        self.bucket = bucket
        self.ratios: deque = deque(maxlen=ring)
        self.launches = 0
        self.probes = 0
        self.drifts = 0
        self.refits = 0
        self.last_D: dict | None = None
        self.last_config: dict | None = None
        self.last_predicted_s: float | None = None
        self.last_observed_s: float | None = None
        self.rel_error_ewma: float | None = None
        self.tuning_version = None

    def calibration(self) -> dict | None:
        """p10/p50/p90 of the ratio ring (None until a probe lands)."""
        if not self.ratios:
            return None
        s = sorted(self.ratios)

        def q(p: float) -> float:
            # Deterministic nearest-rank-with-interpolation, same contract
            # as the histogram quantiles: replay must agree exactly.
            idx = p * (len(s) - 1)
            lo = int(idx)
            hi = min(lo + 1, len(s) - 1)
            return s[lo] + (idx - lo) * (s[hi] - s[lo])
        return {"p10": q(0.10), "p50": q(0.50), "p90": q(0.90)}


class Scorecard:
    """Continuously updated predicted-vs-observed accuracy table.

    ``band`` is the acceptance band on the median observed/predicted
    ratio -- the scorecard's own SLO (default: within [0.8, 1.25], i.e.
    predictions good to ~25% either way, the paper's "close enough to
    rank configs correctly" regime).  ``ring`` bounds per-key memory.
    """

    def __init__(self, band: tuple = (0.8, 1.25), ring: int = 256,
                 corpus_cap: int = 65536):
        self.band = (float(band[0]), float(band[1]))
        self.ring = int(ring)
        self.rows: dict[str, ScoreRow] = {}
        self.corpus: deque = deque(maxlen=int(corpus_cap))

    # -- feeding -------------------------------------------------------------
    def attach(self, bus) -> "Scorecard":
        """Subscribe to a MetricsBus; returns self for chaining."""
        bus.subscribe(self.on_event)
        return self

    def _row(self, kernel: str, hw: str, bucket: str) -> ScoreRow:
        key = f"{kernel}|{hw}|{bucket}"
        row = self.rows.get(key)
        if row is None:
            row = self.rows[key] = ScoreRow(kernel, hw, bucket, self.ring)
        return row

    def on_event(self, wall_ns: int, event: dict) -> None:
        """Bus subscriber: fold one ledger-shaped event into the table."""
        etype = event.get("type")
        if etype == "choice":
            D = event.get("D")
            if not isinstance(D, dict):
                return
            row = self._row(event.get("kernel", "?"), event.get("hw", "?"),
                            _bucket_of(D))
            row.launches += int(event.get("n_coalesced") or 1)
            row.last_D = dict(D)
            cfg = event.get("config")
            if isinstance(cfg, dict):
                row.last_config = dict(cfg)
        elif etype == "probe":
            row = self._row(event.get("kernel", "?"), event.get("hw", "?"),
                            _bucket_str(event.get("bucket", "?")))
            row.probes += 1
            pred = event.get("predicted_s")
            obs = event.get("observed_s")
            if event.get("rel_error_ewma") is not None:
                row.rel_error_ewma = float(event["rel_error_ewma"])
            if isinstance(event.get("D"), dict):
                row.last_D = dict(event["D"])
            if pred and obs is not None:
                row.last_predicted_s = float(pred)
                row.last_observed_s = float(obs)
                row.ratios.append(float(obs) / float(pred))
                self.corpus.append({
                    "kernel": row.kernel, "hw": row.hw,
                    "bucket": row.bucket,
                    "D": row.last_D, "config": row.last_config,
                    "predicted_s": float(pred), "observed_s": float(obs),
                    "tuning_version": row.tuning_version,
                })
        elif etype == "drift":
            row = self._row(event.get("kernel", "?"), event.get("hw", "?"),
                            _bucket_str(event.get("bucket", "?")))
            row.drifts += 1
        elif etype == "refit":
            if not event.get("succeeded"):
                return
            kernel = event.get("kernel", "?")
            version = event.get("cache_version")
            # A hot-swapped fit covers the whole kernel (all buckets on
            # this hw): clear every matching ring so the old fit's errors
            # don't condemn the new one, and stamp the new version.
            for row in self.rows.values():
                if row.kernel == kernel:
                    row.ratios.clear()
                    row.refits += 1
                    row.tuning_version = version

    # -- SLO / enrichment ----------------------------------------------------
    def within_slo(self, row: ScoreRow) -> bool | None:
        cal = row.calibration()
        if cal is None:
            return None
        return self.band[0] <= cal["p50"] <= self.band[1]

    def enrich(self, key: dict) -> dict:
        """SLOEngine enrichment hook: flesh out a breached key with the
        freshest probe context so the retune farm gets a workable drift
        event.  A coarse key (kernel only, from the padding-waste rule)
        resolves to that kernel's busiest row.
        """
        kernel = key.get("kernel")
        candidates = [r for r in self.rows.values()
                      if r.kernel == kernel
                      and key.get("hw") in (None, "?", r.hw)
                      and key.get("bucket") in (None, "?", r.bucket)]
        if not candidates:
            return {}
        row = max(candidates, key=lambda r: (r.launches, r.probes))
        out: dict = {"hw": row.hw, "bucket": row.bucket}
        if row.last_D is not None:
            out["D"] = dict(row.last_D)
        if row.last_config is not None:
            out["config"] = dict(row.last_config)
        if row.rel_error_ewma is not None:
            out["rel_error_ewma"] = row.rel_error_ewma
        if row.last_predicted_s is not None:
            out["predicted_s"] = row.last_predicted_s
        if row.last_observed_s is not None:
            out["observed_s"] = row.last_observed_s
        return out

    # -- rank estimate -------------------------------------------------------
    def rank_estimate(self, row: ScoreRow) -> int | None:
        """Estimated rank of the chosen config among current candidates.

        Calibrates every feasible candidate's predicted time by the key's
        median observed/predicted ratio and counts how many would beat
        the chosen config's *observed* time: rank 1 means the driver is
        still picking the winner even after correcting its optimism.
        Needs the live registry (returns None offline).
        """
        cal = row.calibration()
        if cal is None or row.last_D is None \
                or row.last_observed_s is None:
            return None
        try:
            from ..core.driver import registry
            driver = registry.get(row.kernel)
        except Exception:
            return None
        if driver is None:
            return None
        try:
            table = driver.candidates(row.last_D)
            preds = driver.estimate_batch(row.last_D, table)
        except Exception:
            return None
        better = sum(1 for p in preds
                     if float(p) * cal["p50"] < row.last_observed_s)
        return min(better + 1, len(preds)) if len(preds) else None

    # -- rendering -----------------------------------------------------------
    def as_rows(self, with_rank: bool = False) -> list[dict]:
        out = []
        for key in sorted(self.rows):
            r = self.rows[key]
            cal = r.calibration()
            d: dict = {
                "kernel": r.kernel, "hw": r.hw, "bucket": r.bucket,
                "launches": r.launches, "probes": r.probes,
                "drifts": r.drifts, "refits": r.refits,
                "ratio_last": (r.ratios[-1] if r.ratios else None),
                "calibration": cal,
                "rel_error_ewma": r.rel_error_ewma,
                "tuning_version": r.tuning_version,
                "within_slo": self.within_slo(r),
            }
            if with_rank:
                d["rank"] = self.rank_estimate(r)
            out.append(d)
        return out

    def to_json(self, with_rank: bool = False) -> str:
        return json.dumps({"band": list(self.band),
                           "rows": self.as_rows(with_rank=with_rank)},
                          sort_keys=True)

    def render_text(self, with_rank: bool = False) -> str:
        """Fixed-width terminal table (the fig1 analogue, live)."""
        headers = ["kernel", "hw", "bucket", "launches", "probes",
                   "ratio p50", "p10..p90", "drift ewma", "rank", "slo"]
        body = []
        for d in self.as_rows(with_rank=with_rank):
            cal = d["calibration"]
            body.append([
                d["kernel"], d["hw"], d["bucket"],
                str(d["launches"]), str(d["probes"]),
                f"{cal['p50']:.3f}" if cal else "-",
                (f"{cal['p10']:.2f}..{cal['p90']:.2f}" if cal else "-"),
                (f"{d['rel_error_ewma']:.3f}"
                 if d["rel_error_ewma"] is not None else "-"),
                str(d.get("rank")) if d.get("rank") is not None else "-",
                {True: "ok", False: "BREACH", None: "-"}[d["within_slo"]],
            ])
        widths = [max(len(h), *(len(r[i]) for r in body)) if body else len(h)
                  for i, h in enumerate(headers)]
        lines = ["  ".join(h.ljust(w) for h, w in zip(headers, widths)),
                 "  ".join("-" * w for w in widths)]
        lines += ["  ".join(c.ljust(w) for c, w in zip(row, widths))
                  for row in body]
        return "\n".join(lines)

    # -- corpus --------------------------------------------------------------
    def corpus_rows(self) -> list[dict]:
        return list(self.corpus)

    def write_corpus(self, path) -> int:
        """Append the accumulated labeled rows as JSONL; returns count.

        One fully labeled (workload, config, predicted, observed) example
        per line.
        """
        n = 0
        with open(path, "a") as f:
            for row in self.corpus:
                f.write(json.dumps(row, sort_keys=True,
                                   separators=(",", ":"), default=str))
                f.write("\n")
                n += 1
        return n
