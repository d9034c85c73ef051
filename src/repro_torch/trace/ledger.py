"""The flight ledger: an append-only JSONL record of everything decided.

Where the span ring (``repro_torch.trace.span``) answers "where did time go in
this process", the ledger answers "what did the system decide, predict and
observe -- ever".  One JSON object per line, ``type``-tagged:

  ``session`` one wall<->monotonic anchor per ledger open (see below)
  ``choice``  one (possibly coalesced) launch decision (from ChoiceEvents)
  ``probe``   a shadow probe: predicted vs observed seconds, rel-error EWMA
  ``drift``   a DriftDetector trip
  ``refit``   a RefitController outcome (search/fit/validate/swap)
  ``alert``   an SLO burn-rate breach/resolve (the reference's ``obs.slo``)
  ``bucket_step`` one bucketed-dispatch outcome from a serving decode step
  ``span``    a completed tracing span (when a Tracer carries the ledger)

Timestamp semantics: events stamp ``t_ns`` (or ``t0_ns`` for spans) on the
*monotonic* clock, which orders correctly within one process but means
nothing across processes or restarts.  The ``session`` header written at
every ``Ledger`` open carries one simultaneous (``wall_ns``, ``mono_ns``)
reading, so readers can align any later stamp to wall-clock time --
``wall = wall_ns + (t - mono_ns)`` under the most recent preceding anchor.
``align_events`` applies that per event and ``merge_ledgers`` interleaves
many processes' ledgers into one wall-clock-ordered stream (the
multi-process replay path of ``repro_torch.obs``).

Steady-state write volume inherits the driver's coalescing accounting: a
memo-hit storm writes one ``choice`` line per coalescing window, not one
per launch.  ``iter_ledger``/``read_ledger`` + ``ledger_summary`` are the
query side (the reference's ``launch.status`` reads them; the port's
waits with ``launch/status.py``); ``LedgerTail`` is the incremental form
(byte offsets advanced only past complete lines) that the reference's
``fleet.RetuneQueue``, ``status --follow`` and live dashboard share.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time

__all__ = ["Ledger", "LedgerTail", "align_events", "event_time_ns",
           "iter_ledger", "ledger_summary", "merge_ledgers", "read_ledger"]

logger = logging.getLogger(__name__)


class Ledger:
    """Append-only JSONL event sink; thread-safe; flushes every line.

    Opened in append mode by default so successive runs accumulate into
    one auditable history; pass ``mode="w"`` to truncate.  Every open
    writes one ``session`` anchor line -- a simultaneous wall/monotonic
    clock reading -- so readers can align this session's monotonic stamps
    to wall time (``anchor=False`` suppresses it for raw sinks).
    """

    def __init__(self, path, mode: str = "a", anchor: bool = True):
        self.path = str(path)
        self._f = open(self.path, mode)
        self._lock = threading.Lock()
        self.n_written = 0
        self.anchor: dict | None = None
        if anchor:
            self.anchor = {"wall_ns": time.time_ns(),
                           "mono_ns": time.monotonic_ns()}
            self.append({"type": "session", "pid": os.getpid(),
                         **self.anchor})

    def append(self, event: dict) -> None:
        line = json.dumps(event, sort_keys=True, separators=(",", ":"),
                          default=str)
        with self._lock:
            self._f.write(line)
            self._f.write("\n")
            self._f.flush()
            self.n_written += 1

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()

    def __enter__(self) -> "Ledger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def iter_ledger(path, strict: bool = False):
    """Stream a JSONL ledger as event dicts, one at a time.

    The streaming core behind ``read_ledger``: O(1) memory however long
    the flight history, so ``ledger_summary``, the drift queue and the
    observatory replay can consume week-long ledgers without loading them
    whole.  Same corruption contract as ``read_ledger``: a torn *final*
    line (process killed mid-write) is always dropped; corrupt *mid-file*
    lines are skipped and counted (one warning per pass) by default, or
    raise under ``strict=True``.
    """
    skipped = 0
    pending_err: json.JSONDecodeError | None = None
    with open(path) as f:
        for line in f:
            # Any following line -- even a blank one -- proves the held
            # corrupt line was mid-file, not the torn tail.
            if pending_err is not None:
                if strict:
                    raise pending_err
                skipped += 1
                pending_err = None
            if not line.strip():
                continue
            try:
                event = json.loads(line)
            except json.JSONDecodeError as e:
                pending_err = e     # held: torn tail if nothing follows
                continue
            yield event
    if skipped:
        logger.warning("ledger %s: skipped %d corrupt mid-file line(s)",
                       path, skipped)


def read_ledger(path, strict: bool = False) -> list[dict]:
    """Parse a whole JSONL ledger back into a list of event dicts.

    Convenience wrapper over ``iter_ledger`` (which see for the torn-tail
    / ``strict`` semantics); prefer the iterator for anything that only
    folds over events once.
    """
    return list(iter_ledger(path, strict=strict))


class LedgerTail:
    """Incremental reader over one growing ledger: complete lines only.

    Polls from a durable byte ``offset`` that advances only past complete
    (newline-terminated) lines, so a line the serving node is halfway
    through writing is picked up whole on the next poll -- the exact
    contract ``fleet.RetuneQueue`` persists across restarts, factored out
    here so ``status --follow`` and the live dashboard share it.  Corrupt
    lines are skipped and counted (``corrupt_lines``), never raised: a
    tail must survive a node that crashed mid-append and kept writing.
    """

    def __init__(self, path, offset: int = 0):
        self.path = os.path.abspath(str(path))
        self.offset = int(offset)
        self.corrupt_lines = 0

    def poll(self) -> list[dict]:
        """Events appended since the last poll (empty if none complete)."""
        try:
            with open(self.path, "rb") as f:
                f.seek(self.offset)
                chunk = f.read()
        except OSError:
            return []
        cut = chunk.rfind(b"\n")
        if cut < 0:
            return []           # no complete new line yet
        self.offset += cut + 1
        events: list[dict] = []
        for line in chunk[:cut + 1].decode("utf-8",
                                           errors="replace").splitlines():
            if not line.strip():
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                self.corrupt_lines += 1
        return events


def event_time_ns(event: dict) -> int | None:
    """Monotonic stamp of one event: ``t_ns``, or span end for spans."""
    t = event.get("t_ns")
    if t is not None:
        return int(t)
    t0 = event.get("t0_ns")
    if t0 is not None:
        # Spans stamp their start; the *end* is when the record landed.
        return int(t0) + int(float(event.get("dur_s", 0.0)) * 1e9)
    return None


def align_events(events):
    """Yield ``(wall_ns, event)`` pairs, wall-aligned via session anchors.

    Each event's monotonic stamp is mapped through the most recent
    preceding ``session`` anchor (``wall = anchor_wall + (t - anchor_mono)``).
    Events with no stamp, or before any anchor, inherit the last assigned
    wall time so file order is preserved for them.
    """
    wall_anchor: int | None = None
    mono_anchor: int | None = None
    last_wall = 0
    for ev in events:
        if ev.get("type") == "session" and "mono_ns" in ev:
            wall_anchor = int(ev["wall_ns"])
            mono_anchor = int(ev["mono_ns"])
            last_wall = wall_anchor
            yield wall_anchor, ev
            continue
        t = event_time_ns(ev)
        if t is not None and mono_anchor is not None:
            w = wall_anchor + (t - mono_anchor)
        else:
            w = last_wall
        last_wall = w
        yield w, ev


def merge_ledgers(paths, strict: bool = False) -> list[dict]:
    """Interleave many processes' ledgers into one wall-ordered stream.

    Returns event dicts (copies) with a ``wall_ns`` key injected, sorted
    by wall time; ties keep (path order, file order) so the merge is
    deterministic.  This is what makes serving-node and fleet-worker
    ledgers -- each stamped on its own monotonic clock -- aggregate into
    one post-mortem timeline.
    """
    tagged: list[tuple[int, int, int, dict]] = []
    for pi, path in enumerate(paths):
        for si, (wall, ev) in enumerate(
                align_events(iter_ledger(path, strict=strict))):
            tagged.append((wall, pi, si, ev))
    tagged.sort(key=lambda t: t[:3])
    return [{**ev, "wall_ns": wall} for wall, _, _, ev in tagged]


def ledger_summary(events) -> dict:
    """Aggregate ledger events into the status-dashboard shape.

    Accepts any iterable (one pass -- pair with ``iter_ledger`` to stay
    O(1) in memory).  Coalesced choice events count with their
    ``n_coalesced`` weight, so launch totals match what the telemetry
    exporter would have counted live.  Rel-error rows keep the *last*
    EWMA per key (it is already a running average).
    """
    n_events = 0
    by_type: dict[str, int] = {}
    kernels: dict[str, dict] = {}
    rel_error: dict[str, dict] = {}
    spans: dict[str, dict] = {}
    drift_events: list[dict] = []
    refits: list[dict] = []
    alerts: list[dict] = []
    choices_total = 0
    choice_lines = 0

    for ev in events:
        n_events += 1
        kind = ev.get("type", "?")
        by_type[kind] = by_type.get(kind, 0) + 1
        if kind == "choice":
            n = int(ev.get("n_coalesced", 1))
            choices_total += n
            choice_lines += 1
            k = kernels.setdefault(ev.get("kernel", "?"),
                                   {"launches": 0, "by_source": {}})
            k["launches"] += n
            src = ev.get("source", "?")
            k["by_source"][src] = k["by_source"].get(src, 0) + n
        elif kind == "probe":
            key = "{} {} {}".format(ev.get("kernel", "?"), ev.get("hw", "?"),
                                    ev.get("bucket", "?"))
            row = rel_error.setdefault(key, {"probes": 0, "rel_error_ewma": 0.0})
            row["probes"] += 1
            if ev.get("rel_error_ewma") is not None:
                row["rel_error_ewma"] = ev["rel_error_ewma"]
        elif kind == "drift":
            drift_events.append(ev)
        elif kind == "refit":
            refits.append(ev)
        elif kind == "alert":
            alerts.append(ev)
        elif kind == "span":
            row = spans.setdefault(ev.get("name", "?"),
                                   {"count": 0, "total_s": 0.0, "max_s": 0.0})
            row["count"] += 1
            dur = float(ev.get("dur_s", 0.0))
            row["total_s"] += dur
            if dur > row["max_s"]:
                row["max_s"] = dur

    return {
        "n_events": n_events,
        "by_type": by_type,
        "choices_total": choices_total,
        "choice_lines": choice_lines,
        "kernels": kernels,
        "rel_error": rel_error,
        "drift_events": drift_events,
        "refits": refits,
        "alerts": alerts,
        "spans": spans,
    }
