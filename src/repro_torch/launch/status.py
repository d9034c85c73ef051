"""Terminal status dashboard over the flight ledger / telemetry snapshot.

    python -m repro_torch.launch.status --ledger run.jsonl
    python -m repro_torch.launch.status --ledger run.jsonl --follow
    python -m repro_torch.launch.status --snapshot telemetry.json

Renders what the tuning runtime decided and observed: per-kernel
decision-source breakdown (override / plan / memo-coalesced / driver /
default), prediction rel-error EWMAs, drift + refit history, and the top
pipeline spans by cumulative time.  ``--ledger`` reads the JSONL flight
ledger written by ``Telemetry(ledger=...)`` / ``serve --ledger``;
``--snapshot`` reads a ``MetricsExporter.json()`` dump.

``--follow`` is the tail mode: after the initial render it polls the
ledger's byte offset (the same complete-lines-only contract the fleet's
retune queue uses) and prints each new decision / probe / drift / refit /
alert as a one-line record the moment it lands -- watching a serving
process live.  The text is the JAX launcher's for the same ledger; the
host reads files only, so it runs the same with or without a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from ..trace import LedgerTail, ledger_summary, read_ledger

__all__ = ["follow_ledger", "format_event", "main", "render_ledger",
           "render_snapshot", "section", "table"]

_RULE_WIDTH = 64


def section(title: str) -> list[str]:
    """Ruled section header lines (shared by the launch dashboards)."""
    pad = max(_RULE_WIDTH - len(title) - 4, 2)
    return ["", f"== {title} " + "=" * pad]


def table(headers: list[str], rows: list[list[str]]) -> list[str]:
    """Left-align the first column, right-align the rest."""
    widths = [len(h) for h in headers]
    for row in rows:
        for i, cell in enumerate(row):
            widths[i] = max(widths[i], len(cell))
    def fmt(row):
        cells = [row[0].ljust(widths[0])]
        cells += [c.rjust(w) for c, w in zip(row[1:], widths[1:])]
        return "  " + "  ".join(cells).rstrip()
    return [fmt(headers)] + [fmt(r) for r in rows]


_section = section      # original private names; other dashboards import these
_table = table


def _fmt_s(seconds: float) -> str:
    if seconds >= 1.0:
        return f"{seconds:.2f}s"
    if seconds >= 1e-3:
        return f"{seconds * 1e3:.2f}ms"
    return f"{seconds * 1e6:.1f}us"


def _span_rows(spans: list[dict]) -> list[list[str]]:
    return [[s["name"], str(s["count"]), _fmt_s(s["total_s"]),
             _fmt_s(s["total_s"] / s["count"] if s["count"] else 0.0),
             _fmt_s(s["max_s"])] for s in spans]


def render_ledger(events: list[dict], top: int = 10) -> str:
    """Render a read-back flight ledger as the terminal dashboard."""
    s = ledger_summary(events)
    lines = [f"flight ledger: {s['n_events']} events "
             + json.dumps(s["by_type"], sort_keys=True)]

    lines += _section("decisions by kernel and source")
    if s["kernels"]:
        rows = []
        for kernel in sorted(s["kernels"]):
            k = s["kernels"][kernel]
            srcs = ", ".join(f"{src}={n}" for src, n in
                             sorted(k["by_source"].items()))
            rows.append([kernel, str(k["launches"]), srcs])
        lines += _table(["kernel", "launches", "by source"], rows)
        lines.append(f"  total: {s['choices_total']} launches in "
                     f"{s['choice_lines']} ledger lines (coalesced)")
    else:
        lines.append("  (no choice events)")

    lines += _section("prediction error (rel-error EWMA)")
    if s["rel_error"]:
        rows = [[key, str(row["probes"]),
                 f"{row['rel_error_ewma']:.4f}"]
                for key, row in sorted(s["rel_error"].items())]
        lines += _table(["kernel / hw / bucket", "probes", "ewma"], rows)
    else:
        lines.append("  (no probe events)")

    lines += _section("drift and refits")
    n_ok = sum(1 for r in s["refits"] if r.get("succeeded"))
    lines.append(f"  {len(s['drift_events'])} drift events, "
                 f"{len(s['refits'])} refits "
                 f"({n_ok} swapped, {len(s['refits']) - n_ok} failed)")
    for d in s["drift_events"]:
        lines.append(f"  drift  {d.get('kernel')} bucket={d.get('bucket')} "
                     f"ewma={d.get('rel_error_ewma', 0.0):.3f}")
    for r in s["refits"]:
        status = "ok" if r.get("succeeded") else "failed"
        override = "pinned" if r.get("override") else "none"
        lines.append(
            f"  refit  {r.get('kernel')} {status} "
            f"version={r.get('cache_version')} override={override} "
            f"device_s={r.get('total_device_seconds', 0.0):.4f}")

    lines += _section(f"top spans by cumulative time (top {top})")
    if s["spans"]:
        ranked = sorted(
            ({"name": name, **row} for name, row in s["spans"].items()),
            key=lambda r: (-r["total_s"], r["name"]))[:top]
        lines += _table(["span", "count", "total", "mean", "max"],
                        _span_rows(ranked))
    else:
        lines.append("  (no span records in ledger; run with a Tracer "
                     "carrying the ledger to record them)")
    return "\n".join(lines) + "\n"


def render_snapshot(snap: dict, top: int = 10) -> str:
    """Render a ``MetricsExporter.snapshot()`` dump (global, not per-kernel:
    the exporter aggregates sources across kernels)."""
    c = snap.get("counters", {})
    g = snap.get("gauges", {})
    lines = [f"telemetry snapshot: {c.get('choices_total', 0)} decisions, "
             f"generation {g.get('registry_generation', '?')}, "
             f"{g.get('decision_memo_entries', '?')} memo entries"]

    lines += _section("decisions by source")
    by_source = c.get("choices_by_source", {})
    if by_source:
        lines += _table(["source", "launches"],
                        [[src, str(n)] for src, n in sorted(
                            by_source.items())])
    else:
        lines.append("  (no decisions recorded)")
    lines.append(f"  plan_hits={c.get('plan_hits', 0)} "
                 f"plan_misses={c.get('plan_misses', 0)} "
                 f"plan_invalidations={c.get('plan_invalidations', 0)} "
                 f"memo_invalidations={c.get('memo_invalidations', 0)}")

    lines += _section("prediction error (rel-error EWMA)")
    keys = snap.get("keys", [])
    rows = [[f"{k['kernel']} {k['hw']} {k['bucket']}", str(k["n_probes"]),
             f"{k['rel_error_ewma']:.4f}" if k.get("rel_error_ewma")
             is not None else "-"]
            for k in keys]
    if rows:
        lines += _table(["kernel / hw / bucket", "probes", "ewma"], rows)
    else:
        lines.append("  (no probed keys)")

    lines += _section("refit history")
    refits = snap.get("refits", [])
    if refits:
        for r in refits:
            status = "ok" if r.get("succeeded") else "failed"
            override = "pinned" if r.get("override") else "none"
            lines.append(
                f"  refit  {r.get('kernel')} {status} "
                f"version={r.get('cache_version')} override={override} "
                f"device_s={r.get('total_device_seconds', 0.0):.4f}")
    else:
        lines.append(f"  {c.get('drift_events_total', 0)} drift events, "
                     "0 refits recorded")

    lines += _section(f"top spans by cumulative time (top {top})")
    spans = snap.get("spans", [])
    if spans:
        lines += _table(["span", "count", "total", "mean", "max"],
                        _span_rows(spans[:top]))
    else:
        lines.append("  (snapshot carries no spans; export with a Tracer "
                     "installed)")
    return "\n".join(lines) + "\n"


def format_event(ev: dict) -> str | None:
    """One tail line per ledger event (None = not worth a line)."""
    kind = ev.get("type")
    if kind == "choice":
        n = int(ev.get("n_coalesced") or 1)
        coal = f" x{n}" if n > 1 else ""
        return (f"choice  {ev.get('kernel')} source={ev.get('source')}"
                f"{coal} predicted={_fmt_s(ev.get('predicted_s') or 0.0)}")
    if kind == "probe":
        ewma = ev.get("rel_error_ewma")
        return (f"probe   {ev.get('kernel')} bucket={ev.get('bucket')} "
                f"predicted={_fmt_s(ev.get('predicted_s') or 0.0)} "
                f"observed={_fmt_s(ev.get('observed_s') or 0.0)} "
                f"ewma={ewma:.3f}" if ewma is not None else
                f"probe   {ev.get('kernel')} bucket={ev.get('bucket')}")
    if kind == "drift":
        return (f"drift   {ev.get('kernel')} bucket={ev.get('bucket')} "
                f"ewma={ev.get('rel_error_ewma', 0.0):.3f}")
    if kind == "refit":
        status = "ok" if ev.get("succeeded") else "FAILED"
        return (f"refit   {ev.get('kernel')} {status} "
                f"version={ev.get('cache_version')} "
                f"device_s={ev.get('total_device_seconds', 0.0):.4f}")
    if kind == "alert":
        key = ev.get("key")
        where = " " + ",".join(f"{k}={v}" for k, v in sorted(key.items())) \
            if key else ""
        return (f"alert   {ev.get('slo')} {ev.get('state', '?').upper()}"
                f"{where} value={ev.get('value', 0.0):.4f} "
                f"objective={ev.get('objective', 0.0):g}")
    if kind == "session":
        return f"session pid={ev.get('pid')} (new ledger open)"
    return None       # spans / bucket steps are too chatty for a tail


def follow_ledger(path, interval_s: float = 1.0,
                  max_seconds: float | None = None, out=None) -> int:
    """Tail a flight ledger, printing one line per notable new event.

    Polls byte offsets through ``LedgerTail`` (only complete lines are
    consumed, torn writes are picked up whole on the next poll).  Runs
    until interrupted, or for ``max_seconds`` if given; returns the
    number of events seen.
    """
    out = out if out is not None else sys.stdout
    tail = LedgerTail(path)
    t0 = time.monotonic()
    seen = 0
    try:
        while True:
            for ev in tail.poll():
                seen += 1
                line = format_event(ev)
                if line is not None:
                    out.write(line + "\n")
            out.flush()
            if max_seconds is not None \
                    and time.monotonic() - t0 >= max_seconds:
                break
            time.sleep(interval_s)
    except KeyboardInterrupt:
        pass
    return seen


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.status",
        description="Render a KLARAPTOR flight ledger or telemetry "
                    "snapshot as a terminal dashboard.")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--ledger", metavar="PATH",
                     help="JSONL flight ledger (Telemetry(ledger=...) / "
                          "serve --ledger)")
    src.add_argument("--snapshot", metavar="PATH",
                     help="MetricsExporter.json() dump")
    ap.add_argument("--top", type=int, default=10,
                    help="span rows to show (default 10)")
    ap.add_argument("--follow", action="store_true",
                    help="with --ledger: after the summary, tail the file "
                         "and print new events as they land (ctrl-c to "
                         "stop)")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="with --follow: poll interval seconds (default 1)")
    ap.add_argument("--max-seconds", type=float, default=None,
                    help="with --follow: stop after this long (default: "
                         "until interrupted)")
    args = ap.parse_args(argv)
    if args.follow and not args.ledger:
        ap.error("--follow requires --ledger")
    if args.ledger:
        out = render_ledger(read_ledger(args.ledger), top=args.top)
    else:
        with open(args.snapshot) as f:
            out = render_snapshot(json.load(f), top=args.top)
    sys.stdout.write(out)
    if args.follow:
        sys.stdout.write("\n== following (ctrl-c to stop) " + "=" * 33
                         + "\n")
        follow_ledger(args.ledger, interval_s=args.interval,
                      max_seconds=args.max_seconds)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
