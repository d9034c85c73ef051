"""The durable drift-retuning queue: flight ledgers in, retune jobs out.

Serving nodes persist every drift trip to their JSONL flight ledger
(``repro_torch.trace.Ledger``).  ``RetuneQueue`` tails those ledgers --
per-file byte offsets, advanced only past *complete* lines, survive
restarts in the queue's own state file -- deduplicates drifted
(kernel, hw, shape-bucket) keys, and hands the pending set to the fleet
coordinator, which probes and refits farm-side under one ``SearchBudget``
instead of stealing device-seconds from live serving.

The state file is one atomic JSON document: offsets, pending keys (with
the freshest drift event per key), done keys (with the refit summary),
failures, and per-key traffic tallies.  Ingest is idempotent --
re-reading a ledger only consumes bytes past the stored offset, and a
key already pending or done only bumps its counters.  Corrupt mid-file
lines are skipped and counted (the lenient ``read_ledger`` contract,
applied to tails).

Drain order is *priority*, not FIFO: the farm's device-seconds should go
where they buy the most, so ``pending()`` ranks keys by drift-EWMA
magnitude weighted by ledger traffic volume (``choice`` events tallied
per key during the same ingest pass -- a badly-drifted kernel nobody
launches ranks below a mildly-drifted hot path).  Done keys that keep
re-drifting re-enqueue themselves automatically once they trip
``requeue_after`` re-drifts (default 2): one stray drift event after a
refit stays an operator decision, a pattern of them means the refit did
not take.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile

from ..trace import LedgerTail

__all__ = ["RetuneQueue", "drift_key", "traffic_key"]

logger = logging.getLogger(__name__)


def drift_key(event: dict) -> str:
    """The dedup identity of a drifted fit: kernel x hardware x bucket."""
    return "{}|{}|{}".format(event.get("kernel", "?"), event.get("hw", "?"),
                             event.get("bucket", "?"))


def traffic_key(event: dict) -> str:
    """Traffic-tally identity of a ledger ``choice`` line.

    Choice lines carry raw ``D`` rather than a precomputed bucket label;
    bucketing it with the recorder's own log2 arithmetic makes traffic
    keys line up with the drift keys the telemetry loop writes (both go
    through ``bucket_label(shape_bucket(D))``).
    """
    bucket = event.get("bucket")
    if bucket is None and isinstance(event.get("D"), dict):
        from ..telemetry.record import bucket_label, shape_bucket
        bucket = bucket_label(shape_bucket(event["D"]))
    return "{}|{}|{}".format(event.get("kernel", "?"), event.get("hw", "?"),
                             bucket if bucket is not None else "?")


class RetuneQueue:
    """Durable drift-key queue over one JSON state file."""

    def __init__(self, state_path, requeue_after: int = 2):
        self.state_path = str(state_path)
        self.requeue_after = max(1, int(requeue_after))
        self.state = {"offsets": {}, "pending": {}, "done": {},
                      "failed": {}, "traffic": {}, "requeued": 0,
                      "corrupt_lines": 0}
        doc = None
        try:
            with open(self.state_path) as f:
                doc = json.load(f)
        except FileNotFoundError:
            pass
        except (OSError, ValueError) as e:
            # A torn state file must not brick the farm: start fresh (the
            # worst case is re-ingesting ledgers, which dedup absorbs).
            logger.warning("retune queue state %s unreadable (%r); "
                           "starting fresh", self.state_path, e)
        if isinstance(doc, dict):
            self.state.update(doc)

    # -- persistence ---------------------------------------------------------
    def save(self) -> None:
        d = os.path.dirname(self.state_path) or "."
        fd, tmp = tempfile.mkstemp(prefix=".tmp.", dir=d)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self.state, f, sort_keys=True)
                f.flush()
            os.replace(tmp, self.state_path)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise

    # -- ingest --------------------------------------------------------------
    def ingest(self, ledger_path) -> int:
        """Tail one flight ledger; returns how many *new* keys were enqueued.

        Only bytes past the stored offset are read, and the offset only
        advances past complete lines -- a line the serving node is halfway
        through writing is picked up whole on the next ingest.
        """
        path = os.path.abspath(str(ledger_path))
        offset = int(self.state["offsets"].get(path, 0))
        tail = LedgerTail(path, offset=offset)
        events = tail.poll()
        if tail.offset == offset:
            return 0            # no complete new line yet
        self.state["offsets"][path] = tail.offset
        self.state["corrupt_lines"] += tail.corrupt_lines

        new_keys = 0
        for event in events:
            etype = event.get("type")
            if etype == "choice":
                # Traffic tally: how many launches each key actually
                # serves, the weight side of the drain priority.
                tk = traffic_key(event)
                self.state["traffic"][tk] = (
                    self.state["traffic"].get(tk, 0)
                    + int(event.get("n_coalesced") or 1))
                continue
            if etype != "drift":
                continue
            key = drift_key(event)
            if key in self.state["done"]:
                # Already retuned: one stray re-drift is counted but left
                # to the operator; a *pattern* of them (>= requeue_after)
                # means the refit did not take, so the key re-enqueues
                # itself.
                done = self.state["done"][key]
                done["re_drifts"] = done.get("re_drifts", 0) + 1
                if done["re_drifts"] < self.requeue_after:
                    continue
                self.state["done"].pop(key)
                self.state["requeued"] = self.state.get("requeued", 0) + 1
                self.state["pending"][key] = {"event": event, "n_seen": 1}
                new_keys += 1
                continue
            row = self.state["pending"].get(key)
            if row is None:
                self.state["pending"][key] = {"event": event, "n_seen": 1}
                new_keys += 1
            else:
                row["event"] = event        # freshest wins; key deduped
                row["n_seen"] += 1
        self.save()
        return new_keys

    # -- queue ---------------------------------------------------------------
    def enqueue(self, event: dict, boost: float = 1.0) -> bool:
        """Directly enqueue one drift-shaped event (SLO breach path).

        The observatory's SLO engine calls this when a burn-rate rule
        breaches: unlike ``ingest`` it bypasses the ledger tail (the alert
        is already in hand) and can carry a priority ``boost`` multiplier
        so acting SLO breaches outrank organically-tailed drift of the
        same magnitude.  A key already done re-enters pending -- a breach
        is stronger evidence than a single re-drift.  Returns True if the
        key is newly pending.
        """
        key = drift_key(event)
        self.state["done"].pop(key, None)
        row = self.state["pending"].get(key)
        if row is None:
            self.state["pending"][key] = {"event": event, "n_seen": 1,
                                          "boost": float(boost)}
            self.save()
            return True
        row["event"] = event
        row["n_seen"] += 1
        row["boost"] = max(float(row.get("boost", 1.0)), float(boost))
        self.save()
        return False

    def priority(self, key: str) -> float:
        """Drain priority: drift magnitude x (1 + ledger traffic weight).

        The EWMA says how wrong the fit is, the traffic tally says how
        often that wrongness is paid; a key with no recorded traffic
        still drains on magnitude alone (the +1).  SLO-breach enqueues
        multiply in their ``boost`` so acted-on alerts drain first.
        """
        row = self.state["pending"].get(key)
        if row is None:
            return 0.0
        ewma = row["event"].get("rel_error_ewma")
        mag = abs(float(ewma)) if ewma is not None else 0.0
        weight = float(self.state.get("traffic", {}).get(key, 0))
        return mag * (1.0 + weight) * float(row.get("boost", 1.0))

    def pending(self) -> list[tuple[str, dict]]:
        """Deduped pending drift keys, highest priority first (key-sorted
        within ties: deterministic job order)."""
        keys = sorted(self.state["pending"],
                      key=lambda k: (-self.priority(k), k))
        return [(k, self.state["pending"][k]["event"]) for k in keys]

    def mark_done(self, key: str, summary: dict) -> None:
        row = self.state["pending"].pop(key, None) or {}
        self.state["done"][key] = {"summary": summary,
                                   "n_seen": row.get("n_seen", 0)}
        self.save()

    def mark_failed(self, key: str, error: str) -> None:
        self.state["pending"].pop(key, None)
        self.state["failed"][key] = {"error": error}
        self.save()

    def summary(self) -> dict:
        return {
            "pending": len(self.state["pending"]),
            "done": len(self.state["done"]),
            "failed": len(self.state["failed"]),
            "ledgers": len(self.state["offsets"]),
            "corrupt_lines": self.state["corrupt_lines"],
            "re_drifts": sum(d.get("re_drifts", 0)
                             for d in self.state["done"].values()),
            "requeued": self.state.get("requeued", 0),
            "traffic_keys": len(self.state.get("traffic", {})),
        }
