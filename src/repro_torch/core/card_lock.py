"""One timed probe at a time per card, across threads and processes.

Two probes timed on one card at once corrupt each other's times: kernels
of two processes time-slice the card, and two streams of one process
share its SMs.  So every timed launch of ``CudaEventTimer`` -- its input
binding, L2 flush, spin, warm-ups, events and launches -- runs while it
holds ``CardLock.for_device(device)``: ``fcntl.flock`` on a file named
after the card's UUID in a directory that every process of the host sees
(``default_lock_dir()``, under the temporary directory).  An flock belongs
to one open file description, and ``hold`` opens the file anew each time,
so two threads of one process exclude each other as two processes do.
A waiter polls with ``LOCK_NB`` every ``POLL_S`` and calls ``beat``
between polls, so a farm worker queued behind another keeps its lease.

With ``KLARAPTOR_CARD_LOCK_LOG`` set to a file, every held interval is
appended to it as one JSON line ``{"pid", "thread", "t0", "t1"}`` in
``time.monotonic()`` seconds (one clock for all processes of a host):
what ``chip_smoke.py``'s farm phase reads to show that no two timed
probes overlapped (``read_intervals``, ``largest_overlap``).
"""

from __future__ import annotations

import fcntl
import json
import os
import tempfile
import threading
import time
from contextlib import contextmanager
from typing import Callable, Iterator, Sequence

__all__ = ["CardLock", "LOG_ENV", "default_lock_dir", "largest_overlap",
           "read_intervals"]

LOG_ENV = "KLARAPTOR_CARD_LOCK_LOG"
POLL_S = 0.002      # a waiter's retry period


def default_lock_dir() -> str:
    """Where the card locks live: one directory per host's temp dir."""
    return os.path.join(tempfile.gettempdir(), "klaraptor-card-locks")


def _log_interval(t0: float, t1: float) -> None:
    path = os.environ.get(LOG_ENV)
    if not path:
        return
    line = json.dumps({"pid": os.getpid(), "thread": threading.get_ident(),
                       "t0": t0, "t1": t1}) + "\n"
    # one short O_APPEND write per interval: lines never interleave
    fd = os.open(path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
    try:
        os.write(fd, line.encode())
    finally:
        os.close(fd)


class CardLock:
    """An exclusive lock on one card (see the module docstring)."""

    def __init__(self, path):
        self.path = str(path)

    @classmethod
    def for_device(cls, device) -> "CardLock":
        """The lock of the CUDA device ``device`` (its UUID names it)."""
        import torch

        device = torch.device(device)
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        uuid = getattr(torch.cuda.get_device_properties(index), "uuid", None)
        name = f"card-{uuid}" if uuid is not None else f"cuda-{index}"
        os.makedirs(default_lock_dir(), exist_ok=True)
        return cls(os.path.join(default_lock_dir(), f"{name}.lock"))

    @contextmanager
    def hold(self, beat: Callable[[], object] | None = None) -> Iterator[None]:
        fd = os.open(self.path, os.O_RDWR | os.O_CREAT, 0o666)
        try:
            while True:
                try:
                    fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                    break
                except BlockingIOError:
                    if beat is not None:
                        beat()
                    time.sleep(POLL_S)
            t0 = time.monotonic()
            try:
                yield
            finally:
                t1 = time.monotonic()
                fcntl.flock(fd, fcntl.LOCK_UN)
                _log_interval(t0, t1)
        finally:
            os.close(fd)


def read_intervals(path) -> list[dict]:
    """The intervals a ``KLARAPTOR_CARD_LOCK_LOG`` file holds."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def largest_overlap(intervals: Sequence[dict]) -> float:
    """The longest time (s) any two held intervals share (0 if none)."""
    worst, end = 0.0, None
    for iv in sorted(intervals, key=lambda r: r["t0"]):
        if end is not None:
            worst = max(worst, min(iv["t1"], end) - iv["t0"])
        end = iv["t1"] if end is None else max(end, iv["t1"])
    return worst
