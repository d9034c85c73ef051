"""Host-side input pipeline: background prefetch with bounded queue.

The JAX package's ``data/pipeline.py``, copied (plain Python threads).

A trainer thread pops ready batches while a producer thread generates /
loads the next ones -- the standard overlap of host input work with device
steps.  The prefetcher is checkpoint-aware: its state is the underlying
stream's state plus the number of undelivered queued batches (those are
regenerated after restore, keeping resume bit-exact).
"""

from __future__ import annotations

import queue
import threading

__all__ = ["Prefetcher"]


class Prefetcher:
    def __init__(self, stream, depth: int = 2):
        self.stream = stream
        self.depth = depth
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._delivered = 0

    def start(self) -> "Prefetcher":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            batch = self.stream.next_batch()
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def next_batch(self) -> dict:
        if self._thread is None:
            self._delivered += 1
            return self.stream.next_batch()
        batch = self._q.get()
        self._delivered += 1
        return batch

    def state_dict(self) -> dict:
        # The stream may have produced batches still sitting in the queue;
        # resume from the number actually *delivered* to the trainer.
        return {"delivered": self._delivered}

    def load_state_dict(self, state: dict) -> None:
        self._delivered = int(state["delivered"])
        self.stream.load_state_dict({"step": self._delivered})
        with self._q.mutex:
            self._q.queue.clear()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
