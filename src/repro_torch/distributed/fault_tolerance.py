"""Fault tolerance: watchdog, straggler detection, retry loop.

The tuning farm (``repro_torch.fleet``) wires these to its board's lease
mechanics: one re-armable ``Watchdog`` per worker watches the claim-file
heartbeat channel, a ``StragglerMonitor`` over per-worker job durations
flags slow workers for speculative duplicates, and ``retry_loop`` restarts
a worker's serve loop after a crash outside per-job handling.  Stdlib
only; the reference's training-loop uses (restore from the last
checkpoint) wait for the port's ``checkpoint/``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

__all__ = ["Watchdog", "StragglerMonitor", "retry_loop", "FaultToleranceError"]


class FaultToleranceError(RuntimeError):
    pass


class Watchdog:
    """Background timer that fires if no heartbeat arrives within timeout.

    Firing is one-shot: once ``on_timeout`` has run, the watchdog stays
    disarmed (``fired`` remains True, beats are ignored) until ``reset()``
    re-arms it.  The monitor thread persists across fire/reset cycles, so
    lease reassignment can keep one watchdog per worker for the lifetime
    of the farm instead of leaking a thread per retry.
    """

    def __init__(self, timeout_s: float, on_timeout: Callable[[], None]
                 | None = None):
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout
        self._last = time.monotonic()
        self._fired = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> "Watchdog":
        self._thread.start()
        return self

    def beat(self) -> None:
        self._last = time.monotonic()

    @property
    def fired(self) -> bool:
        return self._fired.is_set()

    def reset(self) -> None:
        """Re-arm after a fire: fresh deadline, ``fired`` cleared.

        Safe to call whether or not the watchdog has fired; a reset on a
        live watchdog is just a beat.
        """
        self._last = time.monotonic()
        self._fired.clear()

    def _run(self) -> None:
        while not self._stop.wait(min(self.timeout_s / 4, 0.25)):
            if self._fired.is_set():
                continue        # disarmed until reset()
            if time.monotonic() - self._last > self.timeout_s:
                self._fired.set()
                if self.on_timeout is not None:
                    self.on_timeout()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=1.0)


@dataclass
class StragglerMonitor:
    """Flags hosts whose step time is an outlier vs the fleet median.

    Feed per-host step durations each step (on a real deployment these come
    from the coordinator's heartbeat channel); a host slower than
    ``threshold`` x median for ``patience`` consecutive steps is flagged for
    mitigation (re-scheduling / hot-spare swap -- surfaced to the caller).
    """

    n_hosts: int
    threshold: float = 2.0
    patience: int = 3
    _strikes: dict = field(default_factory=dict)

    def observe(self, step_times: list[float]) -> list[int]:
        assert len(step_times) == self.n_hosts
        med = sorted(step_times)[self.n_hosts // 2]
        flagged = []
        for h, t in enumerate(step_times):
            if med > 0 and t > self.threshold * med:
                self._strikes[h] = self._strikes.get(h, 0) + 1
            else:
                self._strikes[h] = 0
            if self._strikes.get(h, 0) >= self.patience:
                flagged.append(h)
        return flagged


def retry_loop(run_fn: Callable[[int], None],
               restore_fn: Callable[[], int],
               max_failures: int = 3) -> int:
    """Run ``run_fn(start_step)`` with restore-on-failure.

    ``restore_fn`` returns the step to resume from (from the checkpoint
    manager).  Raises FaultToleranceError after ``max_failures`` failures.
    Returns the number of failures survived.
    """
    failures = 0
    while True:
        try:
            start = restore_fn()
            run_fn(start)
            return failures
        except FaultToleranceError:
            raise
        except Exception:
            failures += 1
            if failures >= max_failures:
                raise FaultToleranceError(
                    f"giving up after {failures} failures")
