"""Drift detection: when does a fitted driver stop being trustworthy?

A driver's rational program was fit against probes taken at build time; the
hardware (thermal state, firmware, neighbors), the traffic, or the artifact
itself (corrupted / built against the wrong device profile) can all make its
predictions diverge from what launches actually cost.  The detector watches
the per-key EWMA of relative prediction error maintained by the recorder
and fires a ``DriftEvent`` when the error has been above the configured
threshold for enough samples -- single noisy probes (the simulator's
lognormal measurement noise, real-device jitter) must not trigger refits.

After firing, the key enters a cooldown (counted in observed choices) and a
per-process refit circuit breaker; a fit that stays wrong after
``max_refits_per_key`` corrections is a modeling problem, not something to
burn unbounded device time on.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

from .config import TelemetryConfig
from .record import KeyStats

__all__ = ["DriftDetector", "DriftEvent"]


@dataclass(frozen=True)
class DriftEvent:
    """One detected divergence between the fit and observed reality."""

    kernel: str
    hw_name: str
    bucket: tuple[tuple[str, int], ...]
    D: dict                      # exact live shape that exposed the drift
    config: dict                 # config the drifted driver chose there
    rel_error_ewma: float
    n_samples: int
    predicted_s: float
    observed_s: float


class DriftDetector:
    """Stateful threshold test over the recorder's per-key error EWMA."""

    def __init__(self, config: TelemetryConfig | None = None):
        self.config = config or TelemetryConfig()
        self._fired: dict[tuple, int] = {}        # key -> refits triggered
        self._cooldown_until: dict[tuple, int] = {}   # key -> n_choices mark
        self._lock = threading.Lock()

    @staticmethod
    def _key(stats: KeyStats) -> tuple:
        return (stats.kernel, stats.hw_name, stats.bucket)

    def update(self, stats: KeyStats) -> DriftEvent | None:
        """Re-test one key after a shadow probe; DriftEvent if it fired."""
        c = self.config
        err = stats.rel_error_ewma
        if err is None or stats.rel_error.n < c.min_samples:
            return None
        if err <= c.drift_threshold:
            return None
        key = self._key(stats)
        with self._lock:
            # The circuit breaker exists to bound *refit* spend; in
            # monitoring-only mode (refit_enabled=False) events must keep
            # flowing to dashboards forever, rate-limited by the cooldown
            # alone.
            if c.refit_enabled and \
                    self._fired.get(key, 0) >= c.max_refits_per_key:
                return None
            if stats.n_choices < self._cooldown_until.get(key, 0):
                return None
            if c.refit_enabled:
                self._fired[key] = self._fired.get(key, 0) + 1
            self._cooldown_until[key] = stats.n_choices + c.cooldown_choices
        return DriftEvent(
            kernel=stats.kernel,
            hw_name=stats.hw_name,
            bucket=stats.bucket,
            D=dict(stats.last_D),
            config=dict(stats.last_config),
            rel_error_ewma=float(err),
            n_samples=stats.rel_error.n,
            predicted_s=stats.last_predicted_s,
            observed_s=stats.last_observed_s,
        )

    def fired_count(self, stats: KeyStats) -> int:
        with self._lock:
            return self._fired.get(self._key(stats), 0)
