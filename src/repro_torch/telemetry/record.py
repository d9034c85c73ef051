"""Launch recorder: predicted-vs-observed state per (kernel, hw, bucket).

The runtime half of KLARAPTOR is only trustworthy while the fitted rational
program still describes the device and traffic actually being served.  The
recorder is the memory of that check: for every instrumented choice it keeps
cheap aggregate state -- ring buffers of the latest (predicted, observed)
timing pairs and an EWMA of the relative prediction error -- keyed by
(kernel, hw, shape bucket), and decides which launches get a sampled shadow
probe so the observability overhead stays bounded.

Shape bucketing: live traffic rarely repeats exact shapes, so keys would
never accumulate samples if keyed by exact D.  Data parameters are bucketed
by integer log2 (1024 and 1500 share a bucket; 1024 and 4096 do not), which
matches how the rational program's error actually varies with D.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field

import numpy as np

from ..core.driver import ChoiceEvent

from .config import TelemetryConfig

__all__ = ["EWMA", "KeyStats", "LaunchRecorder", "RingBuffer",
           "bucket_label", "shape_bucket"]


def shape_bucket(D) -> tuple[tuple[str, int], ...]:
    """Log2 bucket of a data-parameter dict: ((name, ceil(log2 v)), ...).

    Deterministic (sorted by name) and order-insensitive, so it can key
    dicts across processes.  Values <= 1 land in bucket 0.
    """
    return tuple(sorted(
        (k, 0 if v <= 1 else int(math.ceil(math.log2(float(v)))))
        for k, v in D.items()))


def bucket_label(bucket: tuple[tuple[str, int], ...]) -> str:
    """Compact human/Prometheus-safe form: "k12,m12,n12"."""
    return ",".join(f"{k}{b}" for k, b in bucket)


class RingBuffer:
    """Fixed-capacity float ring: O(1) push, oldest-first ``values()``."""

    def __init__(self, capacity: int):
        self._buf = np.zeros(max(int(capacity), 1))
        self._n = 0          # total pushes ever

    def push(self, x: float) -> None:
        self._buf[self._n % self._buf.size] = float(x)
        self._n += 1

    def __len__(self) -> int:
        return min(self._n, self._buf.size)

    @property
    def total_pushed(self) -> int:
        return self._n

    def values(self) -> np.ndarray:
        """Stored values, oldest first."""
        if self._n <= self._buf.size:
            return self._buf[:self._n].copy()
        cut = self._n % self._buf.size
        return np.concatenate([self._buf[cut:], self._buf[:cut]])


class EWMA:
    """Exponentially weighted mean; first sample initializes the value."""

    def __init__(self, alpha: float):
        self.alpha = float(alpha)
        self.value: float | None = None
        self.n = 0

    def update(self, x: float) -> float:
        x = float(x)
        self.value = x if self.value is None else \
            self.alpha * x + (1.0 - self.alpha) * self.value
        self.n += 1
        return self.value


@dataclass
class KeyStats:
    """Aggregate telemetry for one (kernel, hw, shape-bucket) key."""

    kernel: str
    hw_name: str
    bucket: tuple[tuple[str, int], ...]
    predicted: RingBuffer
    observed: RingBuffer
    rel_error: EWMA
    n_choices: int = 0
    n_probes: int = 0
    # Exact shape of the most recent choice in this bucket: what the refit
    # controller probes (live traffic, not a synthetic grid point).
    last_D: dict = field(default_factory=dict)
    last_config: dict = field(default_factory=dict)
    last_predicted_s: float = 0.0
    last_observed_s: float = 0.0

    @property
    def rel_error_ewma(self) -> float | None:
        return self.rel_error.value


class LaunchRecorder:
    """Per-key choice/probe bookkeeping plus the probe-sampling decision."""

    def __init__(self, config: TelemetryConfig | None = None):
        self.config = config or TelemetryConfig()
        self._keys: dict[tuple, KeyStats] = {}
        self._lock = threading.Lock()

    def _stats_for(self, event: ChoiceEvent) -> KeyStats:
        key = (event.kernel, event.hw_name, shape_bucket(event.D))
        stats = self._keys.get(key)
        if stats is None:
            c = self.config
            stats = self._keys[key] = KeyStats(
                kernel=event.kernel, hw_name=event.hw_name, bucket=key[2],
                predicted=RingBuffer(c.ring_size),
                observed=RingBuffer(c.ring_size),
                rel_error=EWMA(c.ewma_alpha))
        return stats

    def observe_choice(self, event: ChoiceEvent) -> tuple[KeyStats, bool]:
        """Account one choice; returns (key stats, shadow-probe this one?).

        Sampling is deterministic per key -- the first choice and then every
        ``probe_every``-th -- so a key drifts detectably after a bounded
        number of launches regardless of traffic interleaving.  Only choices
        that carry a prediction (driver/override paths) are probe-eligible:
        without a predicted time there is nothing to compare against.

        A coalesced event (``n_coalesced`` > 1, from the decision memo's
        sampled steady state) advances ``n_choices`` by the launches it
        stands for, but is at most *one* probe opportunity -- eligible when
        the batch it covers crossed a ``probe_every`` boundary.
        """
        with self._lock:
            stats = self._stats_for(event)
            prev = stats.n_choices
            stats.n_choices += event.n_coalesced
            stats.last_D = dict(event.D)
            stats.last_config = dict(event.config)
            if event.predicted_s is None:
                return stats, False
            period = max(self.config.probe_every, 1)
            # Probe-eligible iff some launch ordinal in [prev, n_choices-1]
            # is a multiple of the period (ordinal 0 = the first choice);
            # for n_coalesced == 1 this is exactly the old
            # ``prev % period == 0``.  Python floor division makes the
            # prev == 0 case fall out naturally ((-1) // p == -1).
            do_probe = ((prev + event.n_coalesced - 1) // period
                        > (prev - 1) // period)
            return stats, do_probe

    def record_probe(self, stats: KeyStats, predicted_s: float,
                     observed_s: float) -> float:
        """Fold one shadow-probe result in; returns the updated error EWMA."""
        with self._lock:
            stats.n_probes += 1
            stats.predicted.push(predicted_s)
            stats.observed.push(observed_s)
            stats.last_predicted_s = float(predicted_s)
            stats.last_observed_s = float(observed_s)
            rel = abs(observed_s - predicted_s) / max(predicted_s, 1e-30)
            return stats.rel_error.update(rel)

    def reset_key(self, stats: KeyStats) -> None:
        """Forget a key's error history (after a refit hot-swapped the
        driver: the old fit's errors must not condemn the new fit)."""
        with self._lock:
            c = self.config
            stats.predicted = RingBuffer(c.ring_size)
            stats.observed = RingBuffer(c.ring_size)
            stats.rel_error = EWMA(c.ewma_alpha)

    def keys(self) -> list[KeyStats]:
        """All key stats, deterministically ordered (exporter contract)."""
        with self._lock:
            return [self._keys[k] for k in sorted(self._keys)]
