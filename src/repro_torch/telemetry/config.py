"""Telemetry configuration: every knob of the runtime feedback loop.

One frozen dataclass so a serving fleet can describe its observability
policy declaratively (and so the metrics exporter can publish the exact
policy a snapshot was produced under).  The defaults are conservative:
shadow probes sample one launch in four per (kernel, hw, shape-bucket) key,
drift needs a sustained ~25% relative prediction error over at least three
observations to fire, and each key may trigger at most two refits per
process.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..search import SearchBudget

__all__ = ["TelemetryConfig"]


@dataclass(frozen=True)
class TelemetryConfig:
    """Policy for the recorder -> drift detector -> refit controller loop.

    Recorder / shadow probes:
      * ``probe_every``: shadow-probe 1 of every N driver choices per key
        (the sampling that bounds observability overhead).
      * ``probe_repeats``: executions per shadow probe (median taken).
      * ``max_probe_device_seconds``: process-wide hard cap on device time
        spent in shadow probes; None = unbounded.
      * ``ring_size``: per-key ring-buffer capacity for predicted/observed
        pairs.

    Drift detection:
      * ``drift_threshold``: relative |observed - predicted| / predicted
        (EWMA) above which a key is drifted.
      * ``ewma_alpha``: EWMA smoothing for the relative error.
      * ``min_samples``: observations required before drift may fire
        (a single noisy probe must not trigger a refit).

    Refit reaction:
      * ``refit_enabled``: False records drift events without reacting.
      * ``refit_budget``: total SearchBudget for one refit pass (search +
        re-collect + validation together); None derives ~25% of a
        one-repeat exhaustive pass over the candidate table at the drifted
        shape.
      * ``refit_search_fraction``: fraction of the (non-validation) budget
        spent on the direct online search at the drifted shape; the rest
        funds the Klaraptor re-collect/re-fit.
      * ``validation_fraction``: budget slice reserved for the final
        probe-off between the refitted driver's choice and the search's
        best observed config.
      * ``refit_strategy``: ``repro_torch.search`` strategy name used for
        both the search pass and the re-collect probe selection.
      * ``refit_repeats`` / ``refit_max_configs_per_size``: Klaraptor
        collect knobs for the rebuild.
      * ``max_refits_per_key``: per-process circuit breaker.
      * ``cooldown_choices``: per-key quiet period (in observed choices)
        after a refit before drift may fire again.
    """

    # recorder / shadow probes
    probe_every: int = 4
    probe_repeats: int = 1
    max_probe_device_seconds: float | None = None
    ring_size: int = 64
    # drift detection
    drift_threshold: float = 0.25
    ewma_alpha: float = 0.3
    min_samples: int = 3
    # refit reaction
    refit_enabled: bool = True
    refit_budget: SearchBudget | None = None
    refit_search_fraction: float = 0.5
    validation_fraction: float = 0.05
    refit_strategy: str = "successive_halving"
    refit_repeats: int = 2
    refit_max_configs_per_size: int = 16
    max_refits_per_key: int = 2
    cooldown_choices: int = 16

    def fingerprint(self) -> dict:
        """JSON-able policy description (published in metric snapshots)."""
        return {
            "probe_every": self.probe_every,
            "probe_repeats": self.probe_repeats,
            "max_probe_device_seconds": self.max_probe_device_seconds,
            "ring_size": self.ring_size,
            "drift_threshold": self.drift_threshold,
            "ewma_alpha": self.ewma_alpha,
            "min_samples": self.min_samples,
            "refit_enabled": self.refit_enabled,
            "refit_budget": (self.refit_budget.fingerprint()
                             if self.refit_budget is not None else None),
            "refit_search_fraction": self.refit_search_fraction,
            "validation_fraction": self.validation_fraction,
            "refit_strategy": self.refit_strategy,
            "refit_repeats": self.refit_repeats,
            "refit_max_configs_per_size": self.refit_max_configs_per_size,
            "max_refits_per_key": self.max_refits_per_key,
            "cooldown_choices": self.cooldown_choices,
        }
