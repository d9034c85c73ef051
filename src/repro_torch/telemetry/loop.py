"""The telemetry loop: observe every launch decision, react to drift.

``Telemetry`` is the subsystem facade a serving process interacts with.  It
installs itself as the process-wide choice listener
(``repro_torch.core.driver.set_choice_listener``) so every
``choose_or_default``
decision -- from ``kernels/ops.py`` dispatch, the serving engine, or direct
calls -- flows through one ``_on_choice``:

  1. counters are bumped (cheap; the common path does nothing else),
  2. a sampled subset of driver-predicted choices gets a **shadow probe**
     through the device oracle (``DeviceModel.probe_rows`` on the single
     chosen config -- one bounded kernel execution, not a search),
  3. the probe feeds the per-key drift detector,
  4. a fired drift event hands the key to the refit controller, which
     searches + re-fits + hot-swaps under a hard budget.

The loop runs *synchronously inside* the choice callback, on the
caller's thread, which makes the whole subsystem deterministic and
testable.  Everything is also callable manually (``shadow_probe``,
``refit_now``) for fleets that want the reaction on a side thread.

**Decisions made while a CUDA graph is being captured.**  The JAX package
decides at trace time, where a probe is harmless.  PyTorch decides per
launch, and the serving engine captures its steps as CUDA graphs
(``serving/graphs.py``): a step-plan miss inside a capture reaches
``choose_or_default`` and this listener.  A shadow probe launches, times
and synchronizes (``CudaEventTimer``), which a capture forbids, and a refit
would move the registry's generation in the middle of one.  So while the
current stream is capturing (``_capturing``), the probe and whatever it
sets off are queued; the counters and the ledger's choice line are not.
``drain_deferred`` runs the queue in order once the capture has ended, on
the caller's stream: the engine calls it after every step, and every later
decision made outside a capture drains it first.  Outside a capture
nothing is queued, so the sequence is the reference's.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Iterable, Mapping

import numpy as np
import torch

from ..core.cache import DriverCache
from ..core.device_model import DeviceModel
from ..core.driver import ChoiceEvent, set_choice_listener
from ..core.kernel_spec import CandidateTable, KernelSpec
from ..core.tuner import Klaraptor
from ..obs.series import get_metrics_bus
from ..trace import Ledger, trace_span

from .config import TelemetryConfig
from .drift import DriftDetector, DriftEvent
from .export import MetricsExporter, TelemetryCounters
from .record import KeyStats, LaunchRecorder, bucket_label
from .refit import RefitController, RefitResult

__all__ = ["Telemetry"]


def _capturing() -> bool:
    """Is the current CUDA stream capturing a graph?"""
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


class Telemetry:
    """Runtime observability + drift-adaptive retuning for a serving process.

    ``specs`` maps kernel names to their ``KernelSpec`` -- only kernels
    listed here can be shadow-probed and refit (the spec is what turns a
    (D, P) choice back into a probeable workload).  ``device`` is the
    oracle probes run against: ``CudaEventTimer`` on the card,
    ``HopperModel`` on the CPU; ``hw`` defaults to the oracle's.
    ``klaraptor`` (optional) is the builder the
    refit controller uses; by default one is constructed over the same
    device/hw with the default artifact cache (pass ``cache=False`` to keep
    refits process-local).

    ``ledger`` (optional; a ``repro_torch.trace.Ledger`` or a path) turns on
    the
    flight ledger: every choice event (already coalesced by the decision
    memo, so steady-state writes stay rare), shadow probe, drift event and
    refit outcome is appended as one JSONL line -- the persistent record of
    what the system decided, predicted, and observed.
    """

    def __init__(self,
                 specs: Mapping[str, KernelSpec] | Iterable[KernelSpec],
                 device: DeviceModel,
                 hw=None,
                 config: TelemetryConfig | None = None,
                 klaraptor: Klaraptor | None = None,
                 cache: DriverCache | None | bool = None,
                 seed: int = 0,
                 ledger: Ledger | str | os.PathLike | None = None):
        if not isinstance(specs, Mapping):
            specs = {s.name: s for s in specs}
        self.specs: dict[str, KernelSpec] = dict(specs)
        self.device = device
        self.hw = hw if hw is not None else device.hw
        self.config = config or TelemetryConfig()
        self.klaraptor = klaraptor or Klaraptor(device, hw=self.hw,
                                                cache=cache)
        self.recorder = LaunchRecorder(self.config)
        self.detector = DriftDetector(self.config)
        self.refitter = RefitController(self.klaraptor, self.config,
                                        seed=seed)
        self.exporter = MetricsExporter(self)
        self.counters = TelemetryCounters()
        self.drift_events: list[DriftEvent] = []
        self.refits: list[RefitResult] = []
        self._rng = np.random.RandomState(seed)
        self._lock = threading.RLock()
        self._reacting = False     # reentrancy guard: refits make choices too
        # (event, key stats) of probes decided during a graph capture, in
        # order, and how many were queued and run (see the module docstring)
        self._deferred: list[tuple[ChoiceEvent, KeyStats]] = []
        self.deferred_total = 0
        self.deferred_run_total = 0
        if ledger is not None and not isinstance(ledger, Ledger):
            ledger = Ledger(ledger)
        self.ledger = ledger

    # -- lifecycle -----------------------------------------------------------
    def install(self) -> "Telemetry":
        """Become the process-wide choice listener."""
        set_choice_listener(self._on_choice)
        return self

    def uninstall(self) -> None:
        set_choice_listener(None)

    def __enter__(self) -> "Telemetry":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def note_warm_start(self, kernels: list[str]) -> None:
        with self._lock:
            self.counters.warm_started_kernels += len(kernels)

    def note_bucket_step(self, hit: bool, waste: float,
                         kernel: str | None = None) -> None:
        """One bucketed-dispatch outcome from a serving decode step: the
        engine's host replay of the in-graph bucket decision (bit-identical
        rounding, see core/buckets.py).  ``waste`` is the padding-waste
        fraction of the hit bucket (0.0 on a miss)."""
        with self._lock:
            if hit:
                self.counters.bucket_hits += 1
            else:
                self.counters.bucket_misses += 1
            self.counters.bucket_padding_waste_sum += float(waste)
        if self._emitting():
            self._emit({"type": "bucket_step", "hit": bool(hit),
                        "waste": float(waste), "kernel": kernel,
                        "t_ns": time.monotonic_ns()})

    # -- event emission ------------------------------------------------------
    def _emitting(self) -> bool:
        """Is any event sink (ledger or metrics bus) attached?  Gates
        building the event dict at all -- with neither, the loop stays
        counters-only."""
        return self.ledger is not None or get_metrics_bus() is not None

    def _emit(self, event: dict) -> None:
        """One dict, both sinks: the JSONL line the ledger persists is the
        exact object the live metrics bus ingests, which is what makes
        offline ledger replay reproduce the live series bit-identically."""
        if self.ledger is not None:
            self.ledger.append(event)
        bus = get_metrics_bus()
        if bus is not None:
            bus.ingest(event)

    # -- export --------------------------------------------------------------
    def snapshot(self) -> dict:
        return self.exporter.snapshot()

    def prometheus(self) -> str:
        return self.exporter.prometheus()

    # -- the loop ------------------------------------------------------------
    def _on_choice(self, event: ChoiceEvent) -> None:
        c = self.counters
        # A coalesced event stands for n_coalesced launches (the decision
        # memo batches steady-state hits); counters account for all of
        # them, the shadow-probe sampling below sees one event.
        n = event.n_coalesced
        if self._deferred and not self._reacting and not _capturing():
            self.drain_deferred()     # probes queued by an ended capture
        if self._emitting():
            # One event per *line*, not per launch: the coalescing
            # already happened upstream, so this inherits its write rate.
            self._emit({
                "type": "choice", "kernel": event.kernel,
                "hw": event.hw_name, "D": dict(event.D),
                "config": dict(event.config), "source": event.source,
                "predicted_s": event.predicted_s,
                "n_coalesced": n, "t_ns": event.t_ns,
            })
        with self._lock:
            c.choices_total += n
            c.choices_by_source[event.source] = \
                c.choices_by_source.get(event.source, 0) + n
            if event.source == "default":
                c.fallback_default_total += n
            if self._reacting:
                return          # choices made *by* a refit: count only
            stats, do_probe = self.recorder.observe_choice(event)
            if not do_probe or event.kernel not in self.specs:
                return
            cap = self.config.max_probe_device_seconds
            if cap is not None and c.probe_device_seconds_total >= cap:
                return          # shadow-probe budget spent: observe no more
            if _capturing():
                self._deferred.append((event, stats))
                self.deferred_total += 1
                return
            self._reacting = True
        try:
            self._probe_and_react(event, stats)
        finally:
            with self._lock:
                self._reacting = False

    def drain_deferred(self) -> int:
        """Run the probes queued during graph captures, in order, with
        whatever drift and refit they set off; returns how many ran.  A
        no-op while the current stream is still capturing, and inside a
        reaction (a refit's own decisions)."""
        n = 0
        while self._deferred:
            with self._lock:
                if self._reacting or not self._deferred or _capturing():
                    return n
                event, stats = self._deferred.pop(0)
                self._reacting = True
            try:
                self._probe_and_react(event, stats)
            finally:
                with self._lock:
                    self._reacting = False
                    self.deferred_run_total += 1
            n += 1
        return n

    def _probe_and_react(self, event: ChoiceEvent, stats: KeyStats) -> None:
        with trace_span("telemetry.observe", kernel=event.kernel,
                        source=event.source) as sp:
            observed = self.shadow_probe(event.kernel, event.D, event.config)
            if observed is None:
                return
            self.recorder.record_probe(stats, event.predicted_s, observed)
            if self._emitting():
                self._emit({
                    "type": "probe", "kernel": event.kernel,
                    "hw": event.hw_name,
                    "bucket": bucket_label(stats.bucket),
                    "D": dict(event.D),
                    "predicted_s": event.predicted_s,
                    "observed_s": observed,
                    "rel_error_ewma": stats.rel_error_ewma,
                    "t_ns": event.t_ns,
                })
            drift = self.detector.update(stats)
            if drift is None:
                return
            sp.set(drift=True, rel_error_ewma=drift.rel_error_ewma)
            with self._lock:
                self.counters.drift_events_total += 1
                self.drift_events.append(drift)
            if self._emitting():
                self._emit({
                    "type": "drift", "kernel": drift.kernel,
                    "hw": drift.hw_name,
                    "bucket": bucket_label(drift.bucket),
                    "D": dict(drift.D), "config": dict(drift.config),
                    "rel_error_ewma": drift.rel_error_ewma,
                    "n_samples": drift.n_samples,
                    "predicted_s": drift.predicted_s,
                    "observed_s": drift.observed_s,
                    "t_ns": event.t_ns,
                })
            if self.config.refit_enabled:
                self.refit_now(drift)

    def shadow_probe(self, kernel: str, D, config) -> float | None:
        """One sampled observability probe of the chosen config; observed
        median time in seconds, or None when the config is unprobeable."""
        spec = self.specs.get(kernel)
        if spec is None:
            return None
        with trace_span("telemetry.shadow_probe", kernel=kernel) as sp:
            try:
                one = CandidateTable.from_rows(spec.program_params, [config])
                tt = spec.traffic_table(D, one, self.hw)
                probe = self.device.probe_rows(
                    tt, self._rng, repeats=self.config.probe_repeats)
            except Exception:
                return None     # mismatched params / infeasible: not fatal
            device_s = float(np.sum(probe.device_seconds))
            sp.set(device_seconds=device_s)
            with self._lock:
                self.counters.shadow_probes_total += 1
                self.counters.probe_device_seconds_total += device_s
            return float(probe.total_time_s[0])

    def refit_now(self, drift: DriftEvent) -> RefitResult | None:
        """Run the budget-capped refit reaction for one drift event."""
        spec = self.specs.get(drift.kernel)
        if spec is None:
            return None
        result = self.refitter.refit(spec, drift)
        with self._lock:
            self.refits.append(result)
            self.counters.refits_total += 1
            if not result.succeeded:
                self.counters.refit_failures_total += 1
            if result.override is not None:
                self.counters.overrides_total += 1
            self.counters.refit_device_seconds_total += \
                result.total_device_seconds
        if self._emitting():
            self._emit({
                "type": "refit", "kernel": result.kernel,
                "D": dict(result.D), "succeeded": result.succeeded,
                "cache_version": result.cache_version,
                "override": (dict(result.override)
                             if result.override is not None else None),
                "total_device_seconds": result.total_device_seconds,
                "total_executions": result.total_executions,
                "wall_seconds": result.wall_seconds,
                "error": result.error,
                "t_ns": time.monotonic_ns(),
            })
        # The swapped-in fit starts with a clean record: the old fit's
        # errors must not immediately re-condemn the new one.
        for s in self.recorder.keys():
            if s.kernel == drift.kernel and s.hw_name == drift.hw_name:
                self.recorder.reset_key(s)
        return result
