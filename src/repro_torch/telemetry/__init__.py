"""repro_torch.telemetry: runtime observability + drift-adaptive retuning.

KLARAPTOR's runtime half assumes the fitted rational program still
describes the device and traffic being served; this subsystem is the
feedback layer that checks the assumption and repairs it online:

  * ``LaunchRecorder`` -- per-(kernel, hw, shape-bucket) ring buffers and
    EWMAs of predicted-vs-observed launch times, fed by sampled shadow
    probes through the existing ``DeviceModel.probe_rows`` oracle.
  * ``DriftDetector`` -- flags keys whose relative prediction error stays
    above a configurable threshold.
  * ``RefitController`` -- reacts with a budget-capped ``repro_torch.search``
    pass on live traffic shapes, a ``Klaraptor`` re-fit, a registry
    hot-swap, and a version-bumped write-through to the artifact cache so
    the whole fleet converges.
  * ``MetricsExporter`` -- deterministic JSON snapshots and
    Prometheus-style text.

``Telemetry`` ties them together and installs itself as the process-wide
choice listener; see ``ServingEngine(telemetry=...)`` and ``python -m
repro_torch.launch.serve --telemetry`` for the serving opt-in.  The port's
oracle is ``CudaEventTimer`` on the card and ``HopperModel`` on the CPU;
probes decided inside a CUDA-graph capture wait for its end (loop.py).
"""

from .config import TelemetryConfig
from .drift import DriftDetector, DriftEvent
from .export import MetricsExporter, TelemetryCounters
from .loop import Telemetry
from .record import (
    EWMA, KeyStats, LaunchRecorder, RingBuffer, bucket_label, shape_bucket,
)
from .refit import (
    RefitController, RefitResult, refit_probe_shapes, scale_budget,
)

__all__ = [
    "TelemetryConfig",
    "DriftDetector", "DriftEvent",
    "MetricsExporter", "TelemetryCounters",
    "Telemetry",
    "EWMA", "KeyStats", "LaunchRecorder", "RingBuffer", "bucket_label",
    "shape_bucket",
    "RefitController", "RefitResult", "refit_probe_shapes", "scale_budget",
]
