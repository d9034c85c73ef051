"""``repro_torch.fleet`` -- the fault-tolerant tuning farm.

KLARAPTOR's probe phase is embarrassingly parallel but costly: the
rational-program fits need timings at many (D, P) points, and a serving
process should neither pay for them inline nor lose them to a worker
crash.  This package farms the probes out:

    ``jobs``         content-keyed idempotent job documents + device/spec
                     serialization (``SpecRef``, ``WallClockSim``; the
                     card's ``CudaEventTimer`` by value)
    ``board``        the durable spool: atomic-rename claims, mtime-lease
                     heartbeats, first-writer-wins results
    ``worker``       claim -> execute -> complete loop with injectable
                     faults (``FaultPlan``) for kill / hang / vanish drills
    ``merge``        worker results -> canonical ``CollectedData``
                     (completion-order independent; the single-process
                     ``collect``'s bytes under ``HopperModel``, its rows on
                     the card)
    ``coordinator``  partitioning, watchdog / straggler supervision, lease
                     reassignment, fit + versioned cache write-through;
                     spawned process workers, one card each in turn
    ``queue``        the durable drift-retuning queue tailing flight
                     ledgers into farm-side refits

CLI: ``python -m repro_torch.launch.fleet {tune,retune,worker,status}``.
"""

from .board import JobBoard
from .coordinator import FleetConfig, FleetCoordinator, FleetStats
from .jobs import (ProbeJob, SpecRef, WallClockSim, device_from_json,
                   device_to_json, hw_by_name, job_key, make_job,
                   tier1_spec_refs)
from .merge import (collected_equal, collected_rows_equal,
                    merge_batch_results, merge_kernel_result)
from .queue import RetuneQueue, drift_key, traffic_key
from .worker import FaultPlan, execute_job, run_worker

__all__ = [
    "FaultPlan",
    "FleetConfig",
    "FleetCoordinator",
    "FleetStats",
    "JobBoard",
    "ProbeJob",
    "RetuneQueue",
    "SpecRef",
    "WallClockSim",
    "collected_equal",
    "collected_rows_equal",
    "device_from_json",
    "device_to_json",
    "drift_key",
    "traffic_key",
    "execute_job",
    "hw_by_name",
    "job_key",
    "make_job",
    "merge_batch_results",
    "merge_kernel_result",
    "run_worker",
    "tier1_spec_refs",
]
