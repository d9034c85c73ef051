"""repro_torch.distributed: the fault-tolerance hooks the tuning farm needs.

Only ``fault_tolerance`` is ported; the reference's ``collectives``,
``elastic``, ``pipeline_parallel`` and ``sharding`` (a jax mesh) wait for
``torch.distributed`` (ROADMAP Queue A item 6).
"""

from .fault_tolerance import (FaultToleranceError, StragglerMonitor,
                              Watchdog, retry_loop)

__all__ = ["FaultToleranceError", "StragglerMonitor", "Watchdog",
           "retry_loop"]
