"""Distribution: sharding rules, collectives, pipeline parallelism, fault
tolerance and elastic restore, on ``torch.distributed``.

The port runs data parallelism over the batch axes ("pod", "data"), a
GPipe schedule over a "pipe" axis, and tensor and sequence parallelism
over "model" with FSDP over "data" in the train step of the dense
attention decoders (``tensor_parallel``); it computes shardings for any
mesh, and refuses what ROADMAP Queue A items 6.4.1-6.4.6 still have to
port (``Sharder.check_runnable``, ``sharding.LEFT``).
"""

from .collectives import compressed_pmean, hierarchical_pmean
from .elastic import elastic_restore, shardings_for_specs
from .fault_tolerance import (FaultToleranceError, StragglerMonitor,
                              Watchdog, retry_loop)
from .pipeline_parallel import bubble_fraction, gpipe_forward
from .sharding import Sharder, decode_rules, train_rules

__all__ = [
    "compressed_pmean", "hierarchical_pmean",
    "elastic_restore", "shardings_for_specs",
    "FaultToleranceError", "StragglerMonitor", "Watchdog", "retry_loop",
    "bubble_fraction", "gpipe_forward",
    "Sharder", "decode_rules", "train_rules",
]
