"""Distribution: sharding rules, collectives, pipeline parallelism, fault
tolerance and elastic restore, on ``torch.distributed``.

The port runs data parallelism over the batch axes ("pod", "data") and a
GPipe schedule over a "pipe" axis; it computes shardings for any mesh, and
refuses to run tensor, sequence and expert parallelism and FSDP
(``Sharder.check_runnable``; ROADMAP Queue A item 6.4's second half).
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
