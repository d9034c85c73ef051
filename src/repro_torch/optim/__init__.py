"""Optimizers, schedules, clipping and gradient compression: the JAX
package's ``optim/`` over nested dicts of tensors."""

from .adamw import (AdamWConfig, adamw_init, adamw_update, adamw_update_,
                    clip_by_global_norm, global_norm, stochastic_round)
from .compression import (compress, decompress, ef_compress_tree,
                          ef_update_tree, init_error_feedback)
from .schedules import constant, warmup_cosine, warmup_linear

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update", "adamw_update_",
    "clip_by_global_norm", "global_norm", "stochastic_round",
    "compress", "decompress", "ef_compress_tree", "ef_update_tree",
    "init_error_feedback",
    "constant", "warmup_cosine", "warmup_linear",
]
