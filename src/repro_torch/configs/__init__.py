"""Architecture registry: ``--arch <id>`` resolution.

Each module exposes ``full()`` and ``smoke()`` ModelConfigs, one for every
architecture of the JAX package (``ARCH_IDS`` in its order).  ``polybench``
is the paper's own kernel-suite workload (not a language model), exported
as the JAX package exports it.
"""

from . import (gemma2_2b, grok1_314b, internlm2_1_8b, internvl2_76b,
               jamba1_5_large, llama3_2_1b, mamba2_130m, polybench,
               qwen3_14b, qwen3_moe_235b, whisper_medium)
from .base import SHAPES, ShapePreset, shape_applicable

_MODULES = (
    gemma2_2b, internlm2_1_8b, llama3_2_1b, qwen3_14b, jamba1_5_large,
    internvl2_76b, mamba2_130m, whisper_medium, qwen3_moe_235b, grok1_314b,
)

REGISTRY = {m.ARCH_ID: m for m in _MODULES}
ARCH_IDS = tuple(REGISTRY)

# Architectures whose optimizer state is stored bf16: the JAX package's
# ``BF16_OPT_STATE`` (its configs/__init__.py), which its dry-run reckons
# memory by.
BF16_OPT_STATE = {"jamba-1.5-large-398b", "qwen3-moe-235b-a22b",
                  "grok-1-314b"}


def get_config(arch: str, smoke: bool = False):
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(REGISTRY)}")
    mod = REGISTRY[arch]
    return mod.smoke() if smoke else mod.full()


__all__ = ["ARCH_IDS", "BF16_OPT_STATE", "REGISTRY", "SHAPES", "ShapePreset",
           "get_config", "polybench", "shape_applicable"]
