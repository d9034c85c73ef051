"""Architecture registry: the architectures the port can run.

Each module exposes ``full()`` and ``smoke()`` ModelConfigs.  The JAX
package's other architectures are known by id and raise, naming the ROADMAP
item that ports them.  ``polybench`` is the paper's own kernel-suite workload
(not a language model), exported as the JAX package exports it.
"""

from . import llama3_2_1b, mamba2_130m, polybench, qwen3_moe_235b
from .base import SHAPES, ShapePreset, shape_applicable

REGISTRY = {m.ARCH_ID: m for m in (llama3_2_1b, mamba2_130m,
                                    qwen3_moe_235b)}
ARCH_IDS = tuple(REGISTRY)

# The JAX package's architectures the port cannot run yet.
PENDING = {
    "gemma2-2b": "ROADMAP Queue A, 'Other architectures'",
    "internlm2-1.8b": "ROADMAP Queue A, 'Other architectures'",
    "qwen3-14b": "ROADMAP Queue A, 'Other architectures'",
    "jamba-1.5-large-398b": "ROADMAP Queue A, 'Other architectures'",
    "internvl2-76b": "ROADMAP Queue A, 'Other architectures'",
    "whisper-medium": "ROADMAP Queue A, 'Other architectures'",
    "grok-1-314b": "ROADMAP Queue A, 'Other architectures'",
}


def get_config(arch: str, smoke: bool = False):
    if arch in PENDING:
        raise NotImplementedError(
            f"{arch} is not ported yet ({PENDING[arch]})")
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(REGISTRY)}")
    mod = REGISTRY[arch]
    return mod.smoke() if smoke else mod.full()


__all__ = ["ARCH_IDS", "PENDING", "REGISTRY", "SHAPES", "ShapePreset",
           "get_config", "polybench", "shape_applicable"]
