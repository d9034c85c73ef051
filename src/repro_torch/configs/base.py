"""Config infrastructure: the shape presets of the JAX package's configs.

Every architecture module exposes ``full()`` (the published config) and
``smoke()`` (a reduced same-family config for CPU tests).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..models.config import ModelConfig

__all__ = ["SHAPES", "ShapePreset", "shape_applicable"]


@dataclass(frozen=True)
class ShapePreset:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapePreset] = {
    "train_4k": ShapePreset("train_4k", "train", 4096, 256),
    "prefill_32k": ShapePreset("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapePreset("decode_32k", "decode", 32768, 128),
    "long_500k": ShapePreset("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """(applicable, reason).  long_500k needs sub-quadratic decode."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention architecture: 500k context is "
                       "assigned only to SSM/hybrid archs")
    return True, ""
