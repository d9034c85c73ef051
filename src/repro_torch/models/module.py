"""Parameter specs: shape, dtype, initializer and logical axes of each leaf.

Models are plain functions over nested dicts of tensors, as in the JAX
package.  ``ParamSpec`` keeps the JAX spec's fields (the logical ``axes``
name the sharding a later distributed port will map); ``init_params``
materializes a spec tree with one explicit ``torch.Generator`` on the target
device, leaf by leaf in the order JAX flattens the tree (sorted dict keys).
Numbers differ from JAX's PRNG for the same seed; the tests feed both
packages the same weights through ``models.convert`` instead.

The init rule is the reference's, fault included: a ``"scaled"`` leaf takes
std ``init_scale / sqrt(shape[0])``, and the stacked block leaves carry the
layers axis first, so their "fan-in" is the number of layer groups.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

__all__ = ["ParamSpec", "init_params", "param_count", "spec_leaves",
           "spec_tree_map"]

_DRAW_ELEMS = 1 << 32     # f32 elements a leaf draws at once (16 GiB)


@dataclass(frozen=True)
class ParamSpec:
    """Shape/dtype/init/logical-axes description of one parameter leaf."""

    shape: tuple[int, ...]
    dtype: Any = torch.bfloat16
    axes: tuple[str | None, ...] = ()
    init: str = "normal"          # normal | zeros | ones | scaled
    init_scale: float | None = None

    def __post_init__(self):
        if self.axes and len(self.axes) != len(self.shape):
            raise ValueError(
                f"axes {self.axes} do not match shape {self.shape}")

    def std(self) -> float | None:
        """The normal initializer's std (None for zeros / ones)."""
        if self.init in ("zeros", "ones"):
            return None
        if self.init == "scaled":
            fan_in = self.shape[0] if len(self.shape) >= 2 else \
                max(self.shape[-1], 1)
            return (self.init_scale or 1.0) / math.sqrt(fan_in)
        return self.init_scale or 0.02

    def materialize(self, generator: torch.Generator) -> torch.Tensor:
        device = generator.device
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=device)
        std = self.std()
        if math.prod(self.shape) <= _DRAW_ELEMS or len(self.shape) < 2:
            x = torch.randn(self.shape, generator=generator, device=device,
                            dtype=torch.float32)
            return x.mul_(std).to(self.dtype)
        # too large to draw at once in f32 (grok-1's stacked experts): one
        # slice of the leading (layers) axis at a time
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for i in range(self.shape[0]):
            out[i] = torch.randn(self.shape[1:], generator=generator,
                                 device=device, dtype=torch.float32
                                 ).mul_(std)
        return out


def spec_tree_map(fn: Callable, specs):
    """Apply ``fn`` to every ParamSpec leaf of a nested dict."""
    if isinstance(specs, ParamSpec):
        return fn(specs)
    return {k: spec_tree_map(fn, v) for k, v in specs.items()}


def spec_leaves(specs, prefix: str = "") -> list[tuple[str, ParamSpec]]:
    """(path, spec) of every leaf, in sorted key order ('a/b/c' paths)."""
    if isinstance(specs, ParamSpec):
        return [(prefix, specs)]
    out = []
    for k in sorted(specs):
        out += spec_leaves(specs[k], f"{prefix}/{k}" if prefix else k)
    return out


def init_params(specs, generator: torch.Generator):
    """Materialize a spec tree on ``generator.device``, leaves in sorted
    key order from the one generator."""
    if isinstance(specs, ParamSpec):
        return specs.materialize(generator)
    return {k: init_params(specs[k], generator) for k in sorted(specs)}


def param_count(specs) -> int:
    return sum(int(np.prod(s.shape)) for _, s in spec_leaves(specs))

