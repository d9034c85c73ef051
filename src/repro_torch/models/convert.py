"""JAX parameters -> the port's parameters.

The JAX package's models take a nested dict of arrays (``blocks/pos0/<leaf>``
stacked over a leading layers axis); the port's take the same tree of
tensors.  ``params_from_reference`` converts one into the other, so that both
packages can compute the same thing on the same weights.  It reads numpy
arrays (``np.asarray`` of a JAX array) and never imports JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["params_from_reference"]


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16: exact in f32
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_reference(tree: Mapping,
                          device: str | torch.device = "cuda") -> dict:
    """A nested dict of arrays as the same nested dict of tensors on
    ``device``, dtype for dtype (bf16 stays bf16)."""
    device = torch.device(device)
    return {k: params_from_reference(v, device) if isinstance(v, Mapping)
            else _tensor(v, device) for k, v in tree.items()}
