"""Gradient compression: per-tensor int8 quantization with error feedback,
as the JAX package's ``optim/compression.py``.

The reference wires ``compress`` / ``decompress`` around a ``lax.psum`` for
cross-pod data parallelism.  In the port the cross-pod mean is
``distributed.collectives.compressed_pmean``, whose residual the caller
folds in here (``ef_compress_tree(grads, residual)``), as
``chip_smoke.py`` [31] (c) and ``tests/test_torch_distributed.py`` do.
"""

from __future__ import annotations

import torch

from ..tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["compress", "decompress", "ef_compress_tree", "ef_update_tree",
           "init_error_feedback"]

f32 = torch.float32


def compress(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of one tensor: (q, scale)."""
    g32 = g.to(f32)
    scale = torch.max(torch.abs(g32)) / 127.0 + 1e-30
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = f32) -> torch.Tensor:
    return (q.to(f32) * scale).to(dtype)


def init_error_feedback(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=f32,
                                          device=g.device), grads)


def ef_compress_tree(grads, err):
    """Error-feedback compression: quantize g + err; returns (qs, scales,
    new_err), new_err the quantization residual."""
    qs, ss, es = [], [], []
    for g, e in zip(tree_leaves(grads), tree_leaves(err)):
        corrected = g.to(f32) + e
        q, s = compress(corrected)
        qs.append(q)
        ss.append(s)
        es.append(corrected - decompress(q, s))
    return (tree_unflatten(grads, qs), tree_unflatten(grads, ss),
            tree_unflatten(grads, es))


def ef_update_tree(qs, scales, dtype: torch.dtype = f32):
    return tree_map(lambda q, s: decompress(q, s, dtype), qs, scales)
