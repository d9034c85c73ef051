"""Zeroed integer workspaces that kernels leave zeroed.

The column sum's tickets and the SSD scan's ticket counter and chain flags
(forward and backward) are integers a launch reads, updates and sets back
to 0 before it ends, so one zeroed buffer serves every later launch on the
same stream (launches on a stream run in order).  ``zeroed_ints`` keeps one
such buffer per (device, stream, user) and grows it by allocating a new
zeroed one.  A buffer it replaces
stays allocated: a CUDA graph captured with it holds its address and goes on
using it (zeroed, as every launch leaves it) at every replay.
"""

from __future__ import annotations

import torch

__all__ = ["zeroed_ints"]

_BUFFERS: dict[tuple[torch.device, int, str], torch.Tensor] = {}
_REPLACED: list[torch.Tensor] = []


def zeroed_ints(device: torch.device, stream: int, n: int,
                user: str = "") -> torch.Tensor:
    """At least ``n`` zeroed int32 on ``device`` for launches on ``stream``
    (a ``cuda_stream`` handle) by ``user``, to be left zeroed by every
    launch."""
    key = (torch.device(device), int(stream), user)
    buf = _BUFFERS.get(key)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _REPLACED.append(buf)
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _BUFFERS[key] = buf
    return buf
