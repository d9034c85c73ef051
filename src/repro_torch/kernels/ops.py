"""Tuned kernel dispatch -- the runtime integration point of KLARAPTOR.

Each op consults the driver registry *immediately before launch* (paper
Section V-C: one IO call per kernel call, data parameters in, launch
parameters out), snaps the tiles to the shape with ``fit_tile`` at the
granularities the port's kernel spec states, and launches the CUDA kernel.
With no driver registered the op uses the static default config.

A CUDA tensor always goes to the kernel (or raises); only a CPU tensor takes
the kernel's plain PyTorch version.
"""

from __future__ import annotations

import functools
from typing import Callable, Mapping

import torch
import torch.nn.functional as F

from ..core.driver import choose_or_default, fit_tile
from ..core.kernel_spec import matmul_spec
from .matmul import matmul_kernel, matmul_plain

__all__ = ["MATMUL_DEFAULT", "matmul", "matmul_kernel_name",
           "probe_launcher"]

# Static heuristic default (what a programmer would hard-code).
MATMUL_DEFAULT = {"bm": 128, "bn": 128, "bk": 32}

_MATMUL_KERNELS = {torch.bfloat16: "matmul_b16", torch.float32: "matmul_b32"}


def matmul_kernel_name(dtype: torch.dtype) -> str:
    """The kernel-spec name the matmul of ``dtype`` inputs is tuned under."""
    try:
        return _MATMUL_KERNELS[dtype]
    except KeyError:
        raise ValueError(f"no matmul kernel for {dtype}; inputs must be "
                         f"one of {tuple(_MATMUL_KERNELS)}") from None


@functools.lru_cache(maxsize=None)
def _alignments(kernel: str) -> dict[str, int]:
    spec = matmul_spec(dtype_bytes=2 if kernel == "matmul_b16" else 4)
    return {p: spec.alignment(p) for p in spec.program_params}


def _round_up(v: int, a: int) -> int:
    return -(-v // a) * a


def matmul(x: torch.Tensor, y: torch.Tensor, *,
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Tuned x @ y over the last two dims of x; leading dims are batched.

    ``y`` is one (k, n) matrix shared by every batch entry, so the batch
    folds into m and the product is one launch at (batch * m, n, k).  Dims
    that are not multiples of the spec's granularity are zero-padded (exact
    for a product) and the result is sliced back.
    """
    if x.ndim < 2 or y.ndim != 2 or x.shape[-1] != y.shape[0]:
        raise ValueError(f"matmul takes x (..., m, k) and y (k, n); got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    k, n = y.shape
    x2 = x.reshape(-1, k)
    if x.device.type == "cpu" and y.device.type == "cpu":
        return matmul_plain(x2, y, out_dtype).reshape(*lead, n)
    if x.device.type != "cuda":
        raise ValueError(f"matmul runs on cuda or cpu tensors, not {x.device}")
    kernel = matmul_kernel_name(x.dtype)
    align = _alignments(kernel)
    m = x2.shape[0]
    mp, np_, kp = (_round_up(m, align["bm"]), _round_up(n, align["bn"]),
                   _round_up(k, align["bk"]))
    if (mp, kp) != (m, k):
        x2 = F.pad(x2, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        y = F.pad(y, (0, np_ - n, 0, kp - k))
    x2, y2 = x2.contiguous(), y.contiguous()
    cfg = choose_or_default(kernel, {"m": mp, "n": np_, "k": kp},
                            MATMUL_DEFAULT)
    out = matmul_kernel(x2, y2, bm=fit_tile(mp, cfg["bm"], align["bm"]),
                        bn=fit_tile(np_, cfg["bn"], align["bn"]),
                        bk=fit_tile(kp, cfg["bk"], align["bk"]),
                        out_dtype=out_dtype)
    if (mp, np_) != (m, n):
        out = out[:m, :n]
    return out.reshape(*lead, n)


def probe_launcher(kernel: str, D: Mapping[str, int], device: torch.device,
                   seed: int) -> Callable[[Mapping[str, int]], None]:
    """Bind seeded inputs of kernel ``kernel`` at data size D on ``device``
    and return ``launch(P)``, which runs the kernel once at tiles P --
    what ``CudaEventTimer`` times."""
    if kernel not in _MATMUL_KERNELS.values():
        raise ValueError(f"no probe launcher for kernel {kernel!r}")
    dtype = torch.bfloat16 if kernel == "matmul_b16" else torch.float32
    gen = torch.Generator(device=device).manual_seed(int(seed))
    x = torch.randn(D["m"], D["k"], generator=gen, device=device).to(dtype)
    y = torch.randn(D["k"], D["n"], generator=gen, device=device).to(dtype)

    def launch(P: Mapping[str, int]) -> None:
        matmul_kernel(x, y, bm=int(P["bm"]), bn=int(P["bn"]),
                      bk=int(P["bk"]))

    return launch
