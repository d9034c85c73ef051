"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc and skip without one.  The file
imports no JAX (the machine with the card has none), so on that machine

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

runs them.  Tolerances: 2e-2 abs and rel in bf16; in f32 2e-4 for the
matmul and 2e-3 abs / 1e-3 rel for flash attention (tests/test_kernels.py's
tolerances for each kernel).
"""

import itertools

import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import LAUNCHES as FLASH_LAUNCHES
from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                 flash_attention_plain)
from repro_torch.kernels.matmul import LAUNCHES as MATMUL_LAUNCHES
from repro_torch.kernels.matmul import matmul_kernel, matmul_plain

VARIANTS = {
    "causal": dict(causal=True),
    "full": dict(causal=False),
    "window": dict(causal=True, window=64),
    "softcap": dict(causal=True, softcap=30.0),
}


@pytest.mark.cuda
def test_cuda_matmul_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-4
        x = torch.randn(256, 512, generator=gen, device="cuda").to(dtype)
        y = torch.randn(512, 384, generator=gen, device="cuda").to(dtype)
        before = MATMUL_LAUNCHES.count
        out = matmul_kernel(x, y, bm=64, bn=128, bk=32)
        assert MATMUL_LAUNCHES.count == before + 1
        torch.testing.assert_close(out.float(), matmul_plain(x, y).float(),
                                   atol=tol, rtol=tol)
        torch.testing.assert_close(ops.matmul(x, y).float(),
                                   matmul_plain(x, y).float(),
                                   atol=tol, rtol=tol)


@pytest.mark.cuda
def test_cuda_flash_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype, d, (name, kw) in itertools.product(
            (torch.bfloat16, torch.float32), (64, 128, 256),
            VARIANTS.items()):
        atol, rtol = (2e-2, 2e-2) if dtype == torch.bfloat16 else (2e-3, 1e-3)
        q = torch.randn(8, 200, d, generator=gen, device="cuda").to(dtype)
        k = torch.randn(2, 200, d, generator=gen, device="cuda").to(dtype)
        v = torch.randn(2, 200, d, generator=gen, device="cuda").to(dtype)
        heads = dict(num_q_heads=4, num_kv_heads=1)
        plain = flash_attention_plain(q, k, v, **heads, **kw)
        before = FLASH_LAUNCHES.count
        out = flash_attention_kernel(q, k, v, bq=32, bkv=64, **heads, **kw)
        assert FLASH_LAUNCHES.count == before + 1
        torch.testing.assert_close(out.float(), plain.float(), atol=atol,
                                   rtol=rtol)
        torch.testing.assert_close(
            ops.flash_attention(q, k, v, **heads, **kw).float(),
            plain.float(), atol=atol, rtol=rtol)
