"""The port's matmul against the JAX package's, on the CPU.

``matmul_plain`` and the CPU path of ``ops.matmul`` / ``matmul_kernel`` are
held against the reference's Pallas kernel run in interpret mode and its
pure-jnp oracle, on the same seeded numpy inputs.  Tolerances are those of
tests/test_kernels.py: 2e-4 for f32 and 2e-2 for bf16 (both sides sum in
f32, in different orders; bf16 outputs round once).  The CUDA kernel itself
runs only on a card: tests/test_torch_cuda.py holds it against the plain
version there and skips elsewhere.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as ref_ops
from repro.kernels import ref
from repro.kernels.matmul import matmul_pallas

from repro_torch.kernels import _build, ops
from repro_torch.kernels import matmul as port_matmul
from repro_torch.kernels.matmul import LAUNCHES, matmul_kernel, matmul_plain

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return 2e-2 if name == "bfloat16" else 2e-4


def _inputs(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * 0.5).astype(np.float32) for s in shapes]


def _both(a, name):
    """One numpy array as (jax array, torch tensor) of the named dtype."""
    jdt, tdt = DTYPES[name]
    return jnp.asarray(a, dtype=jdt), torch.from_numpy(a).to(tdt)


def _close(port, expected, name):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(expected, np.float32),
                               atol=_tol(name), rtol=_tol(name))


@pytest.mark.parametrize("m,n,k", [(64, 128, 128), (128, 256, 384),
                                   (256, 128, 512), (8, 128, 128)])
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_plain_and_ops_match_reference(m, n, k, name):
    xa, ya = _inputs(m + n + k, (m, k), (k, n))
    (xj, xt), (yj, yt) = _both(xa, name), _both(ya, name)
    pallas = matmul_pallas(xj, yj, bm=min(64, m), bn=128, bk=128,
                           interpret=True)
    oracle = ref.matmul_ref(xj, yj)
    for port in (matmul_plain(xt, yt), ops.matmul(xt, yt)):
        assert port.dtype == DTYPES[name][1]
        _close(port, pallas, name)
        _close(port, oracle, name)


@pytest.mark.parametrize("bm,bn,bk", [(8, 128, 128), (32, 256, 128),
                                      (64, 128, 256), (128, 128, 128)])
def test_kernel_wrapper_cpu_block_sweep(bm, bn, bk):
    xa, ya = _inputs(7, (128, 256), (256, 256))
    (xj, xt), (yj, yt) = _both(xa, "float32"), _both(ya, "float32")
    expected = matmul_pallas(xj, yj, bm=bm, bn=bn, bk=bk, interpret=True)
    _close(matmul_kernel(xt, yt, bm=bm, bn=bn, bk=bk), expected, "float32")


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_batched_matches_reference_ops(name):
    xa, ya = _inputs(3, (2, 3, 64, 128), (128, 256))
    (xj, xt), (yj, yt) = _both(xa, name), _both(ya, name)
    expected = ref_ops.matmul(xj, yj, use_pallas=True, interpret=True)
    out = ops.matmul(xt, yt)
    assert tuple(out.shape) == (2, 3, 64, 256)
    _close(out, expected, name)


@pytest.mark.parametrize("name,out_name", [("bfloat16", "float32"),
                                           ("float32", "bfloat16"),
                                           ("bfloat16", "float16")])
def test_out_dtype_matches_reference(name, out_name):
    jout = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
            "float16": jnp.float16}[out_name]
    tout = getattr(torch, out_name)
    xa, ya = _inputs(5, (64, 256), (256, 128))
    (xj, xt), (yj, yt) = _both(xa, name), _both(ya, name)
    expected = ref.matmul_ref(xj, yj, out_dtype=jout)
    for out in (matmul_plain(xt, yt, tout), ops.matmul(xt, yt, out_dtype=tout),
                matmul_kernel(xt, yt, bm=32, bn=64, bk=64, out_dtype=tout)):
        assert out.dtype == tout
        tol = max(_tol(name), _tol(out_name))
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(expected, np.float32),
                                   atol=tol, rtol=tol)


def test_ops_pads_unaligned_shapes():
    xa, ya = _inputs(9, (5, 60, 100), (100, 36))
    (xj, xt), (yj, yt) = _both(xa, "float32"), _both(ya, "float32")
    _close(ops.matmul(xt, yt), ref.matmul_ref(xj, yj), "float32")


def test_wrapper_raises_and_never_falls_back(monkeypatch, tmp_path):
    LAUNCHES.reset()
    x, y = torch.randn(64, 128), torch.randn(128, 256)
    for kw in (dict(bm=12, bn=64, bk=64),     # not a multiple of 8
               dict(bm=48, bn=64, bk=64),     # does not divide m = 64
               dict(bm=64, bn=128, bk=0)):    # empty tile
        with pytest.raises(ValueError):
            matmul_kernel(x, y, **kw)
    big_x, big_y = torch.randn(256, 256), torch.randn(256, 256)
    with pytest.raises(ValueError, match="threads"):
        matmul_kernel(big_x, big_y, bm=256, bn=256, bk=8)
    with pytest.raises(ValueError, match="shared memory"):
        matmul_kernel(big_x, big_y, bm=256, bn=128, bk=256)
    with pytest.raises(ValueError, match="dtype"):
        matmul_kernel(x.double(), y.double(), bm=64, bn=64, bk=64)
    with pytest.raises(ValueError, match="dtype"):
        matmul_kernel(x, y.bfloat16(), bm=64, bn=64, bk=64)
    with pytest.raises(ValueError, match="contiguous"):
        matmul_kernel(x, y.t().contiguous().t(), bm=64, bn=64, bk=64)
    with pytest.raises(ValueError):
        ops.matmul(x.to("meta"), y.to("meta"))
    assert LAUNCHES.count == 0
    # A build failure surfaces as an error; nothing catches it and runs the
    # plain version instead.
    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.load.cache_clear()
    port_matmul._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            port_matmul.kernel_attributes(torch.float32)
    finally:
        _build.load.cache_clear()
        port_matmul._lib.cache_clear()
    assert LAUNCHES.count == 0
