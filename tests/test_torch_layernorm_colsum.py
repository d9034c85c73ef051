"""The port's fused layernorm + residual and blocked column sum against the
JAX package's, on the CPU.

``layernorm_plain`` / ``ops.layernorm`` and ``colsum_plain`` /
``ops.blocked_colsum`` (whose CPU path resolves a config through the derived
spec and runs the kernel wrapper, which takes the plain version for CPU
tensors) are held against the reference's pure-jnp oracles and its Pallas
kernels run in interpret mode, on the same seeded numpy inputs.  The JAX
``ops.layernorm(use_pallas=True)`` cannot serve: it introspects the Pallas
kernel, which raises on this jax (ROADMAP, "Known reference faults"), so
the kernels are called directly.  Tolerances: layernorm atol 1e-5 in f32
(tests/test_introspect.py's) and 2e-2 in bf16; column sums rtol 1e-5, on
inputs in [0, 1) so that no column sum cancels towards 0.  The CUDA kernels
run only on a card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref
from repro.kernels.layernorm import layernorm_pallas
from repro.kernels.reduce import colsum_pallas

from repro_torch.introspect import get_auto
from repro_torch.kernels import layernorm as port_ln
from repro_torch.kernels import ops
from repro_torch.kernels import reduce as port_cs

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
LN_ATOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _both(a, name):
    jdt, tdt = DTYPES[name]
    return jnp.asarray(a, dtype=jdt), torch.from_numpy(a).to(tdt)


def _ln_inputs(seed, r, c):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32)
            for s in ((r, c), (r, c), (c,), (c,))]


@pytest.mark.parametrize("r,c", [(64, 256), (128, 512), (100, 72)])
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_layernorm_matches_reference(r, c, name):
    xa, ra, ga, ba = _ln_inputs(r + c, r, c)
    (xj, xt), (rj, rt) = _both(xa, name), _both(ra, name)
    gt, bt = torch.from_numpy(ga), torch.from_numpy(ba)
    oracle = ref.layernorm_ref(xj, rj, ga, ba)
    br = 16 if r % 16 == 0 else r
    pallas = layernorm_pallas(xj, rj, ga, ba, br=br, interpret=True)
    atol = LN_ATOL[name]
    for port in (port_ln.layernorm_plain(xt, rt, gt, bt),
                 ops.layernorm(xt, rt, gt, bt),
                 port_ln.layernorm_kernel(xt, rt, gt, bt, br=br)):
        assert port.shape == (r, c) and port.dtype == xt.dtype
        for expected in (oracle, pallas):
            np.testing.assert_allclose(port.float().numpy(),
                                       np.asarray(expected, np.float32),
                                       atol=atol, rtol=0)


def test_layernorm_eps_reaches_the_kernel():
    xa, ra, ga, ba = _ln_inputs(1, 32, 64)
    xa *= 1e-3
    (xj, xt), (rj, rt) = _both(xa, "float32"), _both(ra, "float32")
    gt, bt = torch.from_numpy(ga), torch.from_numpy(ba)
    got = ops.layernorm(xt, rt, gt, bt, eps=1e-3)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(ref.layernorm_ref(xj, rj, ga, ba, eps=1e-3)),
        atol=1e-5, rtol=0)
    assert not np.allclose(got.numpy(), ops.layernorm(xt, rt, gt, bt).numpy(),
                           atol=1e-2)


def test_layernorm_eps_reaches_the_spec():
    """The spec ops.layernorm dispatches through carries the eps it
    launches with, and so does its fingerprint."""
    xt, rt, gt, bt = (torch.from_numpy(a) for a in _ln_inputs(3, 16, 40))
    prints = []
    for eps in (1e-3, 1e-6):
        ops.layernorm(xt, rt, gt, bt, eps=eps)
        ak = get_auto("layernorm_c40_b32")
        assert ak.grid_spec.call_kwargs == {"eps": eps}
        prints.append(ak.spec.source_fingerprint)
    assert prints[0] != prints[1]


@pytest.mark.parametrize("r", [4097, 4099])
def test_layernorm_ragged_rows_keep_many_ctas(r, monkeypatch):
    """A row count that no multiple of 8 divides keeps the resolved row tile
    (the kernel masks the last block), so the launch has many CTAs, not
    one of r rows."""
    launched = []

    def spy(*args, br, **kwargs):
        launched.append(br)
        return port_ln.layernorm_kernel(*args, br=br, **kwargs)

    monkeypatch.setattr(ops, "layernorm_kernel", spy)
    xa, ra, ga, ba = _ln_inputs(r, r, 64)
    xt, rt, gt, bt = (torch.from_numpy(a) for a in (xa, ra, ga, ba))
    got = ops.layernorm(xt, rt, gt, bt)
    (br,) = launched
    assert br % 8 == 0 and -(-r // br) > 1
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(ref.layernorm_ref(xa, ra, ga, ba)),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("r,c", [(64, 256), (512, 384), (99, 13), (8, 1024)])
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_colsum_matches_reference(r, c, name):
    xa = np.random.RandomState(r * c).rand(r, c).astype(np.float32)
    xj, xt = _both(xa, name)
    oracle = np.asarray(ref.colsum_ref(xj))
    for port in (port_cs.colsum_plain(xt), ops.blocked_colsum(xt)):
        assert port.shape == (c,) and port.dtype == torch.float32
        np.testing.assert_allclose(port.numpy(), oracle, rtol=1e-5)
    if r % 8 == 0 and c % 128 == 0:
        pallas = colsum_pallas(xj, br=8, bc=128, interpret=True)
        np.testing.assert_allclose(port_cs.colsum_kernel(xt, br=8, bc=128),
                                   np.asarray(pallas)[0], rtol=1e-5)


@pytest.mark.parametrize("r,c,br", [(64, 256, 8), (512, 384, 64),
                                    (1024, 128, 1024)])
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_colsum_split_order_matches_reference(r, c, br, name):
    """The kernel's two-level order -- an f32 sum per split of br rows, then
    the splits added in row-split order -- computes the reference's column
    sums."""
    xa = np.random.RandomState(r + c + br).randn(r, c).astype(np.float32)
    xj, xt = _both(xa, name)
    got = port_cs.colsum_split_order(xt, br)
    assert got.shape == (c,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.colsum_ref(xj)),
                               rtol=1e-5, atol=1e-4)


def test_cpu_wrappers_count_no_launch():
    xa, ra, ga, ba = (torch.from_numpy(a) for a in _ln_inputs(2, 64, 128))
    before = (port_ln.LAUNCHES.count, port_cs.LAUNCHES.count)
    ops.layernorm(xa, ra, ga, ba)
    ops.blocked_colsum(xa)
    assert (port_ln.LAUNCHES.count, port_cs.LAUNCHES.count) == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(64, 128)
    g = torch.zeros(128)
    with pytest.raises(ValueError):
        port_ln.layernorm_kernel(x, x, g, g, br=0)
    with pytest.raises(ValueError):
        port_ln.layernorm_kernel(x, x.to(torch.bfloat16), g, g, br=8)
    with pytest.raises(ValueError):
        port_ln.layernorm_kernel(x, x, torch.zeros(64), g, br=8)
    with pytest.raises(ValueError):
        port_cs.colsum_kernel(x, br=8, bc=12)                 # not 8-granular
    with pytest.raises(ValueError):
        port_cs.colsum_kernel(torch.zeros(64, 2048), br=8, bc=2048)  # threads
    with pytest.raises(ValueError):
        port_cs.colsum_kernel(x, br=24, bc=128)               # 24 ∤ 64


@pytest.mark.parametrize("r,c,br", [(4096, 2048, 128), (100, 72, 100),
                                    (4097, 2048, 128)])
def test_layernorm_launch_description(r, c, br):
    """The described launch is the one the kernel makes: ceil(r / br) CTAs
    of 256 threads, the last one masked, gamma and beta staged as f32 in
    8 c bytes of shared memory."""
    d = port_ln.layernorm_launch(
        (((r, c), torch.bfloat16), ((r, c), torch.bfloat16),
         ((c,), torch.float32), ((c,), torch.float32)), br=br)
    assert d.grid == (-(-r // br),) and d.loops == () and d.ragged == (0,)
    assert d.threads == port_ln.LN_THREADS and d.smem_bytes == 8 * c
    assert [op.deps for op in d.operands] == [(0,), (0,), (), (), (0,)]
    assert d.flops == port_ln.LN_FLOPS_PER_ELEMENT * r * c


@pytest.mark.parametrize("r,c,br,bc", [(8192, 4096, 256, 512),
                                       (2048, 8192, 8, 1024)])
def test_colsum_launch_description(r, c, br, bc):
    """The row splits are a grid axis and no loop; the partial sums are
    written and read back once per CTA, the output once per column block."""
    d = port_cs.colsum_launch((((r, c), torch.bfloat16),), br=br, bc=bc)
    assert d.grid == (c // bc, r // br) and d.loops == ()
    assert d.threads == bc and d.smem_bytes == 8 * bc * 4
    x, part_out, part_in, out, scratch = d.operands
    assert x.deps == (0, 1) and out.deps == (0,) and out.is_output
    assert part_out.deps == part_in.deps == (0, 1)
    assert part_out.is_output and not part_in.is_output
    assert part_out.tile == part_in.tile == out.tile == (bc,)
    assert scratch.scratch and scratch.tile == (8, bc)
