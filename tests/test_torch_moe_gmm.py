"""The port's grouped (expert) matmul against the JAX package's, on the CPU.

``moe_gmm_plain`` and the CPU path of ``ops.moe_gmm`` / ``moe_gmm_kernel``
are held against the reference's Pallas kernel run in interpret mode and its
pure-jnp oracle, on the same seeded numpy inputs, at the shapes of
tests/test_kernels.py's grouped-matmul test and at shapes no tile divides.
Tolerances: 2e-4 for f32 and 2e-2 for bf16 (both sides sum in f32, in
different orders; bf16 outputs round once).  The Hopper spec is held against
the kernel's own limits, and a ``HopperModel`` build against exhaustive
search.  The CUDA kernel itself runs only on a card
(tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref
from repro.kernels.moe_gmm import moe_gmm_pallas

from repro_torch.core import (H100, CandidateTable, HopperModel, Klaraptor,
                              choose_or_default, gmm_probe_data, moe_gmm_spec,
                              registry, selection_ratio)
from repro_torch.core.kernel_spec import SM90_TILES, sm90_smem_bytes
from repro_torch.kernels import moe_gmm as port_gmm
from repro_torch.kernels import ops
from repro_torch.kernels.moe_gmm import (LAUNCHES, moe_gmm_kernel,
                                         moe_gmm_plain)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return 2e-2 if name == "bfloat16" else 2e-4


def _inputs(seed, e, g, k, n):
    rng = np.random.RandomState(seed)
    return ((rng.randn(e, g, k) * 0.3).astype(np.float32),
            (rng.randn(e, k, n) * 0.3).astype(np.float32))


def _both(a, name):
    jdt, tdt = DTYPES[name]
    return jnp.asarray(a, dtype=jdt), torch.from_numpy(a).to(tdt)


def _close(port, expected, name):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(expected, np.float32),
                               atol=_tol(name), rtol=_tol(name))


@pytest.mark.parametrize("e,g,k,n", [(2, 64, 128, 128), (4, 128, 256, 128),
                                     (8, 32, 128, 384)])
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_plain_and_ops_match_reference(e, g, k, n, name):
    xa, wa = _inputs(e + g + k + n, e, g, k, n)
    (xj, xt), (wj, wt) = _both(xa, name), _both(wa, name)
    pallas = moe_gmm_pallas(xj, wj, bg=32, bn=128, bk=128, interpret=True)
    oracle = ref.moe_gmm_ref(xj, wj)
    if name == "bfloat16":
        # the wgmma kernel's tiles: g is zero-padded to its 64-row granule
        gp = -(-g // 64) * 64
        xp = torch.nn.functional.pad(xt, (0, 0, 0, gp - g))
        direct = moe_gmm_kernel(xp, wt, bg=64, bn=64, bk=64)[:, :g]
    else:
        direct = moe_gmm_kernel(xt, wt, bg=16, bn=64, bk=32)
    for port in (moe_gmm_plain(xt, wt), ops.moe_gmm(xt, wt), direct):
        assert port.shape == (e, g, n) and port.dtype == xt.dtype
        _close(port, pallas, name)
        _close(port, oracle, name)


@pytest.mark.parametrize("e,g,k,n", [(3, 37, 45, 29), (1, 5, 130, 7)])
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_ops_pads_unaligned_shapes(e, g, k, n, name, monkeypatch):
    """g, k, n that no tile divides are zero-padded to the kernel's
    granules (64 in bf16, 8 in f32) and sliced back: the same outputs as
    the reference oracle, launched at a tile the kernel takes."""
    seen = []

    def recording(x, w, **kw):
        seen.append((tuple(x.shape), tuple(w.shape), kw))
        return moe_gmm_kernel(x, w, **kw)

    monkeypatch.setattr(ops, "moe_gmm_kernel", recording)
    xa, wa = _inputs(7 * g + k, e, g, k, n)
    (xj, xt), (wj, wt) = _both(xa, name), _both(wa, name)
    out = ops.moe_gmm(xt, wt)
    assert out.shape == (e, g, n) and out.dtype == xt.dtype
    _close(out, ref.moe_gmm_ref(xj, wj), name)
    a = 64 if name == "bfloat16" else 8
    (xs, ws, kw), = seen
    assert xs == (e, -(-g // a) * a, -(-k // a) * a)
    assert ws == (e, -(-k // a) * a, -(-n // a) * a)
    if name == "bfloat16":
        assert (kw["bg"], kw["bn"], kw["bk"]) in SM90_TILES


def test_cpu_wrapper_counts_no_launch():
    x, w = (torch.from_numpy(a) for a in _inputs(0, 2, 64, 64, 64))
    before = LAUNCHES.count
    moe_gmm_kernel(x, w, bg=32, bn=32, bk=32)
    ops.moe_gmm(x, w)
    assert LAUNCHES.count == before


@pytest.mark.parametrize("bad", [
    dict(bg=12, bn=64, bk=32),         # not a multiple of 8
    dict(bg=48, bn=64, bk=32),         # does not divide g
    dict(bg=256, bn=256, bk=32),       # 1024 threads > 512
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x = torch.zeros(2, 256, 64)
    w = torch.zeros(2, 64, 256)
    with pytest.raises(ValueError):
        moe_gmm_kernel(x, w, **bad)
    # bf16 takes only the wgmma kernel's compiled tiles
    with pytest.raises(ValueError):
        moe_gmm_kernel(x.bfloat16(), w.bfloat16(), **bad)
    with pytest.raises(ValueError):
        moe_gmm_kernel(x, torch.zeros(3, 64, 256), bg=32, bn=32, bk=32)
    with pytest.raises(ValueError):
        moe_gmm_kernel(x, w.to(torch.bfloat16), bg=32, bn=32, bk=32)


@pytest.mark.parametrize("elem", [2, 4])
def test_spec_feasibility_is_the_kernels_limits(elem):
    """A tile is feasible in the Hopper spec exactly when the kernel's
    argument check takes it (threads >= a warp aside: the kernel runs
    smaller CTAs, the spec does not choose them), and the spec's stage bytes
    are the kernel's dynamic shared memory."""
    spec = moe_gmm_spec(elem)
    dtype = torch.bfloat16 if elem == 2 else torch.float32
    D = {"e": 2, "g": 512, "k": 512, "n": 512}
    grid = CandidateTable.product(
        spec.program_params, [(8, 16, 24, 64, 512, 1024)] * 3)
    mask = spec.feasible_mask(D, grid, H100)
    stage = spec._eval(spec.stage_expr(), D, grid)
    threads = spec._eval(spec.threads, D, grid)
    x = torch.zeros(2, 512, 512, dtype=dtype)
    for i in range(len(grid)):
        P = grid.row(i)
        try:
            port_gmm._check(x, x, **P)
            takes = True
        except ValueError:
            takes = False
        assert (takes and threads[i] >= 32) == bool(mask[i]), (P, takes)
        if takes and elem == 2:     # the wgmma kernel's ring
            assert stage[i] == sm90_smem_bytes(P["bg"], P["bn"], P["bk"])
        elif takes:
            assert stage[i] == (P["bg"] + P["bn"]) * P["bk"] * elem
    table = spec.candidates(D, H100)
    tt = spec.traffic_table(D, table, H100)
    assert np.all(tt.ctas == 2 * (512 // table["bg"]) * (512 // table["bn"]))
    assert np.all(tt.seq_iters == 512 // table["bk"])


def test_spec_matches_reference_interface():
    """Name, data and program parameters are the reference's, so the
    drivers' keys are the same."""
    from repro.core.kernel_spec import moe_gmm_spec as ref_spec
    for elem in (2, 4):
        mine, theirs = moe_gmm_spec(elem), ref_spec(dtype_bytes=elem)
        assert mine.name == theirs.name
        assert mine.data_params == theirs.data_params
        assert mine.program_params == theirs.program_params


@pytest.fixture(scope="module")
def built():
    registry.clear()
    oracle = HopperModel(noise=0.04, seed=11)
    spec = moe_gmm_spec(dtype_bytes=2)
    build = Klaraptor(oracle, device="cpu", cache=False).build_driver(
        spec, probe_data=gmm_probe_data(), repeats=2,
        max_configs_per_size=24)
    yield spec, oracle, build
    registry.clear()


def test_probes_keep_few_experts(built):
    _, _, build = built
    cols = build.collected.columns
    assert set(np.unique(cols["e"]).tolist()) <= {2, 4}
    assert max(int(cols[d].max()) for d in ("g", "k", "n")) <= 1024


@pytest.mark.parametrize("D", [
    {"e": 8, "g": 4096, "k": 4096, "n": 1536},
    {"e": 8, "g": 4096, "k": 1536, "n": 4096},
    {"e": 16, "g": 512, "k": 1024, "n": 1024},
])
def test_selection_ratio_on_unseen_sizes(built, D):
    spec, oracle, build = built
    r = selection_ratio(spec, oracle, build.driver, D, H100)
    assert r["ratio"] >= 0.85, r


def test_ops_dispatches_through_the_driver(built):
    """With a driver registered, ops.moe_gmm launches the driver's choice
    (snapped to the shape), and its output stays the oracle's."""
    _, _, build = built
    D = {"e": 2, "g": 256, "k": 512, "n": 256}
    cfg = choose_or_default("moe_gmm_b16", D, ops.GMM_DEFAULT)
    assert cfg == build.driver.choose(D) and cfg != ops.GMM_DEFAULT
    xa, wa = _inputs(3, 2, 256, 512, 256)
    (xj, xt), (wj, wt) = _both(xa, "bfloat16"), _both(wa, "bfloat16")
    _close(ops.moe_gmm(xt, wt), ref.moe_gmm_ref(xj, wj), "bfloat16")
