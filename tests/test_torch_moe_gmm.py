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

import jax
import jax.numpy as jnp

from repro.kernels import ref
from repro.kernels.moe_gmm import moe_gmm_pallas

from repro_torch.core import (H100, CandidateTable, HopperModel, Klaraptor,
                              choose_or_default, gmm_probe_data, moe_gmm_spec,
                              registry, selection_ratio)
from repro_torch.core.kernel_spec import (SM90_TILES, simt_smem_bytes,
                                          sm90_smem_bytes)
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
        elif takes:                 # the SIMT kernel's cp.async ring
            assert stage[i] == simt_smem_bytes(P["bg"], P["bn"], P["bk"])
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


# ---------------------------------------------------------------------------
# the backward: moe_gmm_backward_plain and the autograd Function
# ---------------------------------------------------------------------------

def _ref_vjp(xa, wa, dya, name):
    (xj, _), (wj, _), (dyj, _) = (_both(a, name) for a in (xa, wa, dya))
    _, vjp = jax.vjp(ref.moe_gmm_ref, xj, wj)
    return [np.asarray(g, np.float32) for g in vjp(dyj)]


def _hold_grads(got, expected, tol):
    for name, g, r in zip(("dx", "dw"), got, expected):
        np.testing.assert_allclose(g.float().numpy(), r, rtol=0,
                                   atol=tol * np.abs(r).max(), err_msg=name)


BACKWARD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("e,g,k,n", [(2, 64, 128, 128), (4, 128, 64, 192),
                                     (3, 37, 45, 29)])
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_backward_plain_matches_vjp_of_the_reference(e, g, k, n, name):
    """(dx, dw) against jax.vjp of the reference's moe_gmm_ref: f32 at 1e-5
    and bf16 at 2e-2 of max |g|; dx has x's dtype, dw w's."""
    xa, wa = _inputs(e * g + n, e, g, k, n)
    dya = np.random.RandomState(g).randn(e, g, n).astype(np.float32)
    xt, wt, dyt = (_both(a, name)[1] for a in (xa, wa, dya))
    got = port_gmm.moe_gmm_backward_plain(xt, wt, dyt)
    assert [t.dtype for t in got] == [xt.dtype, wt.dtype]
    _hold_grads(got, _ref_vjp(xa, wa, dya, name), BACKWARD_TOL[name])


@pytest.mark.parametrize("e,g,k,n", [(3, 37, 45, 29), (2, 70, 130, 64)])
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_ops_moe_gmm_gradient_through_the_function(e, g, k, n, name,
                                                   monkeypatch):
    """``ops.moe_gmm`` with grad on, its autograd Function forced on CPU
    tensors (on the card it runs for CUDA inputs that require grad): the
    padded product's forward and backward go through the wrappers (each
    takes its plain version on the CPU), the padding's slice stays
    autograd's, and (dx, dw) equal jax.vjp of moe_gmm_ref at the unpadded
    shape; the backward's two products are tiled at tiles the kernel
    takes for their own dims (bf16: ``backward_tiles``'s rule, f32: the
    SIMT tiles ``_resolve`` gives)."""
    calls = []

    def recording(x, w, dy, *, dx_tiles=None, dw_tiles=None):
        calls.append((tuple(x.shape), tuple(w.shape), dx_tiles, dw_tiles))
        e_, g_, k_ = x.shape
        n_ = w.shape[2]
        if x.dtype == torch.float32:
            port_gmm._check_tiles(e_, g_, n_, k_, x.dtype, **dx_tiles)
            port_gmm._check_tiles(e_, k_, g_, n_, x.dtype, **dw_tiles)
        else:                   # bf16: the body's own rule
            assert dx_tiles is None and dw_tiles is None
            for p, t in port_gmm.backward_tiles(e_, g_, k_, n_).items():
                port_gmm._check_backward_tiles(e_, g_, k_, n_, p, **t)
        return port_gmm.moe_gmm_backward_kernel(
            x, w, dy, dx_tiles=dx_tiles, dw_tiles=dw_tiles)

    monkeypatch.setattr(ops, "_wants_grad", lambda *t: torch.is_grad_enabled()
                        and any(a.requires_grad for a in t))
    monkeypatch.setattr(ops, "moe_gmm_backward_kernel", recording)
    xa, wa = _inputs(g + k, e, g, k, n)
    dya = np.random.RandomState(n).randn(e, g, n).astype(np.float32)
    x, w, dy = (_both(a, name)[1] for a in (xa, wa, dya))
    x.requires_grad_()
    w.requires_grad_()
    out = ops.moe_gmm(x, w)
    assert out.shape == (e, g, n) and out.grad_fn is not None
    got = torch.autograd.grad(out, (x, w), dy)
    a = 64 if name == "bfloat16" else 8
    (xs, ws, _, _), = calls
    assert xs == (e, -(-g // a) * a, -(-k // a) * a)
    assert ws == (e, -(-k // a) * a, -(-n // a) * a)
    _hold_grads(got, _ref_vjp(xa, wa, dya, name), BACKWARD_TOL[name])


def test_backward_wrapper_checks_and_counts_no_cpu_launch():
    x, w = (torch.from_numpy(a) for a in _inputs(1, 2, 64, 128, 64))
    dy = torch.ones(2, 64, 64)
    tiles = dict(bg=64, bn=64, bk=32)
    n0 = port_gmm.BACKWARD_LAUNCHES.count
    dx, dw = port_gmm.moe_gmm_backward_kernel(x, w, dy, dx_tiles=tiles,
                                              dw_tiles=tiles)
    assert port_gmm.BACKWARD_LAUNCHES.count == n0
    for g, r in zip((dx, dw), port_gmm.moe_gmm_backward_plain(x, w, dy)):
        assert torch.equal(g, r)
    xb, wb, dyb = x.bfloat16(), w.bfloat16(), dy.bfloat16()
    for products in (("dx",), ("dw",)):     # one product alone
        got = port_gmm.moe_gmm_backward_kernel(xb, wb, dyb, products=products)
        for name, g, r in zip(("dx", "dw"), got, port_gmm.
                              moe_gmm_backward_plain(xb, wb, dyb)):
            assert (g is None) == (name not in products)
            assert g is None or torch.equal(g, r)
    assert port_gmm.BACKWARD_LAUNCHES.count == n0
    with pytest.raises(ValueError, match="dy"):
        port_gmm.moe_gmm_backward_kernel(x, w, dy[:, :8], dx_tiles=tiles,
                                         dw_tiles=tiles)
    with pytest.raises(ValueError):         # bg 48 divides no dx row count
        port_gmm.moe_gmm_backward_kernel(x, w, dy, dx_tiles=dict(
            bg=48, bn=64, bk=32), dw_tiles=tiles)
    with pytest.raises(ValueError, match="dx_tiles and dw_tiles"):
        port_gmm.moe_gmm_backward_kernel(x, w, dy)      # f32 takes tiles
    with pytest.raises(ValueError):         # bn 256 does not divide n 64
        port_gmm.moe_gmm_backward_kernel(
            xb, wb, dyb, dx_tiles=dict(bm=64, bn=64),
            dw_tiles=dict(bm=64, bn=256))
    for bad, match in ((dict(dx_tiles=dict(bm=192, bn=256)), "compiled"),
                       (dict(dx_tiles=dict(bm=128)), "divide"),
                       (dict(dw_tiles=dict(ctas=0)), "ctas"),
                       (dict(dw_tiles=dict(bg=64, bn=64, bk=64)), "take"),
                       (dict(dw_tiles=dict(n_fast=2)), "n_fast"),
                       (dict(products=("dz",)), "products"),
                       (dict(products=()), "products")):
        with pytest.raises(ValueError, match=match):
            port_gmm.moe_gmm_backward_kernel(xb, wb, dyb, **bad)
    with pytest.raises(ValueError, match="multiple of 64"):
        # dx's k (n = 96) is not a whole number of 64-deep steps
        port_gmm.moe_gmm_backward_kernel(
            torch.zeros(1, 64, 64, dtype=torch.bfloat16),
            torch.zeros(1, 64, 96, dtype=torch.bfloat16),
            torch.zeros(1, 64, 96, dtype=torch.bfloat16),
            dx_tiles=dict(bm=64, bn=64), dw_tiles=dict(bm=64, bn=64))


@pytest.mark.parametrize("e,g,k,n,dx,dw", [
    # qwen3-moe's layer in training (B 8 x S 256: capacity 160 -> 192):
    # (bm, bn, ctas, n_fast)
    (128, 192, 4096, 1536, (192, 128, 132, 0), (128, 256, 132, 0)),
    (128, 192, 1536, 4096, (192, 128, 132, 0), (128, 256, 132, 0)),
    # grok-1's (2 groups x capacity 320 = 640 rows): the down product's dw
    # has an A of 42 MB an expert, walked n tiles fastest
    (8, 640, 6144, 32768, (128, 256, 132, 0), (128, 256, 132, 0)),
    (8, 640, 32768, 6144, (128, 256, 132, 0), (128, 256, 132, 1)),
    # small and ragged widths: fewer tiles than SMs, narrower tiles
    (2, 64, 128, 64, (64, 128, 2, 0), (128, 64, 2, 0)),
    (3, 320, 192, 320, (64, 64, 45, 0), (64, 64, 45, 0)),
])
def test_backward_tiles_rule(e, g, k, n, dx, dw):
    """``backward_tiles``: dx's rows the largest of 192 / 128 / 64 dividing
    the capacity, dw's 128 or 64, bn the largest compiled width dividing N,
    the walk n tiles fastest only where A's expert is the larger and more
    than a quarter of the L2, one persistent CTA per SM or per tile; every
    launch it gives passes the wrapper's checks, and every compiled tile's
    shared memory fits a block."""
    got = port_gmm.backward_tiles(e, g, k, n)
    assert tuple(got["dx"].values()) == dx
    assert tuple(got["dw"].values()) == dw
    for p, t in got.items():
        port_gmm._check_backward_tiles(e, g, k, n, p, **t)
    assert port_gmm.backward_tiles(e, g, k, n, sms=7)["dx"]["ctas"] == \
        min(7, dx[2])
    for bm, bn in port_gmm.BACKWARD_SM90_TILES:
        smem = port_gmm.backward_smem_bytes(bm, bn)
        assert smem <= port_gmm.SMEM_LIMIT
        # at least two ring slots of (bm + bn) x 64 bf16
        assert smem >= 2 * (bm + bn) * 128 + (bm // 64) * 64 * bn * 2