"""The port's SSD chunked scan against the JAX package's, on the CPU.

``ssd_scan_plain`` and the CPU paths of ``ops.ssd_scan`` /
``ssd_scan_kernel`` are held against the reference's per-step recurrence
``ssd_scan_ref``, its Pallas kernel in interpret mode and its chunk-parallel
``ssd_parallel``, on the same seeded numpy inputs at the ranges of
tests/test_kernels.py's SSD tests (dt in [0.01, 0.51], A in [-1.5, -0.5]),
at that file's tolerance in f32 (5e-3 abs / 1e-3 rel: the chunked and the
per-step forms sum in different orders) and at 2e-2 in bf16.  One case takes
dt in [1e-3, 1e-2], where the state carried across chunks dominates the
output.  The Hopper SSD spec is held against the kernel's own limits, and
KLARAPTOR is run on it against ``HopperModel``.  The CUDA kernel itself runs
only on a card: tests/test_torch_cuda.py holds it against the plain version
there and skips elsewhere.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref
from repro.kernels.ssd_scan import ssd_scan_pallas
from repro.models.layers import ssd_parallel

from repro_torch.core import (H100, CandidateTable, HopperModel, Klaraptor,
                              registry, selection_ratio)
from repro_torch.core.kernel_spec import (SSD_COLS, SSD_SM90_CHUNKS,
                                          ssd_probe_data, ssd_scan_spec,
                                          ssd_smem_bytes)
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as port_ssd
from repro_torch.kernels.ssd_scan import (LAUNCHES, ssd_scan_kernel,
                                          ssd_scan_plain)

ATOL, RTOL = 5e-3, 1e-3


def _inputs(seed, bh, s, dh, n, dt_range=(0.01, 0.51)):
    rng = np.random.RandomState(seed)
    lo, hi = dt_range
    x = (rng.randn(bh, s, dh) * 0.5).astype(np.float32)
    dt = (lo + (hi - lo) * rng.rand(bh, s)).astype(np.float32)
    B = (rng.randn(bh, s, n) * 0.3).astype(np.float32)
    C = (rng.randn(bh, s, n) * 0.3).astype(np.float32)
    A = (-0.5 - rng.rand(bh)).astype(np.float32)
    return x, dt, B, C, A


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(out, expected, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(expected, np.float32),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("dh,n", [(64, 32), (32, 16)])
@pytest.mark.parametrize("s,chunk", [(256, 128), (512, 128), (512, 256)])
def test_plain_matches_recurrence_pallas_and_parallel(dh, n, s, chunk):
    arrays = _inputs(s + chunk + dh, 3, s, dh, n)
    expected = ref.ssd_scan_ref(*arrays)
    pallas = ssd_scan_pallas(*arrays, chunk=chunk, interpret=True)
    parallel = ssd_parallel(*arrays, chunk=chunk)
    t = _t(*arrays)
    outs = [ssd_scan_plain(*t, chunk=chunk),
            ssd_scan_kernel(*t, chunk=chunk), ops.ssd_scan(*t)]
    for out in outs:
        assert out.dtype == torch.float32 and out.shape == t[0].shape
        for theirs in (expected, pallas, parallel):
            _close(out, theirs)


@pytest.mark.parametrize("s,chunk", [(77, 32), (333, 64), (100, 256),
                                     (300, 128)])
def test_ragged_lengths_match_recurrence(s, chunk):
    """Lengths the chunk does not divide: the kernel and the plain version
    take a shorter last chunk; the Pallas kernel asserts divisibility, so
    the per-step recurrence is the reference here."""
    arrays = _inputs(s, 2, s, 64, 32)
    expected = ref.ssd_scan_ref(*arrays)
    _close(ssd_scan_kernel(*_t(*arrays), chunk=chunk), expected)


def test_long_carry_matches_recurrence():
    """Small steps: little decay per chunk, so the state carried from
    earlier chunks dominates the output; a broken carry shows here."""
    arrays = _inputs(9, 2, 512, 64, 32, dt_range=(1e-3, 1e-2))
    expected = np.asarray(ref.ssd_scan_ref(*arrays))
    t = _t(*arrays)
    out = ssd_scan_plain(*t, chunk=64)
    _close(out, expected)
    # dropping the carry (one chunk per call) is far off the tolerance
    cut = torch.cat([ssd_scan_plain(*[a[:, c0:c0 + 64] if a.ndim > 1 else a
                                      for a in t], chunk=64)
                     for c0 in range(0, 512, 64)], dim=1)
    assert float(np.abs(cut.numpy() - expected).max()) > 10 * ATOL


def test_bf16_plain_matches_recurrence():
    arrays = _inputs(5, 2, 256, 64, 32)
    jx, jdt, jB, jC, jA = (jnp.asarray(a) for a in arrays)
    expected = ref.ssd_scan_ref(jx.astype(jnp.bfloat16), jdt,
                                jB.astype(jnp.bfloat16),
                                jC.astype(jnp.bfloat16), jA)
    x, dt, B, C, A = _t(*arrays)
    bf = torch.bfloat16
    out = ssd_scan_plain(x.to(bf), dt, B.to(bf), C.to(bf), A, chunk=64)
    assert out.dtype == bf
    _close(out, np.asarray(expected, np.float32), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("dh,n", [(64, 128), (32, 32)])
@pytest.mark.parametrize("elem", [2, 4])
def test_spec_feasibility_is_the_kernels_limits(dh, n, elem):
    """A chunk is feasible in the Hopper spec exactly when the kernel's
    argument check takes it (bf16 at (64, 128): the compiled wgmma chunks),
    the spec's stage bytes are the kernel's dynamic shared memory, and its
    CTAs are the launch's: one per chunk of each row (of each 16 head-dim
    columns in the SIMT body)."""
    spec = ssd_scan_spec(dh, n, elem)
    dtype = torch.bfloat16 if elem == 2 else torch.float32
    D = {"bh": 4, "s": 100, "chunkflops": 1}
    grid = CandidateTable.product(
        ("chunk",), [(16, 32, 48, 64, 96, 128, 256, 512, 1024, 2048)])
    mask = spec.feasible_mask(D, grid, H100)
    stage = spec._eval(spec.stage_expr(), D, grid)
    x = torch.zeros(4, 100, dh, dtype=dtype)
    B = torch.zeros(4, 100, n, dtype=dtype)
    dt, A = torch.zeros(4, 100), torch.zeros(4)
    for i in range(len(grid)):
        chunk = grid.row(i)["chunk"]
        try:
            port_ssd._check(x, dt, B, B, A, chunk)
            takes = True
        except ValueError:
            takes = False
        assert takes == bool(mask[i]), (chunk, takes)
        if takes:
            assert stage[i] == ssd_smem_bytes(chunk, n, elem, dh)
    table = spec.candidates(D, H100)
    assert len(table) > 0
    if elem == 2 and (dh, n) == (64, 128):
        assert table["chunk"].tolist() == list(SSD_SM90_CHUNKS)
    tt = spec.traffic_table(D, table, H100)
    per_row = 1 if (elem, dh, n) == (2, 64, 128) else dh // SSD_COLS
    np.testing.assert_array_equal(
        tt.ctas, [4 * per_row * -(-100 // c) for c in table["chunk"]])
    np.testing.assert_array_equal(
        tt.ctas, [port_ssd.ssd_ctas(4, 100, dh, n, int(c), dtype)
                  for c in table["chunk"]])
    assert np.all(tt.blocks_per_sm >= 1)
    # scratch tiles live in shared memory only: no device-memory traffic
    assert [op.name for op in tt.operands] == \
        ["x", "dt", "b_proj", "c_proj", "decay", "state_in", "state_out",
         "out"]
    # the FLOPs grow with the chunk (the quadratic intra-chunk term)
    assert np.all(np.diff(tt.flops_total) > 0)


def test_spec_matches_reference_interface():
    """Name, data and program parameters are the reference's, so the
    drivers' keys and the models' kernel requests are the same."""
    from repro.core.kernel_spec import ssd_scan_spec as ref_spec
    for dh, n in ((64, 128), (32, 32)):
        mine, theirs = ssd_scan_spec(dh, n), ref_spec(dh, n)
        assert mine.name == theirs.name == ops.ssd_kernel_name(dh, n)
        assert mine.data_params == theirs.data_params
        assert mine.program_params == theirs.program_params
    for spec in (ssd_scan_spec(), ssd_scan_spec(64, 128, 4)):
        # the chunks run in parallel: no loop, a ragged chunk axis
        assert not any(a.sequential for a in spec.grid)
        (chunks,) = [a for a in spec.grid if a.data == "s"]
        assert chunks.block == "chunk" and chunks.ragged
    with pytest.raises(ValueError, match="head dim"):
        ssd_scan_spec(40, 128)


@pytest.fixture(scope="module")
def ssd_build():
    registry.clear()
    oracle = HopperModel(noise=0.04, seed=5)
    spec = ssd_scan_spec(64, 128, dtype_bytes=2)
    build = Klaraptor(oracle, device="cpu", cache=False).build_driver(
        spec, probe_data=ssd_probe_data(), repeats=2)
    yield spec, oracle, build
    registry.clear()


def test_ssd_probes_only_small_sizes(ssd_build):
    _, _, build = ssd_build
    cols = build.collected.columns
    assert int(cols["bh"].max()) <= 64
    assert int(cols["s"].max()) <= 2048


@pytest.mark.parametrize("D", [
    {"bh": 24, "s": 4096}, {"bh": 96, "s": 8192}, {"bh": 48, "s": 3000},
    {"bh": 192, "s": 16384},
])
def test_ssd_selection_ratio_on_unseen_sizes(ssd_build, D):
    spec, oracle, build = ssd_build
    r = selection_ratio(spec, oracle, build.driver, {**D, "chunkflops": 1},
                        H100)
    assert r["ratio"] >= 0.85, r


def test_ssd_driver_feeds_the_op(ssd_build):
    """With the driver registered, ops.ssd_scan on CPU tensors computes the
    plain version at the chosen chunk (a CPU tensor never launches)."""
    spec, _, build = ssd_build
    D = {"bh": 2, "s": 333, "chunkflops": 1}
    chunk = build.driver.choose(D)["chunk"]
    assert chunk in spec.candidates(D, H100)["chunk"]
    arrays = _inputs(4, 2, 333, 64, 128)
    t = _t(*arrays)
    bf = torch.bfloat16
    x, B, C = t[0].to(bf), t[2].to(bf), t[3].to(bf)
    before = LAUNCHES.count
    out = ops.ssd_scan(x, t[1], B, C, t[4])
    assert LAUNCHES.count == before
    assert torch.equal(out, ssd_scan_plain(x, t[1], B, C, t[4], chunk=chunk))


def test_default_chunk_falls_to_one_that_fits():
    """The reference's default chunk (256) does not fit an f32 state of 128
    in shared memory, and is not one of the bf16 wgmma body's compiled
    chunks (64, 128); the op takes the largest smaller chunk the kernel
    takes.  The SIMT body takes 256 at (32, 32)."""
    assert ops._ssd_chunk(64, 128, 2, 256) == 128
    assert ops._ssd_chunk(64, 128, 4, 256) == 128
    assert ops._ssd_chunk(64, 128, 2, 2048) == 128
    assert ops._ssd_chunk(64, 128, 2, 64) == 64
    assert ops._ssd_chunk(32, 32, 2, 256) == 256
    registry.clear()
    arrays = _inputs(3, 2, 300, 64, 128)
    t = _t(*arrays)
    assert torch.equal(ops.ssd_scan(*t), ssd_scan_plain(*t, chunk=128))


def test_probe_launcher_binds_ssd_kernels():
    launch = ops.probe_launcher("ssd_scan_h64_n128",
                                {"bh": 2, "s": 40, "chunkflops": 1},
                                torch.device("cpu"), seed=0)
    launch({"chunk": 64})          # the plain version on the CPU
    with pytest.raises(ValueError, match="not compiled"):
        launch({"chunk": 32})      # the bf16 wgmma body has no chunk 32
    with pytest.raises(ValueError):
        ops.probe_launcher("ssd_scan_hx", {"bh": 1}, torch.device("cpu"), 0)


def test_wrapper_raises_and_never_falls_back():
    LAUNCHES.reset()
    x, B = torch.zeros(4, 64, 64), torch.zeros(4, 64, 32)
    dt, A = torch.zeros(4, 64), torch.zeros(4)
    for chunk, match in ((48, "chunk"), (0, "chunk"), (64.0, "chunk")):
        with pytest.raises(ValueError, match=match):
            ssd_scan_kernel(x, dt, B, B, A, chunk=chunk)
    with pytest.raises(ValueError, match="shared memory"):
        ssd_scan_kernel(x, dt, torch.zeros(4, 64, 128),
                        torch.zeros(4, 64, 128), A, chunk=512)
    with pytest.raises(ValueError, match="head dim"):
        ssd_scan_kernel(torch.zeros(4, 64, 40), dt, B, B, A, chunk=64)
    with pytest.raises(ValueError, match="dtype"):
        ssd_scan_kernel(x.double(), dt, B.double(), B.double(), A, chunk=64)
    with pytest.raises(ValueError, match="dtype"):
        ssd_scan_kernel(x, dt.to(torch.bfloat16), B, B, A, chunk=64)
    with pytest.raises(ValueError, match="takes x"):
        ssd_scan_kernel(x, dt[:, :10], B, B, A, chunk=64)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan_kernel(x.transpose(1, 2).contiguous().transpose(1, 2), dt,
                        B, B, A, chunk=64)
    with pytest.raises(ValueError):
        ops.ssd_scan(x.to("meta"), dt.to("meta"), B.to("meta"),
                     B.to("meta"), A.to("meta"))
    assert LAUNCHES.count == 0


def _shared(seed, groups, h, s, dh, n, dt_range=(0.01, 0.51)):
    """Inputs with B and C (groups, s, n) shared by h rows each, and the
    same B and C copied per row (groups * h, s, n)."""
    x, dt, _, _, A = _inputs(seed, groups * h, s, dh, n, dt_range)
    rng = np.random.RandomState(seed + 1)
    B = (rng.randn(groups, s, n) * 0.3).astype(np.float32)
    C = (rng.randn(groups, s, n) * 0.3).astype(np.float32)
    return (x, dt, B, C, A), (x, dt, np.repeat(B, h, 0), np.repeat(C, h, 0),
                              A)


@pytest.mark.parametrize("groups,h,s,chunk", [(1, 6, 256, 64),
                                              (2, 3, 333, 128),
                                              (3, 1, 128, 32)])
def test_shared_b_c_equal_per_head_copies(groups, h, s, chunk):
    """B and C (bh / h, s, n), shared by h consecutive rows of x: the plain
    version gives the same bits as on per-head copies (the reference's
    interface), and matches the Pallas kernel on the copies."""
    shared, copies = _shared(groups + h + s, groups, h, s, 32, 16)
    got = ssd_scan_plain(*_t(*shared), chunk=chunk)
    assert torch.equal(got, ssd_scan_plain(*_t(*copies), chunk=chunk))
    assert torch.equal(got, ssd_scan_kernel(*_t(*shared), chunk=chunk))
    if s % chunk == 0:
        pallas = ssd_scan_pallas(*copies, chunk=chunk, interpret=True)
        _close(got, pallas, atol=2e-4, rtol=2e-4)
    else:
        _close(got, ref.ssd_scan_ref(*copies))


def test_shared_b_c_shapes_are_checked():
    x, dt, A = torch.zeros(6, 64, 32), torch.zeros(6, 64), torch.zeros(6)
    for groups in (2, 3, 6):
        B = torch.zeros(groups, 64, 16)
        assert ssd_scan_kernel(x, dt, B, B, A, chunk=32).shape == x.shape
    for bad in (torch.zeros(4, 64, 16), torch.zeros(2, 63, 16)):
        with pytest.raises(ValueError, match="shared by h"):
            ssd_scan_kernel(x, dt, bad, bad, A, chunk=32)


def _bf(t):
    return t.to(torch.bfloat16).float()


def _ssd_wgmma_emulated(x, dt, B, C, A, chunk, split):
    """The wgmma body's arithmetic on the CPU, in f32: the three f32
    operands of its products -- w o B, the gated scores, h_in -- go in as
    bf16 hi + lo terms (``split``) or rounded to bf16 once; x, B and C are
    bf16 already.  x (bh, s, dh), B and C (bh, s, n)."""
    def bf16_operand(t):
        hi = _bf(t)
        return hi + _bf(t - hi) if split else hi

    bh, s, dh = x.shape
    n = B.shape[-1]
    a = A[:, None]
    h = torch.zeros(bh, n, dh)
    out = torch.empty(bh, s, dh)
    for c0 in range(0, s, chunk):
        c1 = min(c0 + chunk, s)
        xc, dc, Bc, Cc = x[:, c0:c1], dt[:, c0:c1], B[:, c0:c1], C[:, c0:c1]
        cum = torch.cumsum(a * dc, 1)
        total = cum[:, -1:]
        idx = torch.arange(c1 - c0)
        causal = idx[:, None] >= idx[None, :]
        gate = torch.exp((cum[:, :, None] - cum[:, None, :]).masked_fill(
            ~causal, -1e30)) * dc[:, None, :]
        scores = bf16_operand(torch.einsum("bin,bjn->bij", Cc, Bc) * gate)
        out[:, c0:c1] = scores @ xc + torch.exp(cum)[..., None] * (
            Cc @ bf16_operand(h))
        w = torch.exp(total - cum) * dc
        h = torch.exp(total)[..., None] * h + torch.einsum(
            "bjn,bjd->bnd", bf16_operand(Bc * w[..., None]), xc)
    return out


def test_hi_lo_operands_keep_the_pallas_precision():
    """wgmma takes bf16 operands.  Fed as two bf16 terms (hi + lo), the
    kernel's f32 operands -- w o B, the gated scores and h_in -- keep the
    Pallas kernel's precision: the emulation agrees with the Pallas kernel
    (f32 inside) to f32 rounding on bf16 inputs (3.3e-6 of max |y| at this
    seed).  Rounded once, they move the output by bf16 roundings (2.2e-3 of
    max |y|), still within the card's 2e-2 bf16 tolerance, but far from the
    Pallas kernel."""
    arrays = [np.asarray(torch.from_numpy(a).to(torch.bfloat16).float())
              if a.ndim == 3 else a
              for a in _inputs(21, 3, 256, 64, 32, dt_range=(1e-3, 1e-2))]
    pallas = np.asarray(ssd_scan_pallas(*arrays, chunk=64, interpret=True))
    t = _t(*arrays)
    split = _ssd_wgmma_emulated(*t, chunk=64, split=True).numpy()
    once = _ssd_wgmma_emulated(*t, chunk=64, split=False).numpy()
    scale = float(np.abs(pallas).max())
    to_split = float(np.abs(split - pallas).max()) / scale
    to_once = float(np.abs(once - pallas).max()) / scale
    assert to_split < 1e-5, to_split
    assert 1e-4 < to_once < 2e-2, to_once
    _close(torch.from_numpy(split), ref.ssd_scan_ref(*arrays))
