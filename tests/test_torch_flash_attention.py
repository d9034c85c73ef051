"""The port's flash attention against the JAX package's, on the CPU.

``flash_attention_plain`` and the CPU path of ``ops.flash_attention`` /
``flash_attention_kernel`` are held against the reference's Pallas kernel in
interpret mode and its pure-jnp oracle ``flash_attention_ref``, on the same
seeded numpy inputs, at the tolerance of tests/test_kernels.py's flash tests:
2e-3 abs / 1e-3 rel (both compute in f32 and sum in different orders).  The
Hopper flash spec is held against the kernel's own limits, and KLARAPTOR is
run on it against ``HopperModel``.  The CUDA kernel itself runs only on a
card: tests/test_torch_cuda.py holds it against the plain version there and
skips elsewhere.
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention_pallas

from repro_torch.core import (H100, CandidateTable, HopperModel, Klaraptor,
                              flash_attention_spec, flash_probe_data,
                              registry, selection_ratio)
from repro_torch.core.kernel_spec import (FLASH_HEAD_DIMS,
                                          FLASH_SM90_HEAD_DIMS,
                                          FLASH_SM90_REGS_PER_THREAD,
                                          FLASH_SM90_TILES,
                                          flash_sm90_smem_bytes)
from repro_torch.kernels import flash_attention as port_flash
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (LAUNCHES,
                                                 flash_attention_kernel,
                                                 flash_attention_plain)

ATOL, RTOL = 2e-3, 1e-3

VARIANTS = {
    "causal": dict(causal=True),
    "full": dict(causal=False),
    "window": dict(causal=True, window=64),
    "softcap": dict(causal=True, softcap=30.0),
}


def _qkv(seed, bhq, bhkv, sq, skv, d):
    rng = np.random.RandomState(seed)
    q = (rng.randn(bhq, sq, d) * 0.3).astype(np.float32)
    k = (rng.randn(bhkv, skv, d) * 0.3).astype(np.float32)
    v = (rng.randn(bhkv, skv, d) * 0.3).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(out, expected):
    np.testing.assert_allclose(out.float().numpy(), np.asarray(expected),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("variant", sorted(VARIANTS) + ["gqa4"])
@pytest.mark.parametrize("d", [32, 64])
def test_plain_matches_pallas_and_oracle(variant, d):
    b, hq, hkv, s = 2, 4, 2, 256
    if variant == "gqa4":
        hkv = 1
    kw = VARIANTS.get(variant, dict(causal=True))
    q, k, v = _qkv(d + len(variant), b * hq, b * hkv, s, s, d)
    heads = dict(num_q_heads=hq, num_kv_heads=hkv)
    pallas = flash_attention_pallas(q, k, v, bq=64, bkv=128, interpret=True,
                                    **heads, **kw)
    oracle = ref.flash_attention_ref(q, k, v, **heads, **kw)
    qt, kt, vt = _t(q, k, v)
    outs = [flash_attention_plain(qt, kt, vt, **heads, **kw),
            flash_attention_plain(qt, kt, vt, q_chunk=64, **heads, **kw),
            ops.flash_attention(qt, kt, vt, q_chunk=96, **heads, **kw)]
    if d in FLASH_HEAD_DIMS:     # the kernel's wrapper takes its head dims
        outs.append(flash_attention_kernel(qt, kt, vt, bq=32, bkv=64,
                                           **heads, **kw))
    for out in outs:
        assert out.dtype == torch.float32 and out.shape == qt.shape
        _close(out, pallas)
        _close(out, oracle)


@pytest.mark.parametrize("causal", [True, False])
def test_cross_lengths_match_pallas(causal):
    """sq != skv (the masks count positions from 0 on both axes)."""
    hq, hkv, sq, skv, d = 4, 2, 128, 256, 64
    q, k, v = _qkv(11, 2 * hq, 2 * hkv, sq, skv, d)
    heads = dict(num_q_heads=hq, num_kv_heads=hkv, causal=causal)
    pallas = flash_attention_pallas(q, k, v, bq=64, bkv=128, interpret=True,
                                    **heads)
    _close(flash_attention_plain(*_t(q, k, v), **heads), pallas)
    _close(flash_attention_plain(*_t(q, k, v), **heads),
           ref.flash_attention_ref(q, k, v, **heads))


@pytest.mark.parametrize("sq,skv,kw", [
    (77, 77, dict(causal=True)),
    (77, 77, dict(causal=True, window=16)),
    (50, 130, dict(causal=False)),
    (130, 50, dict(causal=True, softcap=20.0)),
    # rows qpos >= 40 see no key at all: the output there is 0
    (96, 32, dict(causal=False, window=8)),
])
def test_ragged_lengths_match_oracle(sq, skv, kw):
    """Lengths no tile divides: the kernel masks the tails, the plain
    version has none; the Pallas kernel asserts divisibility, so the pure-jnp
    oracle is the reference here."""
    hq, hkv, d = 4, 1, 64
    q, k, v = _qkv(sq + skv, 2 * hq, 2 * hkv, sq, skv, d)
    heads = dict(num_q_heads=hq, num_kv_heads=hkv)
    oracle = np.asarray(ref.flash_attention_ref(q, k, v, **heads, **kw))
    out = flash_attention_kernel(*_t(q, k, v), bq=16, bkv=32, **heads, **kw)
    _close(out, oracle)
    if kw.get("window") == 8:
        assert not np.any(oracle[:, 40:])
        assert not torch.any(out[:, 40:])


def test_bf16_plain_matches_oracle():
    hq, hkv, s, d = 4, 2, 128, 64
    q, k, v = _qkv(5, 2 * hq, 2 * hkv, s, s, d)
    heads = dict(num_q_heads=hq, num_kv_heads=hkv)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    oracle = ref.flash_attention_ref(jq, jk, jv, **heads)
    tq, tk, tv = (t.to(torch.bfloat16) for t in _t(q, k, v))
    out = flash_attention_plain(tq, tk, tv, **heads)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(oracle, np.float32),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_spec_feasibility_is_the_kernels_limits(d, elem, causal):
    """A tile is feasible in the Hopper spec exactly when the kernel's
    argument check takes it, and the spec's stage bytes are the kernel's
    dynamic shared memory.  Each case is on one of the kernel's two bodies:
    bf16 at d 64 and 128 is the wgmma body (2 * bq threads, the compiled
    tiles), the rest the SIMT body (4 * bq threads)."""
    spec = flash_attention_spec(d, causal, elem)
    wgmma = elem == 2 and d in FLASH_SM90_HEAD_DIMS
    dtype = torch.bfloat16 if elem == 2 else torch.float32
    D = {"bh": 4, "sq": 100, "skv": 100}
    grid = CandidateTable.product(
        ("bq", "bkv"), [(8, 16, 32, 48, 64, 128, 256), (16, 32, 64, 128)])
    mask = spec.feasible_mask(D, grid, H100)
    stage = spec._eval(spec.stage_expr(), D, grid)
    q = torch.zeros(4, 100, d, dtype=dtype)
    k = torch.zeros(4, 100, d, dtype=dtype)
    for i in range(len(grid)):
        P = grid.row(i)
        try:
            port_flash._check(q, k, k, 4, 4, P["bq"], P["bkv"], None, None)
            takes = True
        except ValueError:
            takes = False
        assert takes == bool(mask[i]), (P, takes)
        if takes:
            assert stage[i] == port_flash.smem_bytes(d, P["bq"], P["bkv"],
                                                     elem)
    table = spec.candidates(D, H100)
    assert len(table) > 0
    tt = spec.traffic_table(D, table, H100)
    per_row = 2 if wgmma else 4
    assert np.all(tt.threads == per_row * table["bq"])
    assert spec.compute_unit == ("bf16" if wgmma else "f32")
    if wgmma:
        assert sorted(zip(table["bq"], table["bkv"])) == \
            sorted(FLASH_SM90_TILES[d])
    assert np.all(tt.blocks_per_sm >= 1)
    # Scratch tiles live in shared memory only: no device-memory traffic.
    assert [op.name for op in tt.operands] == ["q", "k", "v", "out"]


@pytest.mark.parametrize("d", sorted(FLASH_SM90_HEAD_DIMS))
def test_bf16_spec_is_the_compiled_table(d):
    """bf16 at d 64 and 128: the candidates are exactly the compiled wgmma
    tiles, FLASH_DEFAULT is one of them, every tile's shared memory fits,
    and the spec states the wgmma body (2 * bq threads, the register cap
    255, the tensor-core peak, a K/V ring as scratch, no P tile)."""
    for causal in (True, False):
        spec = flash_attention_spec(d, causal, 2)
        table = spec.candidates({"bh": 32, "sq": 4096, "skv": 4096}, H100)
        tiles = sorted(zip(table["bq"].tolist(), table["bkv"].tolist()))
        assert tiles == sorted(FLASH_SM90_TILES[d])
        assert {(64, 64), (64, 128), (128, 64), (128, 128)} <= set(tiles)
        assert (ops.FLASH_DEFAULT["bq"], ops.FLASH_DEFAULT["bkv"]) in tiles
        assert all(flash_sm90_smem_bytes(d, bq, bkv) <= 227 * 1024
                   for bq, bkv in tiles)
        assert spec.regs_per_thread == FLASH_SM90_REGS_PER_THREAD == 255
        assert spec.compute_unit == "bf16"
        assert spec.constraints == ("bq % 64 == 0", "bkv % 64 == 0")
        names = [op.name for op in spec.operands]
        assert "p" not in names and "p_pad" not in names
        assert {"k_ring", "v_ring", "ring_barriers"} <= set(names)


def test_f32_and_d256_specs_are_unchanged():
    """f32 at every head dim and bf16 at d 256 keep the SIMT body's spec:
    4 * bq threads, the padded f32 P tile, the SIMT candidates and
    constraints, FMAs on the CUDA cores."""
    for d, elem in [(64, 4), (128, 4), (256, 4), (256, 2)]:
        spec = flash_attention_spec(d, True, elem)
        assert spec.param_candidates == {"bq": (16, 32, 64, 128),
                                         "bkv": (32, 64, 128)}
        assert spec.constraints == ("bq % 16 == 0", "bkv % 32 == 0")
        assert spec.regs_per_thread == (255 if d == 256 else 128)
        assert spec.compute_unit == "f32"
        assert spec.threads.to_source() == \
            flash_attention_spec(d, False, elem).threads.to_source()
        tt = spec.traffic_table({"bh": 4, "sq": 256, "skv": 256},
                                CandidateTable.from_rows(
                                    ("bq", "bkv"), [{"bq": 32, "bkv": 64}]))
        assert int(tt.threads[0]) == 128
        assert [(op.name, op.tile, op.dtype_bytes) for op in spec.operands
                if op.scratch] == [("p", ("bq", "bkv"), 4),
                                   ("p_pad", ("bq", 16), 4)]
        assert spec._eval(spec.stage_expr(), {"bh": 1, "sq": 1, "skv": 1},
                          CandidateTable.from_rows(
                              ("bq", "bkv"), [{"bq": 32, "bkv": 64}]))[0] \
            == (32 + 128) * d * elem + 32 * (64 + 16) * 4


def test_wrapper_rejects_an_uncompiled_tile():
    """bf16 at d 64 and 128 takes only the compiled wgmma tiles, on the CPU
    too (where the wrapper then computes the plain version), and launches
    nothing; f32 at the same shape still takes a SIMT tile."""
    LAUNCHES.reset()
    heads = dict(num_q_heads=4, num_kv_heads=1)
    for d in sorted(FLASH_SM90_HEAD_DIMS):
        q, k, v = _qkv(d, 8, 2, 70, 70, d)
        tq, tk, tv = (t.to(torch.bfloat16) for t in _t(q, k, v))
        for bq, bkv in ((32, 64), (64, 32), (16, 128), (256, 64),
                        (128, 256)):
            with pytest.raises(ValueError, match="compiled tile"):
                flash_attention_kernel(tq, tk, tv, bq=bq, bkv=bkv, **heads)
        for bq, bkv in FLASH_SM90_TILES[d]:
            out = flash_attention_kernel(tq, tk, tv, bq=bq, bkv=bkv, **heads)
            assert out.dtype == torch.bfloat16 and out.shape == tq.shape
        flash_attention_kernel(*_t(q, k, v), bq=32, bkv=64, **heads)
    assert LAUNCHES.count == 0


def _attention_p_bf16(q, k, v, hq, hkv, causal, bkv=64, split=False):
    """The wgmma kernel's online softmax in torch, f32 but for P: kv blocks
    of bkv keys, a running max and sum in f32, and each block's
    unnormalised probabilities rounded to bf16 before the PV product; with
    ``split`` as the kernel feeds them, hi = bf16(p) plus lo = bf16(p -
    hi)."""
    bhq, sq, d = q.shape
    group = hq // hkv
    kvh = [(i // hq) * hkv + (i % hq) // group for i in range(bhq)]
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    kk, vv = k[kvh], v[kvh]                                 # (bhq, skv, d)
    skv = k.shape[1]
    m = torch.full((bhq, sq, 1), -1e30)
    l = torch.zeros((bhq, sq, 1))
    acc = torch.zeros((bhq, sq, d))
    qpos = torch.arange(sq)[:, None]
    for k0 in range(0, skv, bkv):
        s = q @ kk[:, k0:k0 + bkv].transpose(1, 2) * d ** -0.5
        kpos = k0 + torch.arange(s.shape[2])[None, :]
        vis = (qpos >= kpos) if causal else torch.ones_like(s[0], dtype=bool)
        s = s.masked_fill(~vis, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        p16 = p.to(torch.bfloat16).float()
        if split:
            p16 = p16 + (p - p16).to(torch.bfloat16).float()
        acc = alpha * acc + p16 @ vv[:, k0:k0 + bkv]
        m = m_new
    return (acc / torch.where(l > 0, l, torch.ones_like(l))).numpy()


@pytest.mark.parametrize("causal", [True, False])
def test_p_in_bf16_matches_the_oracle_and_diverges_from_pallas(causal):
    """wgmma takes P as bf16.  The JAX oracle ``flash_attention_ref`` casts P
    to v's dtype (``ref.py:65``), while the Pallas kernel keeps P in f32;
    the kernel feeds P as two bf16 terms (hi + lo), which keeps the Pallas
    kernel's precision: its recomputation agrees with the Pallas kernel to
    f32 rounding.  On bf16 inputs (held as f32) the
    torch recomputation with P rounded to bf16 once agrees with the oracle within
    the oracle's own bf16 output rounding (2.2e-3 causal, 3.0e-4 full at
    this seed), and differs from the Pallas kernel by the P rounding alone
    (7.4e-4 causal, 1.3e-4 full; outputs up to 0.82), under the 2e-2 bf16
    tolerance the card holds the kernel to."""
    hq, hkv, s, d = 4, 2, 192, 64
    q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
               for a in _qkv(17, 2 * hq, 2 * hkv, s, s, d))
    heads = dict(num_q_heads=hq, num_kv_heads=hkv, causal=causal)
    mine = _attention_p_bf16(q, k, v, hq, hkv, causal)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    oracle = np.asarray(ref.flash_attention_ref(jq, jk, jv, **heads),
                        np.float32)
    pallas = np.asarray(flash_attention_pallas(
        q, k, v, bq=64, bkv=64, interpret=True, **heads), np.float32)
    f32_oracle = np.asarray(ref.flash_attention_ref(q, k, v, **heads))
    to_oracle = float(np.abs(mine - oracle).max())
    to_pallas = float(np.abs(mine - pallas).max())
    assert to_oracle < 2e-2 and to_pallas < 2e-2, (to_oracle, to_pallas)
    # the divergence is P's rounding: the f32 oracle is the Pallas kernel
    assert float(np.abs(pallas - f32_oracle).max()) < 1e-5
    assert 1e-5 < to_pallas < 5e-3, to_pallas
    np.testing.assert_allclose(mine, oracle, atol=2e-2, rtol=2e-2)
    split = _attention_p_bf16(q, k, v, hq, hkv, causal, split=True)
    assert float(np.abs(split - pallas).max()) < 2e-5


def test_spec_matches_reference_interface():
    from repro.core.kernel_spec import flash_attention_spec as ref_spec
    for d, causal in itertools.product((64, 128), (True, False)):
        mine, theirs = flash_attention_spec(d, causal), ref_spec(d, causal)
        assert mine.name == theirs.name
        assert mine.data_params == theirs.data_params
        assert mine.program_params == theirs.program_params
        assert mine.flops_per_point == theirs.flops_per_point
    seq = [a for a in flash_attention_spec(64).grid if a.sequential]
    assert [a.data for a in seq] == ["skv"]


@pytest.fixture(scope="module")
def flash_build():
    registry.clear()
    oracle = HopperModel(noise=0.04, seed=3)
    spec = flash_attention_spec(64, causal=True, dtype_bytes=2)
    build = Klaraptor(oracle, device="cpu", cache=False).build_driver(
        spec, probe_data=flash_probe_data(), repeats=2,
        max_configs_per_size=12)
    yield spec, oracle, build
    registry.clear()


def test_flash_probes_only_small_sizes(flash_build):
    _, _, build = flash_build
    cols = build.collected.columns
    assert int(cols["bh"].max()) <= 64
    assert int(cols["sq"].max()) <= 1024
    assert np.array_equal(cols["sq"], cols["skv"])


@pytest.mark.parametrize("D", [
    {"bh": 32, "sq": 4096, "skv": 4096}, {"bh": 32, "sq": 2048, "skv": 2048},
    {"bh": 128, "sq": 2048, "skv": 2048}, {"bh": 256, "sq": 8192, "skv": 8192},
])
def test_flash_selection_ratio_on_unseen_sizes(flash_build, D):
    spec, oracle, build = flash_build
    r = selection_ratio(spec, oracle, build.driver, D, H100)
    assert r["ratio"] >= 0.85, r


def test_flash_driver_feeds_the_op(flash_build):
    """With the driver registered, ops.flash_attention on CPU tensors still
    computes the plain version (a CPU tensor never launches), and the
    driver's choice at a ragged size is a tile of the spec."""
    spec, _, build = flash_build
    cfg = build.driver.choose({"bh": 8, "sq": 77, "skv": 77})
    assert cfg["bq"] in spec.default_candidates("bq")
    assert cfg["bkv"] in spec.default_candidates("bkv")
    q, k, v = _qkv(2, 8, 2, 77, 77, 64)
    heads = dict(num_q_heads=4, num_kv_heads=1)
    before = LAUNCHES.count
    _close(ops.flash_attention(*_t(q, k, v), **heads),
           ref.flash_attention_ref(q, k, v, **heads))
    assert LAUNCHES.count == before


def test_probe_launcher_binds_flash_kernels():
    launch = ops.probe_launcher("flash_attn_d64_causal",
                                {"bh": 2, "sq": 40, "skv": 40},
                                torch.device("cpu"), seed=0)
    launch({"bq": 64, "bkv": 64})          # the plain version on the CPU
    with pytest.raises(ValueError):
        ops.probe_launcher("flash_attn_dx", {"bh": 1}, torch.device("cpu"), 0)


def test_wrapper_raises_and_never_falls_back():
    LAUNCHES.reset()
    q, k, v = (torch.zeros(8, 64, 64), torch.zeros(2, 64, 64),
               torch.zeros(2, 64, 64))
    heads = dict(num_q_heads=4, num_kv_heads=1)
    for kw, match in ((dict(bq=24, bkv=64), "bq"),
                      (dict(bq=32, bkv=48), "bkv"),
                      (dict(bq=256, bkv=64), "registers"),
                      (dict(bq=32, bkv=64, softcap=0.0), "softcap"),
                      (dict(bq=32, bkv=64, window=1.5), "window")):
        with pytest.raises(ValueError, match=match):
            flash_attention_kernel(q, k, v, **heads, **kw)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_kernel(torch.zeros(8, 64, 96), torch.zeros(2, 64, 96),
                               torch.zeros(2, 64, 96), bq=32, bkv=64, **heads)
    with pytest.raises(ValueError, match="heads"):
        flash_attention_kernel(q, k, v, bq=32, bkv=64, num_q_heads=3,
                               num_kv_heads=1)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention_kernel(q.double(), k.double(), v.double(), bq=32,
                               bkv=64, **heads)
    with pytest.raises(ValueError, match="shared memory"):
        flash_attention_kernel(torch.zeros(8, 64, 256),
                               torch.zeros(2, 64, 256),
                               torch.zeros(2, 64, 256), bq=64, bkv=128,
                               **heads)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_kernel(q.transpose(1, 2).contiguous().transpose(1, 2),
                               k, v, bq=32, bkv=64, **heads)
    with pytest.raises(ValueError):
        ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"),
                            **heads)
    assert LAUNCHES.count == 0
