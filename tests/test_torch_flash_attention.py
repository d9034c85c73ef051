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

The backward: ``flash_attention_backward_plain`` (the backward kernel's
plain version, P recomputed from the forward's lse), with and without a
window and a softcap, against ``torch.autograd.grad`` of
``flash_attention_plain`` and ``jax.vjp`` of the reference's
``flash_attention_ref`` (what the JAX package trains through): 2e-4 x max
|grad| in f32, 2e-2 in bf16; and the forward's ``return_lse`` against
``torch.logsumexp`` of the masked scaled scores.
"""

import itertools

import numpy as np
import pytest
import torch

import jax
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
from repro_torch.kernels.flash_attention import (
    BACKWARD_LAUNCHES, LAUNCHES, flash_attention_backward_kernel,
    flash_attention_backward_plain, flash_attention_kernel,
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


def _span_the_cap(q, softcap):
    """q scaled so that the scores scale * q.k (std 0.09 from ``_qkv``)
    have std softcap / 2: the cap then bends them (its derivative ranges
    over (0, 1]) where at std 0.09 it would pass them nearly unchanged."""
    return q if softcap is None else q * np.float32(softcap / 2 / 0.09)


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
    bf16 is the wgmma body (2 * bq threads, the compiled tiles), f32 the
    SIMT body (4 * bq threads)."""
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


# The wgmma tiles flash_attention.cu compiles (its FLASH_SM90_TILES macro):
# bq and bkv in {64, 128} at d 64 and 128; at d 256 a two-slot ring of bkv
# 128 is over the shared memory a block may have, so bkv 64 only.
COMPILED_SM90_TILES = {
    64: {(64, 64), (64, 128), (128, 64), (128, 128)},
    128: {(64, 64), (64, 128), (128, 64), (128, 128)},
    256: {(64, 64), (128, 64)},
}


@pytest.mark.parametrize("d", sorted(FLASH_SM90_HEAD_DIMS))
def test_bf16_spec_is_the_compiled_table(d):
    """bf16 at d 64, 128 and 256: the candidates are exactly the compiled
    wgmma tiles, FLASH_DEFAULT is one of them, every tile's shared memory
    fits, and the spec states the wgmma body (2 * bq threads, the register
    cap 255, the tensor-core peak, a K/V ring as scratch, no P tile)."""
    assert FLASH_SM90_HEAD_DIMS == (64, 128, 256)
    assert flash_attention_spec(d, True, 2).name == \
        f"flash_attn_d{d}_causal"
    for causal in (True, False):
        spec = flash_attention_spec(d, causal, 2)
        table = spec.candidates({"bh": 32, "sq": 4096, "skv": 4096}, H100)
        tiles = sorted(zip(table["bq"].tolist(), table["bkv"].tolist()))
        assert tiles == sorted(FLASH_SM90_TILES[d])
        assert set(tiles) == COMPILED_SM90_TILES[d]
        assert (ops.FLASH_DEFAULT["bq"], ops.FLASH_DEFAULT["bkv"]) in tiles
        assert all(flash_sm90_smem_bytes(d, bq, bkv) <= 227 * 1024
                   for bq, bkv in tiles)
        assert spec.regs_per_thread == FLASH_SM90_REGS_PER_THREAD == 255
        assert spec.compute_unit == "bf16"
        assert spec.constraints == ("bq % 64 == 0", "bkv % 64 == 0")
        names = [op.name for op in spec.operands]
        assert "p" not in names and "p_pad" not in names
        assert {"k_ring", "v_ring", "ring_barriers"} <= set(names)


def test_f32_specs_are_unchanged():
    """f32 at every head dim keeps the SIMT body's spec: 4 * bq threads,
    the padded f32 P tile, the SIMT candidates and constraints, FMAs on the
    CUDA cores (bf16 at d 256 is on the wgmma spec,
    test_bf16_spec_is_the_compiled_table)."""
    for d, elem in [(64, 4), (128, 4), (256, 4)]:
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
    """bf16 at d 64, 128 and 256 takes only the compiled wgmma tiles, on
    the CPU too (where the wrapper then computes the plain version), and
    launches nothing; f32 at the same shape still takes a SIMT tile."""
    LAUNCHES.reset()
    heads = dict(num_q_heads=4, num_kv_heads=1)
    for d in sorted(FLASH_SM90_HEAD_DIMS):
        q, k, v = _qkv(d, 8, 2, 70, 70, d)
        tq, tk, tv = (t.to(torch.bfloat16) for t in _t(q, k, v))
        rejected = [(32, 64), (64, 32), (16, 128), (256, 64), (128, 256)]
        if d == 256:            # bkv 128's ring does not fit at d 256
            rejected += [(64, 128), (128, 128)]
        for bq, bkv in rejected:
            with pytest.raises(ValueError, match="compiled tile"):
                flash_attention_kernel(tq, tk, tv, bq=bq, bkv=bkv, **heads)
        for bq, bkv in FLASH_SM90_TILES[d]:
            out = flash_attention_kernel(tq, tk, tv, bq=bq, bkv=bkv, **heads)
            assert out.dtype == torch.bfloat16 and out.shape == tq.shape
        flash_attention_kernel(*_t(q, k, v), bq=32, bkv=64, **heads)
    assert LAUNCHES.count == 0


def _attention_p_bf16(q, k, v, hq, hkv, causal, bkv=64, split=False,
                      softcap=None, window=None):
    """The wgmma kernel's online softmax in torch, f32 but for P: kv blocks
    of bkv keys, a running max and sum in f32, and each block's
    unnormalised probabilities rounded to bf16 before the PV product; with
    ``split`` as the kernel feeds them, hi = bf16(p) plus lo = bf16(p -
    hi).  As in the kernel, the soft cap applies before the mask and a
    masked probability is exactly 0 (the score is -inf)."""
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
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        kpos = k0 + torch.arange(s.shape[2])[None, :]
        vis = (qpos >= kpos) if causal else torch.ones_like(s[0], dtype=bool)
        if window is not None:
            vis = vis & (qpos - kpos < window)
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


def test_d256_gemma2_variant_matches_pallas():
    """Head dim 256 with gemma2-2b's attention (soft cap 50, a sliding
    window, GQA group 2), the shape the wgmma body now takes at d 256: the
    plain version and the kernel's blocked hi + lo recomputation
    (``_attention_p_bf16(split=True)``, kv blocks of 64 as the d 256 tiles
    have) against the Pallas kernel in interpret mode and the JAX oracle,
    on bf16 inputs held as f32.  The plain version within the f32 flash
    tolerance (2e-3 / 1e-3); the recomputation, whose P is exact to about
    2^-17, within 2e-5 of the Pallas kernel (1.6e-6 at this seed, outputs
    up to 0.96), where P rounded to bf16 once is 9.0e-4 off."""
    hq, hkv, s, d = 4, 2, 256, 256
    kw = dict(causal=True, window=96, softcap=50.0)
    q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
               for a in _qkv(26, 2 * hq, 2 * hkv, s, s, d))
    heads = dict(num_q_heads=hq, num_kv_heads=hkv)
    pallas = np.asarray(flash_attention_pallas(
        q, k, v, bq=64, bkv=64, interpret=True, **heads, **kw))
    oracle = np.asarray(ref.flash_attention_ref(q, k, v, **heads, **kw))
    _close(flash_attention_plain(*_t(q, k, v), **heads, **kw), pallas)
    _close(flash_attention_plain(*_t(q, k, v), **heads, **kw), oracle)
    split = _attention_p_bf16(q, k, v, hq, hkv, True, split=True,
                              softcap=50.0, window=96)
    assert float(np.abs(split - pallas).max()) < 2e-5
    once = _attention_p_bf16(q, k, v, hq, hkv, True, softcap=50.0, window=96)
    assert float(np.abs(once - pallas).max()) > 1e-4
    # rows that see the window's edge mask keys the causal mask alone keeps
    assert not np.allclose(
        pallas, np.asarray(flash_attention_pallas(
            q, k, v, bq=64, bkv=64, interpret=True, causal=True,
            softcap=50.0, **heads)), atol=1e-3)


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


# ---------------------------------------------------------------------------
# the backward and lse
# ---------------------------------------------------------------------------

BWD_CASES = [
    # (hq, hkv, sq, skv, d)
    (4, 4, 64, 64, 64),        # GQA 1
    (4, 2, 77, 77, 128),       # GQA 2, ragged
    (8, 2, 50, 130, 64),       # GQA 4, sq < skv
    (4, 1, 130, 50, 128),      # GQA 4, sq > skv
]
BWD_D256 = (2, 1, 90, 70, 256)  # gemma2's head dim: GQA 2, sq > skv, ragged
# The forward's window and softcap.  With the window of 24, (130, 50) has
# query rows that see no key (qpos >= skv + 23), causal or not.
BWD_MASKS = {
    "plain": dict(),
    "softcap": dict(softcap=30.0),
    "window": dict(window=24),
    "window-softcap": dict(window=24, softcap=50.0),
}


def _rel(got, ref) -> float:
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("mask", sorted(BWD_MASKS))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", BWD_CASES + [BWD_D256],
                         ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_backward_plain_matches_autograd_and_jax_vjp(dtype, case, causal,
                                                     mask):
    hq, hkv, sq, skv, d = case
    q, k, v = _qkv(sq * d + skv, 2 * hq, 2 * hkv, sq, skv, d)
    q = _span_the_cap(q, BWD_MASKS[mask].get("softcap"))
    dout = (np.random.RandomState(sq).randn(2 * hq, sq, d)).astype(np.float32)
    kw = dict(num_q_heads=hq, num_kv_heads=hkv, causal=causal,
              **BWD_MASKS[mask])
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tol = 2e-4 if dtype == "f32" else 2e-2
    tq, tk, tv, tdo = (t.to(tdt) for t in _t(q, k, v, dout))
    out, lse = flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    got = flash_attention_backward_plain(tq, tk, tv, out, tdo, lse, **kw)
    assert [g.dtype for g in got] == [tdt] * 3
    blind = torch.isneginf(lse)                 # rows that see no key
    if blind.any():
        assert not bool(got[0][blind].any())
    # the wrapper takes the plain version for CPU tensors (f32 at d 256:
    # the SIMT body it stands for is not built there, so it refuses)
    before = BACKWARD_LAUNCHES.count
    if dtype == "f32" and d == 256:
        with pytest.raises(ValueError, match="head dims"):
            flash_attention_backward_kernel(tq, tk, tv, out, tdo, lse, **kw)
    else:
        wrapped = flash_attention_backward_kernel(tq, tk, tv, out, tdo, lse,
                                                  **kw)
        for a, b in zip(wrapped, got):
            assert torch.equal(a, b)
    assert BACKWARD_LAUNCHES.count == before
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    auto = torch.autograd.grad(flash_attention_plain(*leaves, **kw), leaves,
                               tdo)
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, dout))
    _, vjp = jax.vjp(lambda a, b, c: ref.flash_attention_ref(a, b, c, **kw),
                     jq, jk, jv)
    jax_grads = vjp(jdo)
    for name, g, a, j in zip("qkv", got, auto, jax_grads):
        assert _rel(g.float(), a.float()) <= tol, (name, "autograd")
        assert _rel(g.float(), j) <= tol, (name, "jax.vjp")
    if kw.get("softcap"):
        # control: the uncapped backward on the capped forward's lse (a
        # kernel that ran its uncapped instantiation) fails the tolerance
        uncapped = flash_attention_backward_plain(
            tq, tk, tv, out, tdo, lse, **{**kw, "softcap": None})
        assert all(_rel(u.float(), g.float()) > tol
                   for u, g in zip(uncapped, got))


def test_backward_body_is_wgmma_for_bf16_and_simt_for_f32():
    assert port_flash.BACKWARD_HEAD_DIMS == (64, 128, 256)
    for d in port_flash.BACKWARD_HEAD_DIMS:
        assert port_flash.backward_body(torch.bfloat16, d) == "wgmma"
    for d in port_flash.SIMT_BACKWARD_HEAD_DIMS:
        assert port_flash.backward_body(torch.float32, d) == "simt"
    # f32 at d 256: the SIMT body's tiles need more shared memory than a
    # block may have, so it is not built and the wrapper refuses it
    with pytest.raises(ValueError, match="head dims"):
        port_flash.backward_body(torch.float32, 256)
    with pytest.raises(ValueError, match="head dims"):
        port_flash.backward_body(torch.bfloat16, 32)


def _backward_bf16_operands(q, k, v, out, dout, lse, hq, hkv, causal,
                            split=False, softcap=None, cap_derivative=True):
    """The wgmma backward's arithmetic in torch, f32 but for the register
    operands: P and dS (with the cap's derivative) formed in f32 from f32
    products of the bf16 inputs, then rounded once to bf16 for dV = P^T dO,
    dK = dS^T Q and dQ = dS K, as the kernel feeds them; with ``split`` as
    hi = bf16(x) plus lo = bf16(x - hi), the forward's two-term PV.
    ``cap_derivative=False`` leaves the cap's derivative out of dS (a
    faulty kernel, for the control)."""
    bhq, sq, d = q.shape
    skv = k.shape[1]
    b, group, scale = bhq // hq, hq // hkv, d ** -0.5
    qf, of, dof = (t.float().reshape(b, hkv, group, sq, d)
                   for t in (q, out, dout))
    kf, vf = (t.float().reshape(b, hkv, skv, d) for t in (k, v))
    l = lse.reshape(b, hkv, group, sq, 1)
    mask = torch.ones(sq, skv, dtype=torch.bool)
    if causal:
        mask &= torch.arange(sq)[:, None] >= torch.arange(skv)[None, :]
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, kf) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    p = torch.exp(s - l).masked_fill(~mask, 0.0)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dof, vf)
    ds = p * (dp - (dof * of).sum(-1, keepdim=True))
    if softcap is not None and cap_derivative:
        ds = ds * (1.0 - (s / softcap) ** 2)

    def operand(x):
        hi = x.to(torch.bfloat16).float()
        return hi + (x - hi).to(torch.bfloat16).float() if split else hi

    dq = torch.einsum("bkgqs,bksd->bkgqd", operand(ds), kf) * scale
    dk = torch.einsum("bkgqs,bkgqd->bksd", operand(ds), qf) * scale
    dv = torch.einsum("bkgqs,bkgqd->bksd", operand(p), dof)
    return (dq.reshape(bhq, sq, d), dk.reshape(-1, skv, d),
            dv.reshape(-1, skv, d))


@pytest.mark.parametrize("softcap", [None, 50.0])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_backward_p_and_ds_in_bf16_hold_the_tolerance(case, causal, softcap):
    """Why the wgmma backward rounds P and dS once to bf16 (FlashAttention-2
    and -3's choice) and needs no hi + lo split: on bf16 inputs (held as
    f32) and the bf16 forward output, dq, dk and dv so computed agree with
    ``flash_attention_backward_plain`` within 3.4e-3 of max |plain| at
    these shapes (the card's gate is 2e-2), and with ``jax.vjp`` of the
    JAX oracle within 3.4e-3 (that includes the output's bf16 rounding in
    delta); the split would keep them within 1e-5 of the plain version.
    With gemma2's softcap of 50, at scores of std 25 that the cap bends,
    dS carries the cap's derivative before it is rounded, as the kernel
    forms it: the same bounds hold against the plain version, and against
    ``jax.vjp`` from the f32 forward output; the bf16 output's rounding in
    delta alone then moves dq and dk by up to 9.6e-3 of max |jax.vjp|
    (the plain version's own distance), so from the bf16 output they are
    held within the card's 2e-2.  Leaving the cap's derivative out moves dq
    and dk by 0.3 to 2.3 of max |plain| (the control)."""
    hq, hkv, sq, skv, d = case
    rng = np.random.RandomState(sq * d + skv)
    q, k, v = _qkv(sq * d + skv, 2 * hq, 2 * hkv, sq, skv, d)
    q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
               for a in (_span_the_cap(q, softcap), k, v))
    dout = np.asarray(jnp.asarray(rng.randn(2 * hq, sq, d), jnp.bfloat16),
                      np.float32)
    kw = dict(num_q_heads=hq, num_kv_heads=hkv, causal=causal,
              softcap=softcap)
    tq, tk, tv, tdo = _t(q, k, v, dout)
    out32, lse = flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    out = out32.to(torch.bfloat16).float()
    plain = flash_attention_backward_plain(tq, tk, tv, out, tdo, lse, **kw)
    _, vjp = jax.vjp(lambda a, b, c: ref.flash_attention_ref(a, b, c, **kw),
                     *(jnp.asarray(a) for a in (q, k, v)))
    jax_grads = vjp(jnp.asarray(dout))
    once = _backward_bf16_operands(tq, tk, tv, out, tdo, lse, hq, hkv,
                                   causal, softcap=softcap)
    split = _backward_bf16_operands(tq, tk, tv, out, tdo, lse, hq, hkv,
                                    causal, split=True, softcap=softcap)
    from_f32_out = _backward_bf16_operands(tq, tk, tv, out32, tdo, lse, hq,
                                           hkv, causal, softcap=softcap)
    for name, o, sp, pl, jg, o32 in zip("qkv", once, split, plain,
                                        jax_grads, from_f32_out):
        drift = _rel(o, pl)
        assert 1e-4 < drift < 5e-3, (name, drift)
        assert _rel(o, jg) < (5e-3 if softcap is None else 2e-2), \
            (name, "jax.vjp")
        assert _rel(o32, jg) < 5e-3, (name, "jax.vjp, f32 output")
        assert _rel(sp, pl) < 1e-5, (name, "split")
    if softcap is not None:
        no_g = _backward_bf16_operands(tq, tk, tv, out, tdo, lse, hq, hkv,
                                       causal, softcap=softcap,
                                       cap_derivative=False)
        for name, o, pl in zip("qk", no_g, plain):
            assert _rel(o, pl) > 2e-2, (name, "without the cap's derivative")


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, window=16),
                                dict(causal=True, softcap=20.0)],
                         ids=["causal", "full", "window", "softcap"])
def test_return_lse_is_the_logsumexp_of_the_masked_scaled_scores(kw):
    hq, hkv, sq, skv, d = 4, 2, 70, 90, 64
    q, k, v = _qkv(3, 2 * hq, 2 * hkv, sq, skv, d)
    tq, tk, tv = _t(q, k, v)
    heads = dict(num_q_heads=hq, num_kv_heads=hkv)
    out, lse = flash_attention_plain(tq, tk, tv, return_lse=True, **heads,
                                     **kw)
    assert lse.shape == (2 * hq, sq) and lse.dtype == torch.float32
    torch.testing.assert_close(out, flash_attention_plain(tq, tk, tv,
                                                          **heads, **kw))
    s = torch.einsum("bqd,bsd->bqs", tq, tk.repeat_interleave(hq // hkv, 0)
                     ) * d ** -0.5
    if kw.get("softcap"):
        s = kw["softcap"] * torch.tanh(s / kw["softcap"])
    qpos, kpos = torch.arange(sq)[:, None], torch.arange(skv)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool)
    if kw["causal"]:
        mask &= qpos >= kpos
    if kw.get("window"):
        mask &= qpos - kpos < kw["window"]
    expected = torch.logsumexp(s.masked_fill(~mask, float("-inf")), -1)
    torch.testing.assert_close(lse, expected, atol=1e-5, rtol=1e-5)
    chunked = flash_attention_plain(tq, tk, tv, return_lse=True, q_chunk=32,
                                    **heads, **kw)[1]
    torch.testing.assert_close(chunked, expected, atol=1e-5, rtol=1e-5)
    cpu_kernel = flash_attention_kernel(tq, tk, tv, bq=32, bkv=64,
                                        return_lse=True, **heads, **kw)[1]
    torch.testing.assert_close(cpu_kernel, expected, atol=1e-5, rtol=1e-5)


def test_lse_is_minus_inf_for_a_row_that_sees_no_key():
    """Non-causal with a window of 8: rows at qpos >= skv + 7 see no key;
    their output is 0, their lse -inf, and their gradient 0."""
    hq, hkv, sq, skv, d = 2, 1, 48, 16, 64
    q, k, v = _qkv(9, 2 * hq, 2 * hkv, sq, skv, d)
    kw = dict(num_q_heads=hq, num_kv_heads=hkv, causal=False, window=8)
    out, lse = flash_attention_plain(*_t(q, k, v), return_lse=True, **kw)
    blind = torch.arange(sq) >= skv + 7
    assert bool(torch.isneginf(lse[:, blind]).all())
    assert bool(torch.isfinite(lse[:, ~blind]).all())
    assert not bool(out[:, blind].any())
    no_key = flash_attention_kernel(
        *_t(q, k[:, :0].copy(), v[:, :0].copy()), bq=32, bkv=64,
        return_lse=True, num_q_heads=hq, num_kv_heads=hkv)
    assert not bool(no_key[0].any()) and bool(torch.isneginf(no_key[1]).all())


def test_attention_launch_counter_counts_windowed_launches():
    """The flash wrappers' counters count every launch and, in
    ``windowed``, those made with a window; a reset clears both."""
    counter = port_flash.AttentionLaunchCounter()
    counter.launched((4, 64, 64, 64, True), windowed=True, body="wgmma",
                     capped=True)
    counter.launched((4, 64, 64, 64, True), body="wgmma", capped=False)
    counter.launched((2, 32, 32, 128, False), windowed=True, bq=64, bkv=64)
    assert counter.count == 3 and counter.windowed.count == 2
    assert counter.tiles[(4, 64, 64, 64, True)] == {"body": "wgmma",
                                                    "capped": False}
    assert counter.windowed.tiles[(4, 64, 64, 64, True)]["capped"]
    counter.reset()
    assert counter.count == counter.windowed.count == 0
    assert not counter.tiles and not counter.windowed.tiles
    # only the wgmma body compiles dK / dV and dQ for a cap (checked before
    # the library is built)
    for dtype, kernel in ((torch.float32, "dkdv"), (torch.bfloat16, "delta")):
        with pytest.raises(ValueError, match="compiled for a softcap"):
            port_flash.backward_attributes(dtype, 64, kernel, capped=True)


def test_backward_refuses_window_softcap_and_other_head_dims():
    """The backward takes the forward's window and softcap (no longer
    refused) and refuses what the forward refuses of them (a window that
    is not an int32, a softcap that is not positive); it refuses f32 at
    head dim 256 (the SIMT body is not built there, bf16 is), an lse of
    the wrong shape, and launches nothing for CPU tensors."""
    q, k, v = _t(*_qkv(6, 4, 2, 32, 32, 64))
    heads = dict(num_q_heads=2, num_kv_heads=1)
    before = BACKWARD_LAUNCHES.count
    for kw in (dict(window=8), dict(softcap=30.0),
               dict(window=8, softcap=30.0, causal=False)):
        out, lse = flash_attention_plain(q, k, v, return_lse=True, **heads,
                                         **kw)
        got = flash_attention_backward_kernel(q, k, v, out, out, lse,
                                              **heads, **kw)
        ref = flash_attention_backward_plain(q, k, v, out, out, lse,
                                             **heads, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), kw
    out, lse = flash_attention_plain(q, k, v, return_lse=True, **heads)
    for kw, match in ((dict(window=1.5), "window"),
                      (dict(softcap=0.0), "softcap")):
        with pytest.raises(ValueError, match=match):
            flash_attention_backward_kernel(q, k, v, out, out, lse, **heads,
                                            **kw)
    q2, k2, v2 = (torch.zeros(4, 32, 256), torch.zeros(2, 32, 256),
                  torch.zeros(2, 32, 256))
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_backward_kernel(q2, k2, v2, q2, q2, lse, **heads)
    bf = [t.to(torch.bfloat16) for t in (q2, k2, v2)]
    assert all(g.shape == t.shape for g, t in zip(
        flash_attention_backward_kernel(*bf, bf[0], bf[0], lse, **heads,
                                        window=8, softcap=50.0), bf))
    assert BACKWARD_LAUNCHES.count == before
    with pytest.raises(ValueError, match="lse"):
        flash_attention_backward_kernel(q, k, v, out, out, lse[:, :5],
                                        **heads)


def test_ops_flash_attention_keeps_autograd_on_the_cpu():
    """On CPU tensors ``ops.flash_attention`` is the plain version, so its
    gradient is autograd's through it."""
    q, k, v = _t(*_qkv(4, 8, 2, 40, 40, 64))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    kw = dict(num_q_heads=4, num_kv_heads=1, causal=True)
    out = ops.flash_attention(*leaves, **kw)
    assert out.requires_grad
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    g = torch.autograd.grad(out, leaves, dout)
    o2, lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
    for a, b in zip(g, flash_attention_backward_plain(q, k, v, o2, dout, lse,
                                                      **kw)):
        torch.testing.assert_close(a, b, atol=2e-4 * float(b.abs().max()),
                                   rtol=2e-4)


def test_ops_without_a_backward_refuse_grad_off_the_cpu():
    """On a tensor that is not on the CPU (here the meta device, standing in
    for the card) each op with no backward kernel raises when grad is
    enabled and an input requires it, instead of cutting the graph; under
    no_grad, or with no input requiring grad, it does not refuse."""
    m = dict(device="meta")
    x = torch.empty(2, 64, 64, **m, requires_grad=True)
    calls = {
        "matmul": lambda a: ops.matmul(a, torch.empty(64, 32, **m)),
        "layernorm": lambda a: ops.layernorm(a[0], a[0],
                                             torch.empty(64, **m),
                                             torch.empty(64, **m)),
        "blocked_colsum": lambda a: ops.blocked_colsum(a[0]),
    }
    for name, call in calls.items():
        with pytest.raises(ops.MissingBackwardError, match=name):
            call(x)
        with torch.no_grad():
            try:
                call(x)
            except ops.MissingBackwardError:
                raise AssertionError(f"{name} refused under no_grad")
            except Exception:
                pass              # the meta device has no kernel to run
