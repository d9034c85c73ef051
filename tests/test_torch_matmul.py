"""The port's matmul against the JAX package's, on the CPU.

``matmul_plain`` and the CPU path of ``ops.matmul`` / ``matmul_kernel`` are
held against the reference's Pallas kernel run in interpret mode and its
pure-jnp oracle, on the same seeded numpy inputs.  The bf16 wrapper takes
the wgmma kernel's compiled tiles only (granules of 64), the f32 wrapper
the SIMT kernel's; both specs are held against those tables.  Tolerances are those of
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

from repro_torch.core import (H100, CandidateTable, HopperModel, matmul_spec,
                              moe_gmm_spec)
from repro_torch.core.device_model import roofline_times
from repro_torch.core.kernel_spec import (SM90_SMEM_EXTRA, SM90_STAGES,
                                          SM90_TILES, sm90_smem_bytes)
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


@pytest.mark.parametrize("name,bm,bn,bk", [
    *[("float32", *t) for t in [(8, 128, 128), (32, 256, 32),
                                (64, 128, 64), (128, 128, 64)]],
    *[("bfloat16", *t) for t in SM90_TILES]])
def test_kernel_wrapper_cpu_block_sweep(name, bm, bn, bk):
    """f32 SIMT tiles whose ring fits, and every compiled bf16 wgmma
    tile."""
    xa, ya = _inputs(7, (128, 256), (256, 256))
    (xj, xt), (yj, yt) = _both(xa, name), _both(ya, name)
    expected = matmul_pallas(xj, yj, bm=bm, bn=bn, bk=bk, interpret=True)
    _close(matmul_kernel(xt, yt, bm=bm, bn=bn, bk=bk), expected, name)


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
    bm = 64 if name == "bfloat16" else 32    # bf16 tiles are wgmma's
    for out in (matmul_plain(xt, yt, tout), ops.matmul(xt, yt, out_dtype=tout),
                matmul_kernel(xt, yt, bm=bm, bn=64, bk=64, out_dtype=tout)):
        assert out.dtype == tout
        tol = max(_tol(name), _tol(out_name))
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(expected, np.float32),
                                   atol=tol, rtol=tol)


def test_ops_pads_unaligned_shapes():
    xa, ya = _inputs(9, (5, 60, 100), (100, 36))
    (xj, xt), (yj, yt) = _both(xa, "float32"), _both(ya, "float32")
    _close(ops.matmul(xt, yt), ref.matmul_ref(xj, yj), "float32")


@pytest.mark.parametrize("name,padded", [("bfloat16", (320, 128, 64)),
                                         ("float32", (304, 104, 40))])
def test_ops_pads_to_the_kernels_granules(monkeypatch, name, padded):
    """An unaligned shape is zero-padded to 64 in bf16 (the wgmma
    granules) and to 8 in f32, launched at a tile the kernel takes, and the
    sliced result still matches the JAX reference."""
    seen = []

    def recording(x, y, **kw):
        seen.append((x.shape[0], y.shape[1], x.shape[1], kw))
        return matmul_kernel(x, y, **kw)

    monkeypatch.setattr(ops, "matmul_kernel", recording)
    xa, ya = _inputs(11, (5, 60, 37), (37, 100))
    (xj, xt), (yj, yt) = _both(xa, name), _both(ya, name)
    out = ops.matmul(xt, yt)
    assert tuple(out.shape) == (5, 60, 100)
    _close(out, ref.matmul_ref(xj, yj), name)
    (m, n, k, kw), = seen
    assert (m, n, k) == padded
    if name == "bfloat16":
        assert (kw["bm"], kw["bn"], kw["bk"]) in SM90_TILES


def test_launch_counter_records_the_tiles_of_each_shape():
    """``launched`` counts one launch and keeps the tiles of the last
    launch at its shape; ``reset`` clears both."""
    c = port_matmul.LaunchCounter()
    c.launched((4, 128), bq=64, bkv=64)
    c.launched((4, 256), bq=64, bkv=128)
    c.launched((4, 128), bq=128, bkv=64)
    assert c.count == 3
    assert c.tiles == {(4, 128): {"bq": 128, "bkv": 64},
                       (4, 256): {"bq": 64, "bkv": 128}}
    c.reset()
    assert (c.count, c.tiles) == (0, {})


def test_bf16_wrapper_rejects_an_uncompiled_tile():
    """The bf16 kernel is a table of instantiations: a tile off the wgmma
    granules, or on them but not compiled (its ring would not fit), raises
    on the CPU too, before any plain fallback could run."""
    LAUNCHES.reset()
    x = torch.zeros(384, 256, dtype=torch.bfloat16)
    y = torch.zeros(256, 512, dtype=torch.bfloat16)
    for kw, msg in ((dict(bm=96, bn=128, bk=32), "multiple of 64"),
                    (dict(bm=64, bn=128, bk=32), "multiple of 64"),
                    (dict(bm=128, bn=128, bk=128), "not compiled"),
                    (dict(bm=64, bn=256, bk=128), "not compiled")):
        with pytest.raises(ValueError, match=msg):
            matmul_kernel(x, y, **kw)
    assert LAUNCHES.count == 0


@pytest.mark.parametrize("make,rows", [(matmul_spec, "bm"),
                                       (moe_gmm_spec, "bg")])
def test_bf16_spec_is_the_compiled_table(make, rows):
    """The bf16 spec's feasible set is exactly the compiled tiles: the
    candidates whose ring fits 232448 bytes, with 2 * bm threads and the
    ring's shared memory; the table is the header's GEMM_SM90_TILES."""
    spec = make(2)
    D = ({"m": 4096, "n": 4096, "k": 4096} if rows == "bm"
         else {"e": 8, "g": 4096, "k": 4096, "n": 4096})
    table = spec.candidates(D, H100)
    got = sorted(zip(*(table[p].tolist() for p in (rows, "bn", "bk"))))
    assert got == sorted(SM90_TILES) and len(got) == 9
    tt = spec.traffic_table(D, table, H100)
    np.testing.assert_array_equal(tt.threads, 2 * table[rows])
    np.testing.assert_array_equal(
        tt.stage_bytes, [sm90_smem_bytes(*t) for t in zip(
            table[rows], table["bn"], table["bk"])])
    assert np.all(tt.stage_bytes <= 232448)
    assert spec.compute_unit == "bf16" and tt.compute_unit == "bf16"
    # the traffic counts one fetch of each input tile per k step
    ins = [op for op in tt.operands if not op.is_output]
    assert len(ins) == 2
    for op in ins:
        np.testing.assert_array_equal(op.fetches, tt.ctas * tt.seq_iters)
    header = (port_matmul.__file__.rsplit("/", 1)[0]
              + "/csrc/gemm_sm90.cuh")
    text = open(header).read()
    macro = text[text.index("#define GEMM_SM90_TILES"):]
    macro = macro[:macro.index("\n\n")]
    import re
    tiles = [tuple(int(v) for v in t.split(","))
             for t in re.findall(r"X\((\d+, \d+, \d+)\)", macro)]
    assert sorted(tiles) == sorted(SM90_TILES)
    assert f"kStages = {SM90_STAGES};" in text
    assert SM90_SMEM_EXTRA == 1024 + 2 * SM90_STAGES * 8


SIMT_HEADER = (port_matmul.__file__.rsplit("/", 1)[0]
               + "/csrc/gemm_simt.cuh")
F32_TILES = [(16, 128, 8), (32, 64, 128), (64, 64, 32), (64, 256, 16),
             (128, 128, 32), (256, 128, 8)]


@pytest.mark.parametrize("make,rows", [(matmul_spec, "bm"),
                                       (moe_gmm_spec, "bg")])
def test_f32_specs_state_the_simt_ring(make, rows):
    """The f32 spec is the SIMT mainloop of gemm_simt.cuh: bm * bn / 64
    threads on the CUDA cores under its 128-register cap, the staged x and
    y tiles of one k step, the ring's other SIMT_STAGES - 1 slots and every
    slot's x-row padding as scratch, granules of 8, and the candidate grid
    of before; its feasible set is exactly the tiles whose ring fits a
    block's shared memory."""
    import itertools
    import re
    from repro_torch.core.kernel_spec import (SIMT_CANDIDATES, SIMT_PAD,
                                              SIMT_STAGES, simt_smem_bytes)
    from repro_torch.core.rational_program import const, var
    spec = make(4)
    assert spec.compute_unit == "f32" and spec.regs_per_thread == 128
    assert spec.threads == var(rows) * var("bn") / const(64.0)
    assert spec.program_params == (rows, "bn", "bk")
    assert spec.constraints == tuple(f"{p} % 8 == 0"
                                     for p in spec.program_params)
    assert spec.param_candidates == {rows: (16, 32, 64, 128, 256, 512),
                                     "bn": (16, 32, 64, 128, 256, 512),
                                     "bk": (8, 16, 32, 64, 128, 256)}
    assert SIMT_CANDIDATES == {"m": spec.param_candidates[rows],
                               "n": spec.param_candidates["bn"],
                               "k": spec.param_candidates["bk"]}
    scratch = [(op.tile, op.dtype_bytes) for op in spec.operands
               if op.scratch]
    assert scratch == [((SIMT_STAGES - 1, rows, "bk"), 4),
                       ((SIMT_STAGES - 1, "bk", "bn"), 4),
                       ((SIMT_STAGES, rows, SIMT_PAD), 4)]
    staged = [op.tile for op in spec.operands if op.staged]
    assert staged == [(rows, "bk"), ("bk", "bn")]
    # the header's constants are the spec's
    text = open(SIMT_HEADER).read()
    for const_, val in (("kStages", SIMT_STAGES), ("kPad", SIMT_PAD),
                        ("kMicro", 8), ("kMaxThreads", 512)):
        assert re.search(rf"constexpr int {const_} = {val};", text), const_
    D = ({"m": 2048, "n": 2048, "k": 2048} if rows == "bm"
         else {"e": 4, "g": 2048, "k": 2048, "n": 2048})
    table = spec.candidates(D, H100)
    tt = spec.traffic_table(D, table, H100)
    np.testing.assert_array_equal(
        tt.stage_bytes, [simt_smem_bytes(*t) for t in zip(
            table[rows], table["bn"], table["bk"])])
    np.testing.assert_array_equal(tt.threads,
                                  table[rows] * table["bn"] // 64)
    assert tt.compute_unit == "f32"
    want = sorted(t for t in itertools.product(*spec.param_candidates.values())
                  if 32 <= t[0] * t[1] // 64 <= 512
                  and simt_smem_bytes(*t) <= H100.smem_per_block_optin)
    got = sorted(zip(*(table[p].tolist() for p in spec.program_params)))
    assert got == want
    # the traffic counts one fetch of each input tile per k step
    ins = [op for op in tt.operands if not op.is_output]
    assert [op.name for op in ins] == [spec.operands[0].name,
                                       spec.operands[1].name]
    for op in ins:
        np.testing.assert_array_equal(op.fetches, tt.ctas * tt.seq_iters)


@pytest.mark.parametrize("tile", F32_TILES)
@pytest.mark.parametrize("kind", ["matmul", "moe_gmm"])
def test_f32_launch_states_the_spec(kind, tile):
    """``matmul_launch`` / ``moe_gmm_launch`` for f32 state the spec's
    threads, the ring's shared-memory bytes (SIMT_STAGES padded slots) and
    grid at each tile, as the C launcher computes them."""
    from repro_torch.core.kernel_spec import simt_smem_bytes
    from repro_torch.kernels import moe_gmm as port_gmm
    bm, bn, bk = tile
    if kind == "matmul":
        D = {"m": 1024, "n": 512, "k": 512}
        spec, P = matmul_spec(4), {"bm": bm, "bn": bn, "bk": bk}
        d = port_matmul.matmul_launch(
            (((1024, 512), torch.float32), ((512, 512), torch.float32)), **P)
        grid = (1024 // bm, 512 // bn)
    else:
        D = {"e": 3, "g": 1024, "k": 512, "n": 512}
        spec, P = moe_gmm_spec(4), {"bg": bm, "bn": bn, "bk": bk}
        d = port_gmm.moe_gmm_launch(
            (((3, 1024, 512), torch.float32), ((3, 512, 512), torch.float32)),
            **P)
        grid = (3, 1024 // bm, 512 // bn)
    one = CandidateTable.from_rows(spec.program_params, [P])
    assert spec.feasible_mask(D, one, H100)[0]
    tt = spec.traffic_table(D, one, H100)
    assert d.threads == bm * bn // 64 == tt.threads[0]
    assert d.smem_bytes == simt_smem_bytes(bm, bn, bk) == tt.stage_bytes[0]
    assert d.smem_bytes == 3 * (bm * (bk + 4) + bk * bn) * 4
    assert d.grid == grid and d.loops == (512 // bk,)
    assert d.granule == 8 and d.compute_unit == "f32"
    assert sum(op.scratch for op in d.operands) == 3


@pytest.mark.parametrize("tile", [(128, 128, 128), (32, 256, 128),
                                  (64, 128, 256), (128, 32, 256)])
@pytest.mark.parametrize("kind", ["matmul", "moe_gmm"])
def test_f32_wrappers_reject_a_tile_whose_ring_does_not_fit(kind, tile):
    """Tiles the single-buffered SIMT body took ((bm + bn) * bk * 4 bytes
    fit) but whose three padded ring slots exceed a block's shared memory:
    both f32 wrappers raise on the CPU too, before the plain version runs,
    and count no launch."""
    from repro_torch.kernels import moe_gmm as port_gmm
    bm, bn, bk = tile
    assert (bm + bn) * bk * 4 <= port_matmul.SMEM_LIMIT
    if kind == "matmul":
        x, y = torch.zeros(256, 256), torch.zeros(256, 256)
        launches, call = LAUNCHES, lambda: matmul_kernel(x, y, bm=bm, bn=bn,
                                                         bk=bk)
    else:
        x, w = torch.zeros(2, 256, 256), torch.zeros(2, 256, 256)
        launches = port_gmm.LAUNCHES
        call = lambda: port_gmm.moe_gmm_kernel(x, w, bg=bm, bn=bn, bk=bk)
    before = launches.count
    with pytest.raises(ValueError, match="shared memory for its ring"):
        call()
    assert launches.count == before


def test_roofline_uses_the_tensor_core_peak_for_bf16():
    """The split rule and HopperModel divide a bf16 matmul row's FLOPs by
    the 989 TFLOP/s tensor-core peak, an f32 row's by the 67 TFLOP/s FP32
    peak."""
    D = {"m": 4096, "n": 4096, "k": 4096}
    flops = 2.0 * 4096 ** 3
    for elem, peak in ((2, H100.peak_flops_bf16), (4, H100.peak_flops_f32)):
        spec = matmul_spec(elem)
        table = spec.candidates(D, H100)
        tt = spec.traffic_table(D, table, H100)
        t_mem, t_cmp = roofline_times(tt, H100)
        np.testing.assert_allclose(t_cmp, flops / peak)
        assert H100.peak_flops(spec.compute_unit) == peak
    # HopperModel: the same table is much faster on the tensor cores
    spec = matmul_spec(2)
    one = spec.candidates(D, H100).select([0])
    tt = spec.traffic_table(D, one, H100)
    model = HopperModel(noise=0.0)
    _, _, c_bf16 = model._times(tt)
    tt.compute_unit = "f32"
    _, _, c_f32 = model._times(tt)
    np.testing.assert_allclose(c_f32 / c_bf16,
                               H100.peak_flops_bf16 / H100.peak_flops_f32)


def test_changed_header_builds_a_new_library(tmp_path):
    """The library path hashes every csrc/*.cuh, so an edited header never
    loads a stale library."""
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    before = {n: _build._library_path(n, csrc) for n in ("matmul", "colsum")}
    assert before["matmul"] == _build._library_path("matmul")
    header = csrc / "gemm_sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build._library_path(n, csrc) for n in ("matmul", "colsum")}
    assert after["matmul"] != before["matmul"]
    assert after["colsum"] != before["colsum"]
    (csrc / "extra.cuh").write_text("// new header\n")
    assert _build._library_path("matmul", csrc) != after["matmul"]


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


def test_smem_load_probe_source_instantiates_every_pattern():
    """The shared-memory load probe behind the SIMT layout
    (``repro_torch.benchmarks.smem_loads``, card only) builds one
    instantiation per access pattern, at the width each names, and selects
    its lane mapping; import and source generation need no card."""
    from repro_torch.benchmarks import smem_loads
    src = smem_loads.source()
    for i, (name, width, expr) in enumerate(smem_loads.PATTERNS):
        assert f"run<{width}, {i}>()" in src, name
        assert f"P == {i} ? ({expr})" in src, name
        assert name.startswith(f"{width} B, ")
    assert src.count("printf(") == len(smem_loads.PATTERNS)
