"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc and skip without one.  The file
imports no JAX (the machine with the card has none), so on that machine

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

runs them.  Tolerances: 2e-2 abs and rel in bf16; in f32 2e-4 for the
matmul, the grouped matmul, the layernorm and the column sum, 2e-3 abs /
1e-3 rel for flash attention and 5e-3 abs / 1e-3 rel for the SSD scan
(tests/test_kernels.py's tolerances for each kernel).  The flash-attention
backward, the SSD scan's and the grouped matmul's backward: 2e-2 x max
|plain| per gradient in bf16, 2e-4 in f32.
"""

import itertools

import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import layernorm as ln
from repro_torch.kernels import moe_gmm as gmm
from repro_torch.kernels import reduce as cs
from repro_torch.kernels.flash_attention import LAUNCHES as FLASH_LAUNCHES
from repro_torch.kernels.flash_attention import (
    BACKWARD_LAUNCHES, flash_attention_backward_kernel,
    flash_attention_backward_plain, flash_attention_kernel,
    flash_attention_plain)
from repro_torch.core import H100, matmul_spec, moe_gmm_spec
from repro_torch.core.kernel_spec import (FLASH_SM90_TILES, SM90_TILES,
                                          flash_uses_sm90, ssd_scan_spec)
from repro_torch.kernels.matmul import LAUNCHES as MATMUL_LAUNCHES
from repro_torch.kernels.matmul import OUT_DTYPES, matmul_kernel, matmul_plain
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.ssd_scan import LAUNCHES as SSD_LAUNCHES
from repro_torch.kernels.ssd_scan import ssd_scan_kernel, ssd_scan_plain

VARIANTS = {
    "causal": dict(causal=True),
    "full": dict(causal=False),
    "window": dict(causal=True, window=64),
    "softcap": dict(causal=True, softcap=30.0),
}


def _f32_tiles(spec, D):
    """Every tile of the f32 SIMT spec feasible at D, as keyword dicts."""
    table = spec.candidates(D, H100)
    return [table.row(i) for i in range(len(table))]


@pytest.mark.cuda
def test_cuda_matmul_kernel_matches_plain():
    """Every compiled bf16 wgmma tile with each output type, at k 1024 (8
    or 16 k steps: the 4-slot ring wraps), and every feasible f32 SIMT tile
    at k 1024 (4-128 k steps: the 3-slot cp.async ring wraps) and at k = bk
    (one k step)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-4
        x = torch.randn(256, 1024, generator=gen, device="cuda").to(dtype)
        y = (torch.randn(1024, 512, generator=gen, device="cuda") / 32
             ).to(dtype)
        plain = matmul_plain(x, y, torch.float32)
        runs = ([(t, o) for t in SM90_TILES for o in OUT_DTYPES]
                if dtype == torch.bfloat16 else
                [((P["bm"], P["bn"], P["bk"]), dtype) for P in _f32_tiles(
                    matmul_spec(4), {"m": 256, "n": 512, "k": 1024})])
        for (bm, bn, bk), out_dtype in runs:
            before = MATMUL_LAUNCHES.count
            out = matmul_kernel(x, y, bm=bm, bn=bn, bk=bk,
                                out_dtype=out_dtype)
            assert MATMUL_LAUNCHES.count == before + 1
            assert out.dtype == out_dtype
            torch.testing.assert_close(out.float(), plain, atol=tol,
                                       rtol=tol)
            if dtype == torch.float32:
                xs, ys = x[:, :bk].contiguous(), y[:bk].contiguous()
                torch.testing.assert_close(
                    matmul_kernel(xs, ys, bm=bm, bn=bn, bk=bk),
                    matmul_plain(xs, ys), atol=tol, rtol=tol)
        torch.testing.assert_close(ops.matmul(x, y).float(), plain,
                                   atol=tol, rtol=tol)
    # f32 in, bf16 and f16 out through the SIMT epilogue's 8-byte stores
    x, y = torch.randn(128, 256, generator=gen, device="cuda"), \
        torch.randn(256, 128, generator=gen, device="cuda") / 16
    plain = matmul_plain(x, y)
    for out_dtype in (torch.bfloat16, torch.float16):
        out = matmul_kernel(x, y, bm=64, bn=64, bk=32, out_dtype=out_dtype)
        assert out.dtype == out_dtype
        torch.testing.assert_close(out.float(), plain, atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_cuda_flash_kernel_matches_plain():
    """bf16 at d 64, 128 and 256: every compiled wgmma tile (at d 256 the
    two of bkv 64); f32: the SIMT tile (32, 64).  Causal, full, window and
    soft-cap, GQA group 4 and 1, and ragged lengths (sq = skv = 200, sq 77
    < skv 333, sq 333 > skv 130) that no tile divides."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype, d, (name, kw), (hq, hkv), (sq, skv) in itertools.product(
            (torch.bfloat16, torch.float32), (64, 128, 256),
            VARIANTS.items(), ((4, 1), (2, 2)),
            ((200, 200), (77, 333), (333, 130))):
        atol, rtol = (2e-2, 2e-2) if dtype == torch.bfloat16 else (2e-3, 1e-3)
        q = torch.randn(2 * hq, sq, d, generator=gen, device="cuda").to(dtype)
        k = torch.randn(2 * hkv, skv, d, generator=gen, device="cuda").to(dtype)
        v = torch.randn(2 * hkv, skv, d, generator=gen, device="cuda").to(dtype)
        heads = dict(num_q_heads=hq, num_kv_heads=hkv)
        plain = flash_attention_plain(q, k, v, **heads, **kw)
        tiles = (FLASH_SM90_TILES[d] if flash_uses_sm90(d, q.element_size())
                 else [(32, 64)])
        for bq, bkv in tiles:
            before = FLASH_LAUNCHES.count
            out = flash_attention_kernel(q, k, v, bq=bq, bkv=bkv, **heads,
                                         **kw)
            assert FLASH_LAUNCHES.count == before + 1
            assert FLASH_LAUNCHES.tiles[(2 * hq, sq, skv, d, kw["causal"])] \
                == {"bq": bq, "bkv": bkv}
            torch.testing.assert_close(out.float(), plain.float(), atol=atol,
                                       rtol=rtol)
        torch.testing.assert_close(
            ops.flash_attention(q, k, v, **heads, **kw).float(),
            plain.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_cuda_ssd_kernel_matches_plain():
    """Every chunk the kernel takes at each dtype (the compiled wgmma
    chunks at bf16 (64, 128)), at a length no chunk divides (a ragged last
    chunk), with B and C per head and shared by 3 rows, with dt in the JAX
    kernel tests' range and with small steps, where the state carried
    across chunks dominates."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype, (dh, n), (lo, hi), h in itertools.product(
            (torch.bfloat16, torch.float32), ((64, 128), (32, 32)),
            ((0.01, 0.51), (1e-3, 1e-2)), (1, 3)):
        atol, rtol = (2e-2, 2e-2) if dtype == torch.bfloat16 else (5e-3, 1e-3)
        bh, s = 6, 333
        x = (torch.randn(bh, s, dh, generator=gen, device="cuda") * 0.5
             ).to(dtype)
        dt = lo + (hi - lo) * torch.rand(bh, s, generator=gen, device="cuda")
        B = (torch.randn(bh // h, s, n, generator=gen, device="cuda") * 0.3
             ).to(dtype)
        C = (torch.randn(bh // h, s, n, generator=gen, device="cuda") * 0.3
             ).to(dtype)
        A = -0.5 - torch.rand(bh, generator=gen, device="cuda")
        spec = ssd_scan_spec(dh, n, torch.finfo(dtype).bits // 8)
        chunks = spec.candidates({"bh": bh, "s": s, "chunkflops": 1}
                                 )["chunk"].tolist()
        assert chunks
        for chunk in chunks:
            plain = ssd_scan_plain(x, dt, B, C, A, chunk=chunk)
            before = SSD_LAUNCHES.count
            out = ssd_scan_kernel(x, dt, B, C, A, chunk=chunk)
            assert SSD_LAUNCHES.count == before + 1
            torch.testing.assert_close(out.float(), plain.float(), atol=atol,
                                       rtol=rtol)
            assert torch.equal(out, ssd_scan_kernel(x, dt, B, C, A,
                                                    chunk=chunk))
        torch.testing.assert_close(
            ops.ssd_scan(x, dt, B, C, A).float(),
            ssd_scan_plain(x, dt, B, C, A).float(), atol=atol, rtol=rtol)


def _close(out, plain, dtype):
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-4
    torch.testing.assert_close(out.float(), plain.float(), atol=tol,
                               rtol=tol)


@pytest.mark.cuda
def test_cuda_moe_gmm_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        # bf16: every compiled wgmma tile at k 768 (6 or 12 k steps: the
        # ring wraps); f32: every feasible SIMT tile at k 256 (1-32 k
        # steps), and one whose thread grid (2 x 24) takes no 4 x 8 warps
        k, n = (768, 256) if dtype == torch.bfloat16 else (256, 192)
        x = torch.randn(4, 128, k, generator=gen, device="cuda").to(dtype)
        w = (torch.randn(4, k, n, generator=gen, device="cuda")
             / 16).to(dtype)
        plain = gmm.moe_gmm_plain(x, w)
        tiles = ([dict(zip(("bg", "bn", "bk"), t)) for t in SM90_TILES]
                 if dtype == torch.bfloat16
                 else [{"bg": 16, "bn": 192, "bk": 8}] + _f32_tiles(
                     moe_gmm_spec(4), {"e": 4, "g": 128, "k": k, "n": n}))
        for P in tiles:
            before = gmm.LAUNCHES.count
            out = gmm.moe_gmm_kernel(x, w, **P)
            assert gmm.LAUNCHES.count == before + 1
            assert gmm.LAUNCHES.tiles[(4, 128, k, n)] == P
            _close(out, plain, dtype)
        xu = torch.randn(3, 37, 45, generator=gen, device="cuda").to(dtype)
        wu = torch.randn(3, 45, 29, generator=gen, device="cuda").to(dtype)
        _close(ops.moe_gmm(xu, wu), gmm.moe_gmm_plain(xu, wu), dtype)


@pytest.mark.cuda
def test_cuda_layernorm_kernel_matches_plain():
    """Vector and scalar loads (c a multiple of 8, and not), br from one
    warp's row to the whole tensor, and a ragged last row block (r 97)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype, (r, c) in itertools.product(
            (torch.bfloat16, torch.float32),
            ((256, 512), (96, 100), (97, 512))):
        x, res = (torch.randn(r, c, generator=gen, device="cuda").to(dtype)
                  for _ in range(2))
        g, b = (torch.randn(c, generator=gen, device="cuda")
                for _ in range(2))
        plain = ln.layernorm_plain(x, res, g, b)
        for br in (8, 32, r):
            before = ln.LAUNCHES.count
            out = ln.layernorm_kernel(x, res, g, b, br=br)
            assert ln.LAUNCHES.count == before + 1
            _close(out, plain, dtype)
        _close(ops.layernorm(x, res, g, b), plain, dtype)


@pytest.mark.cuda
def test_cuda_colsum_kernel_matches_plain():
    """One row split and many (up to 256 CTAs per column block, each adding
    its partials through the workspace), two calls on one input giving
    identical bits, and an unaligned shape through the op."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(2048, 2048, generator=gen, device="cuda").to(dtype)
        plain = cs.colsum_plain(x)
        for br, bc in ((8, 128), (256, 512), (1024, 1024), (2048, 256),
                       (16, 1024)):
            before = cs.LAUNCHES.count
            out = cs.colsum_kernel(x, br=br, bc=bc)
            assert cs.LAUNCHES.count == before + 1
            _close(out, plain, dtype)
            _close(out, cs.colsum_split_order(x, br), dtype)
            assert torch.equal(out, cs.colsum_kernel(x, br=br, bc=bc))
        xu = torch.randn(99, 13, generator=gen, device="cuda").to(dtype)
        _close(ops.blocked_colsum(xu), cs.colsum_plain(xu), dtype)


@pytest.mark.cuda
def test_cuda_polybench_probe_launcher():
    """A PolyBench matmul row (gemm) is timed as the f32 SIMT matmul: its
    timed spec is ``matmul_b32``, whose probe launcher runs the kernel on
    seeded inputs and matches the plain version; syr2k, whose spec counts
    two products per point, is timed as itself and has no launcher."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    from repro_torch.benchmarks.common import timed_spec

    dev = torch.device("cuda")
    D = {"m": 256, "n": 512, "k": 256}
    spec = timed_spec("gemm", dev)
    assert spec.name == "matmul_b32"
    launch = ops.probe_launcher(spec.name, D, dev, 3)
    before = MATMUL_LAUNCHES.count
    out = launch({"bm": 64, "bn": 128, "bk": 32})
    assert MATMUL_LAUNCHES.count == before + 1
    assert out.dtype == torch.float32
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(D["m"], D["k"], generator=gen, device=dev)
    y = torch.randn(D["k"], D["n"], generator=gen, device=dev)
    torch.testing.assert_close(out, matmul_plain(x, y), atol=2e-4, rtol=2e-4)
    assert timed_spec("syr2k", dev).name == "syr2k"
    with pytest.raises(ValueError, match="no probe launcher"):
        ops.probe_launcher("syr2k", D, dev, 3)


@pytest.mark.cuda
def test_cuda_llama_prefill_under_a_step_plan(tmp_path, monkeypatch):
    """llama3.2-1b at full width cut to 2 layers, S 512, under a step plan
    from ``decode_kernel_requests``: the flash kernel launches once per
    layer, the registry is not touched (``stats()`` and the memo) and the
    logits are the bits of the same step resolved through the registry."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    from repro_torch.configs import get_config
    from repro_torch.core import registry
    from repro_torch.core.step_plan import build_step_plan, use_step_plan
    from repro_torch.launch import make_prefill_step
    from repro_torch.models import Model
    from repro_torch.models import transformer as T

    monkeypatch.setenv("KLARAPTOR_CACHE_DIR", str(tmp_path / "cache"))
    registry.clear()
    cfg = get_config("llama3.2-1b").replace(n_layers=2)
    model = Model(cfg)
    params = model.init(0)
    S = 512
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                           device="cuda")
    step = make_prefill_step(model)
    want = step(params, tokens)
    plan = build_step_plan(T.decode_kernel_requests(cfg, batch=1, max_seq=S,
                                                    seqs=(S,)))
    stats, memo = registry.stats(), registry.memo_size()
    before = FLASH_LAUNCHES.count
    with use_step_plan(plan):
        got = step(params, tokens)
    torch.cuda.synchronize()
    assert FLASH_LAUNCHES.count - before == cfg.n_layers
    assert registry.stats() == stats and registry.memo_size() == memo
    assert torch.equal(got, want)
    registry.clear()


@pytest.mark.cuda
def test_cuda_moe_layer_matches_the_plain_grouped_matmul():
    """The smoke qwen3-moe MoE layer (bf16, 8 experts, top-2, d 128) on
    the card: its three expert products launch the grouped-matmul kernel
    through ``ops.moe_gmm``, and the output matches the same layer with
    ``moe_gmm_plain`` (the routing is computed before either runs, so only
    the products' roundings differ: 2e-2 of max |y|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models import layers as L

    cfg = get_config("qwen3-moe-235b-a22b", smoke=True)
    params = Model(cfg).init(0)
    p = {k: v[0] for k, v in params["blocks"]["pos0"].items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(2, 96, cfg.d_model, generator=gen, device="cuda"
                    ).to(torch.bfloat16)
    before = gmm.LAUNCHES.count
    y, aux = L.moe(cfg, p, x)
    assert gmm.LAUNCHES.count == before + 3
    want, want_aux = L.moe(cfg, p, x, gmm_op=gmm.moe_gmm_plain)
    scale = float(want.float().abs().max())
    torch.testing.assert_close(y.float(), want.float(), atol=2e-2 * scale,
                               rtol=2e-2)
    assert torch.equal(aux, want_aux)
    assert torch.equal(y, L.moe(cfg, p, x)[0])


def _smoke_moe_engine(tmp_path, monkeypatch, **kw):
    """An engine over the smoke qwen3-moe (bf16, 8 experts, top-2): its
    decode step launches the grouped-matmul kernel three times per MoE
    layer, inside the decode graph."""
    from repro_torch.configs import get_config
    from repro_torch.core import registry
    from repro_torch.launch import build_engine

    monkeypatch.setenv("KLARAPTOR_CACHE_DIR", str(tmp_path / "cache"))
    registry.clear()
    cfg = get_config("qwen3-moe-235b-a22b", smoke=True)
    return cfg, build_engine(cfg, batch=2, max_seq=32, **kw)


def _serve_two(engine, first_rid=0):
    from repro_torch.serving import Request

    for i in range(2):
        engine.submit(Request(rid=first_rid + i, prompt=[3 + i, 7, 11, 5],
                              max_new_tokens=4))
    return engine.run()


@pytest.mark.cuda
def test_cuda_engine_graphed_decode_equals_eager(tmp_path, monkeypatch):
    """The engine's decode step is one CUDA graph across the traffic, and
    a replay gives the logits of the eager ``decode_step`` on the same
    inputs and the same cache (restored between the two); the graph's
    grouped-matmul launches are its replays times 3 per MoE layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    import numpy as np

    cfg, engine = _smoke_moe_engine(tmp_path, monkeypatch)
    done = _serve_two(engine)
    assert len(done) == 2 and all(r.done for r in done)
    assert engine.compile_counts["decode_step"] == 1
    (graph,) = engine.captures()
    assert graph.replays > 0
    assert graph.launches == {"moe_gmm": 3 * cfg.n_layers}
    assert engine.graph_launches() == {
        "moe_gmm": 3 * cfg.n_layers * graph.replays}
    tok = np.array([5, 9], np.int32)
    pos = np.array([6, 3], np.int32)
    saved = {k: {n: t.clone() for n, t in v.items()}
             for k, v in engine.cache.items()}
    torch.cuda.synchronize()
    eager, _ = engine.model.decode_step(
        engine.params, torch.tensor(tok, device="cuda"),
        torch.tensor(pos, device="cuda"), engine.cache)
    eager = eager.clone()
    for k, v in saved.items():
        for n, t in v.items():
            engine.cache[k][n].copy_(t)
    torch.cuda.synchronize()
    graphed = engine._run_step(tok, pos).clone()
    torch.cuda.synchronize()
    assert engine.compile_counts["decode_step"] == 1
    scale = float(eager.abs().max())
    assert float((graphed - eager).abs().max()) <= 5e-2 * scale
    from repro_torch.core import registry
    registry.clear()


@pytest.mark.cuda
def test_cuda_matmul_in_graph_one_capture_per_branch():
    """``ops.matmul(in_graph=)`` over 8 raw bf16 shapes, captured once per
    branch over padded buffers: captures <= branches, the sliced outputs
    match the plain product, and the device ``branch_index`` equals
    ``host_index`` on every shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    import numpy as np

    from repro_torch.core import (BucketedDispatch, BucketLattice,
                                  LaunchPlanTable)
    from repro_torch.serving.graphs import BranchGraphs

    lat = BucketLattice.from_axes("matmul_b16", {
        "m": [64, 128, 256], "n": [256], "k": [256]})
    table = LaunchPlanTable.build(
        "matmul_b16", H100.name, ("m", "n", "k"), ("bm", "bn", "bk"),
        {"m": np.array([64, 128]), "n": np.array([256, 256]),
         "k": np.array([256, 256])},
        {"bm": np.array([64, 128]), "bn": np.array([128, 256]),
         "bk": np.array([64, 64])})
    disp = BucketedDispatch.build(lat, table, ops.MATMUL_DEFAULT,
                                  device="cuda")
    xp = torch.zeros(256, 256, dtype=torch.bfloat16, device="cuda")
    yp = torch.zeros(256, 256, dtype=torch.bfloat16, device="cuda")
    graphs = BranchGraphs(
        disp, lambda d: ops.matmul(xp, yp, in_graph=disp, dims=d), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    before = MATMUL_LAUNCHES.count
    shapes = [(40, 200, 200), (64, 256, 256), (100, 130, 250),
              (128, 256, 256), (7, 9, 11), (200, 256, 100),
              (256, 256, 256), (33, 17, 255)]
    for m, n, k in shapes:
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        y = (torch.randn(k, n, generator=gen, device="cuda") / k ** 0.5
             ).to(torch.bfloat16)
        xp.zero_()[:m, :k] = x
        yp.zero_()[:k, :n] = y
        D = {"m": m, "n": n, "k": k}
        out = graphs(D)[:m, :n].float()
        torch.testing.assert_close(out, matmul_plain(x, y).float(),
                                   atol=2e-2, rtol=2e-2)
        idx, hit = disp.branch_index(D)
        assert (int(idx), bool(hit)) == disp.host_index(D), D
    torch.cuda.synchronize()
    assert graphs.captures == len(graphs.steps) <= disp.n_branches
    assert graphs.captures == 3
    # the eager first call of each branch counts in LAUNCHES, the replays
    # in the graphs
    replays = sum(s.replays for s in graphs.steps.values())
    assert MATMUL_LAUNCHES.count - before == graphs.captures
    assert graphs.launched() == {"matmul": replays}
    assert replays + graphs.captures == len(shapes)


@pytest.mark.cuda
def test_cuda_stale_step_plan_recaptures(tmp_path, monkeypatch):
    """A pinned override between two rounds of traffic makes the engine's
    step plan stale: the next step rebuilds the plan and captures the
    decode step again (+1 in ``compile_counts``), and its requests finish
    with the override's tiles; the first graph is released, and its
    launches still count."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    from repro_torch.core import registry

    cfg, engine = _smoke_moe_engine(tmp_path, monkeypatch)
    _serve_two(engine)
    assert engine.compile_counts["decode_step"] == 1
    first = engine.graph_launches()["moe_gmm"]
    plan = engine._step_plan
    key = next(k for k in plan.table if k[0] == "moe_gmm_b16"
               and dict(k[1])["g"] == 64)
    pinned = {"bg": 64, "bn": 64, "bk": 64}
    assert plan.table[key] != pinned
    registry.note_override(key[0], registry.hw_name(key[0]), dict(key[1]),
                           pinned)
    assert plan.stale()
    done = _serve_two(engine, first_rid=2)
    assert sorted(r.rid for r in done) == [0, 1, 2, 3]
    assert all(r.done and 1 <= len(r.output) <= 4 for r in done)
    assert engine.compile_counts["decode_step"] == 2
    assert engine._step_plan is not plan and not engine._step_plan.stale()
    assert engine._step_plan.table[key] == pinned
    # the first graph is released; its replays' launches still count
    (graph,) = engine.captures()
    assert engine.graph_launches() == {
        "moe_gmm": first + 3 * cfg.n_layers * graph.replays}
    registry.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("window", [4096, None], ids=["local", "global"])
def test_cuda_gemma2_attention_layer_matches_plain(window):
    """One gemma2-2b attention layer at full width (d_model 2304, 8 q / 4
    kv heads of dim 256: the flash kernel's wgmma body in bf16, softcap 50)
    on 5000 tokens, so the local layer's 4096-token window masks: one flash
    launch, within 2e-2 of max |y| of the same layer with the plain
    attention."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    from repro_torch.configs import get_config
    from repro_torch.models import BlockDesc, init_params
    from repro_torch.models import layers as L

    cfg = get_config("gemma2-2b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = init_params(L.spec_attention(cfg), gen)
    S = 5000
    x = torch.randn(1, S, cfg.d_model, generator=gen, device="cuda"
                    ).to(torch.bfloat16)
    pos = torch.arange(S, device="cuda")[None]
    desc = BlockDesc(kind="attn", window=window)
    before = FLASH_LAUNCHES.count
    y = L.attention(cfg, p, x, desc, pos)
    assert FLASH_LAUNCHES.count == before + 1
    want = L.attention(cfg, p, x, desc, pos, attn_op=flash_attention_plain)
    scale = float(want.float().abs().max())
    torch.testing.assert_close(y.float(), want.float(), atol=2e-2 * scale,
                               rtol=2e-2)


@pytest.mark.cuda
def test_cuda_whisper_encoder_layer_matches_plain():
    """One whisper-medium encoder layer at full width (d_model 1024, 16
    heads of dim 64, gelu) on its 1500 frames -- non-causal attention whose
    kv tail no tile divides -- and one decoder layer cross-attending from
    448 tokens onto the plain encoder's output: one flash launch each,
    within 2e-2 of max |out| of the same layers with the plain attention.
    The weights take std 1 / sqrt(fan-in): the reference's init rule takes
    the fan-in of a one-layer stack as 1, and at std 1 the scores reach
    10^3, where the two versions' f32 roundings already pick different
    keys."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    from repro_torch.configs import get_config
    from repro_torch.models import Model, init_params
    from repro_torch.models import transformer as T

    cfg = get_config("whisper-medium").replace(n_layers=1, encoder_layers=1)
    enc_cfg = Model(cfg, device="cpu").encoder_cfg()
    gen = torch.Generator(device="cuda").manual_seed(0)
    enc = init_params({"blocks": T.stack_specs(enc_cfg),
                       "final_norm": Model(cfg, device="cpu").specs()[
                           "encoder"]["final_norm"]}, gen)
    dec = init_params({"blocks": T.stack_specs(cfg),
                       "final_norm": T.model_specs(cfg)["final_norm"]}, gen)
    for w in list(enc["blocks"]["pos0"].values()) \
            + list(dec["blocks"]["pos0"].values()):
        if w.ndim == 3:                      # (layers, fan-in, fan-out)
            w.mul_(w.shape[1] ** -0.5)
    frames = (torch.randn(2, cfg.encoder_seq, cfg.d_model, generator=gen,
                          device="cuda") * 0.02).to(torch.bfloat16)
    x = (torch.randn(2, 448, cfg.d_model, generator=gen, device="cuda")
         * 0.02).to(torch.bfloat16)
    want_out, _ = T.forward(enc_cfg, enc, frames, causal=False,
                            attn_op=flash_attention_plain)
    want_h, _ = T.forward(cfg, dec, x, enc_out=want_out,
                          attn_op=flash_attention_plain)
    before = FLASH_LAUNCHES.count
    out, _ = T.forward(enc_cfg, enc, frames, causal=False)
    h, _ = T.forward(cfg, dec, x, enc_out=want_out)
    assert FLASH_LAUNCHES.count == before + 3
    for a, b in ((out, want_out), (h, want_h)):
        scale = float(b.float().abs().max())
        torch.testing.assert_close(a.float(), b.float(), atol=2e-2 * scale,
                                   rtol=2e-2)


def _counting_timer(hw=None):
    """``CudaEventTimer`` counting its ``probe_rows`` calls."""
    from repro_torch.core import CudaEventTimer

    class Counting(CudaEventTimer):
        calls = 0

        def probe_rows(self, table, rng, repeats=1):
            self.calls += 1
            return super().probe_rows(table, rng, repeats)

    return Counting(hw)


@pytest.mark.cuda
def test_cuda_probe_during_capture_is_deferred(tmp_path, monkeypatch):
    """A decision made inside a CUDA-graph capture with the telemetry loop
    installed over ``CudaEventTimer``: the capture records the one matmul
    launch and nothing of the probe, the probe is queued and runs once the
    capture has ended, and the replay equals the eager call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    from repro_torch.core import HopperModel, Klaraptor, registry
    from repro_torch.serving.graphs import StepGraph
    from repro_torch.telemetry import Telemetry, TelemetryConfig

    monkeypatch.setenv("KLARAPTOR_CACHE_DIR", str(tmp_path / "cache"))
    registry.clear()
    timer = _counting_timer()
    spec = matmul_spec(4)
    Klaraptor(HopperModel(timer.hw), hw=timer.hw, cache=False).build_driver(
        spec, repeats=1, max_configs_per_size=8)        # registered
    tel = Telemetry([spec], timer, cache=False, config=TelemetryConfig(
        probe_every=1, refit_enabled=False)).install()
    try:
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn(512, 1024, generator=gen, device="cuda")
        y = torch.randn(1024, 256, generator=gen, device="cuda")
        step = StepGraph(lambda: ops.matmul(x, y), torch.device("cuda"))
        eager = step().clone()          # the eager call, then the capture
        assert timer.calls == 1         # the eager call's probe
        assert tel.deferred_total == 1 and tel.deferred_run_total == 0
        assert step.launches == {"matmul": 1}
        with torch.cuda.stream(step.stream):
            assert tel.drain_deferred() == 1
        assert timer.calls == 2 and not tel._deferred
        assert torch.equal(step(), eager)
        assert tel.counters.shadow_probes_total == 2
    finally:
        tel.uninstall()
        registry.clear()


@pytest.mark.cuda
def test_cuda_escalation_searches_on_the_card(tmp_path, monkeypatch):
    """``choose_or_default(..., spec=, device=CudaEventTimer)`` on a shape
    no driver decides: a small budget finds a feasible ``matmul_b32`` tile,
    and a repeat is served from the memo without a probe."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    from repro_torch.core import registry
    from repro_torch.core.driver import choose_or_default
    from repro_torch.search import SearchBudget

    monkeypatch.setenv("KLARAPTOR_CACHE_DIR", str(tmp_path / "cache"))
    registry.clear()
    timer = _counting_timer()
    spec, D = matmul_spec(4), {"m": 1024, "n": 1024, "k": 1024}
    default = {"bm": -1, "bn": -1, "bk": -1}
    budget = SearchBudget(max_executions=12)
    cfg = choose_or_default(spec.name, D, default, spec=spec, device=timer,
                            budget=budget)
    table = spec.candidates(D, timer.hw)
    assert cfg in [table.row(i) for i in range(len(table))]
    n = timer.calls
    assert n > 0
    assert choose_or_default(spec.name, D, default, spec=spec, device=timer,
                             budget=budget) == cfg
    assert timer.calls == n
    registry.clear()


@pytest.mark.cuda
def test_cuda_two_threads_probes_never_overlap(tmp_path, monkeypatch):
    """Two threads, each with its own ``CudaEventTimer``, probe
    ``matmul_b32`` rows on one card at once: both hold the card's lock,
    once per row, and no two held intervals overlap (the farm's one-card
    contract)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    import threading

    import numpy as np

    from repro_torch.core import CudaEventTimer
    from repro_torch.core.card_lock import (LOG_ENV, largest_overlap,
                                            read_intervals)

    log = tmp_path / "lock.log"
    monkeypatch.setenv(LOG_ENV, str(log))
    spec = matmul_spec(4)
    D = {"m": 512, "n": 512, "k": 512}
    hw = CudaEventTimer().hw
    table = spec.candidates(D, hw)
    tt = spec.traffic_table(D, table, hw).select(np.arange(min(6,
                                                              len(table))))
    errors = []

    def worker(seed):
        try:
            timer = CudaEventTimer(hw, seed=seed)
            for _ in range(4):
                timer.probe_rows(tt, np.random.RandomState(seed), 2)
        except Exception as e:     # surfaced below
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(s,)) for s in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    intervals = read_intervals(log)
    assert len({r["thread"] for r in intervals}) == 2
    assert len(intervals) == 2 * 4 * len(tt)
    assert largest_overlap(intervals) == 0.0


@pytest.mark.cuda
def test_cuda_spawned_worker_completes_a_batch_job(tmp_path):
    """One spawned process worker rebuilds ``CudaEventTimer`` from the job's
    JSON on the card and completes ``batch`` jobs: the merged rows equal a
    single-process collect of the same seed (times differ), and the farm's
    driver lands under the single-process build's key."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    from repro_torch.core import CudaEventTimer, DriverCache, Klaraptor
    from repro_torch.core.collect import collect
    from repro_torch.fleet import (FleetConfig, FleetCoordinator, SpecRef,
                                   collected_rows_equal)

    spec = matmul_spec(4)
    ref = SpecRef("repro_torch.core", "matmul_spec", (("dtype_bytes", 4),))
    probes = [{"m": 256, "n": 256, "k": 256}, {"m": 512, "n": 512, "k": 512}]
    timer = CudaEventTimer()
    single = collect(spec, timer, probe_data=probes, hw=timer.hw, repeats=2,
                     max_configs_per_size=4, seed=3)
    cache = DriverCache(str(tmp_path / "cache"))
    with FleetCoordinator(tmp_path / "spool", timer, cache=cache,
                          config=FleetConfig(n_workers=1, backend="process",
                                             job_timeout_s=300)) as fc:
        fb = fc.tune({spec.name: ref}, probe_data=probes, repeats=2,
                     max_configs_per_size=4, seed=3)[spec.name]
        assert fc.stats.by_kind == {"batch": 2}
    assert collected_rows_equal(single, fb.collected) == []
    again = Klaraptor(timer, cache=cache).build_driver(
        spec, probe_data=probes, repeats=2, max_configs_per_size=4, seed=3)
    assert again.from_cache and again.driver.source == fb.driver.source


@pytest.mark.cuda
def test_cuda_device_from_json_refuses_another_card():
    """A job tuned for another card model does not run on this card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    from repro_torch.core import CudaEventTimer
    from repro_torch.fleet import device_from_json, device_to_json

    d = device_to_json(CudaEventTimer(seed=5))
    assert d["kind"] == "cuda_event_timer" and d["seed"] == 5
    back = device_from_json(d)
    assert back.fingerprint() == CudaEventTimer(seed=5).fingerprint()
    with pytest.raises(ValueError, match="tuned for"):
        device_from_json({**d, "hw": "NVIDIA A100-SXM4-80GB"})


@pytest.mark.cuda
def test_cuda_coordinator_refuses_a_timer_of_another_card(tmp_path):
    """A coordinator given a timer tuned for the cc-9.0 table's
    ``h100_sxm_cc90`` on a card that names itself otherwise raises at
    construction, before any worker starts."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    from repro_torch.core import CudaEventTimer, HardwareParams
    from repro_torch.fleet import FleetCoordinator

    assert HardwareParams.from_device().name != H100.name
    with pytest.raises(ValueError, match="tuned for"):
        FleetCoordinator(tmp_path / "spool", CudaEventTimer(H100))
    assert not (tmp_path / "spool").exists()


@pytest.mark.cuda
def test_cuda_timer_retimes_a_late_enqueue():
    """A launch whose host path outlasts the spin before it (here 1 ms of
    host sleep against a ~100 us spin) is timed again behind a spin four
    times as long until the spin covers it (the 6.4 ms spin of the last
    try does, so at least one and at most ``RETIMES`` late windows), and
    the kept time is the kernel's, not the host's millisecond."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    import time

    from repro_torch.core import CudaEventTimer

    timer = CudaEventTimer()
    x = torch.zeros(1024, device="cuda")

    def slow_host(P):
        time.sleep(1e-3)
        return x.add_(1.0)

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    stream = torch.cuda.current_stream()
    timer._time_launch(slow_host, {}, start, end, stream)
    end.synchronize()
    assert 1 <= timer.late <= timer.RETIMES
    assert start.elapsed_time(end) < 0.5        # ms


@pytest.mark.cuda
def test_cuda_flash_backward_kernel_matches_plain():
    """dq, dk and dv of the backward kernel against its plain version on
    the same forward output and lse: bf16 (the wgmma body) and f32 (the
    SIMT body), d 64 and 128, causal and not, GQA 4 and 1, ragged
    lengths; the body each dtype ran, and two calls bit-equal (no atomics);
    the forward's output bit-equal with and without lse, and its lse
    against the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype, d, causal, (hq, hkv), (sq, skv) in itertools.product(
            (torch.bfloat16, torch.float32), (64, 128), (True, False),
            ((4, 1), (2, 2)), ((200, 200), (77, 333), (333, 130))):
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-4
        q = torch.randn(2 * hq, sq, d, generator=gen, device="cuda").to(dtype)
        k = torch.randn(2 * hkv, skv, d, generator=gen, device="cuda").to(dtype)
        v = torch.randn(2 * hkv, skv, d, generator=gen, device="cuda").to(dtype)
        kw = dict(num_q_heads=hq, num_kv_heads=hkv, causal=causal)
        bq, bkv = (64, 64)
        out0 = flash_attention_kernel(q, k, v, bq=bq, bkv=bkv, **kw)
        out, lse = flash_attention_kernel(q, k, v, bq=bq, bkv=bkv,
                                          return_lse=True, **kw)
        assert torch.equal(out, out0)
        torch.testing.assert_close(
            lse, flash_attention_plain(q, k, v, return_lse=True, **kw)[1],
            atol=1e-3, rtol=1e-5)
        dout = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
        ref = flash_attention_backward_plain(q, k, v, out, dout, lse, **kw)
        before = BACKWARD_LAUNCHES.count
        got = flash_attention_backward_kernel(q, k, v, out, dout, lse, **kw)
        again = flash_attention_backward_kernel(q, k, v, out, dout, lse, **kw)
        assert BACKWARD_LAUNCHES.count == before + 2
        ran = BACKWARD_LAUNCHES.tiles[(2 * hq, sq, skv, d, causal)]
        assert ran["body"] == ("wgmma" if dtype == torch.bfloat16
                               else "simt"), ran
        for g, a, r in zip(got, again, ref):
            assert g.dtype == dtype and bool(torch.isfinite(g).all())
            assert torch.equal(g, a), (dtype, d, "not bit-equal")
            err = float((g.float() - r.float()).abs().max())
            assert err <= tol * float(r.float().abs().max()), \
                (dtype, d, causal, hq, hkv, sq, skv, err)


@pytest.mark.cuda
def test_cuda_flash_backward_kernel_takes_softcap_window_and_d256():
    """The backward kernel with the forward's softcap and window against
    its plain version on the forward's output and lse: bf16 (the wgmma
    body, two dK / dV warpgroups at d 256) at d 64, 128 and 256, f32 (the
    SIMT body) at d 64 and 128; causal and not, GQA 2, a ragged length and
    sq > skv (whose rows past skv + window - 1 see no key); windows of 3,
    100 and 4096 (which trims nothing here; a window of 1 would leave each
    causal row its own key alone, where dS is 0 but for rounding); two
    calls bit-equal.  With a softcap, q is scaled so that the scores have
    std softcap / 2, where the cap bends them, the launch records the
    capped kernels, and the plain backward with no cap on the capped lse
    (a kernel that ran its uncapped instantiation) fails the tolerance.
    f32 at d 256 raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    gen = torch.Generator(device="cuda").manual_seed(3)
    for dtype, d, causal, (sq, skv), (window, softcap) in itertools.product(
            (torch.bfloat16, torch.float32), (64, 128, 256), (True, False),
            ((333, 333), (300, 130)),
            ((100, None), (None, 50.0), (100, 30.0), (3, 50.0),
             (4096, 50.0))):
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-4
        q = torch.randn(4, sq, d, generator=gen, device="cuda")
        if softcap:
            q *= softcap / 2            # scores of std softcap / 2
        q = q.to(dtype)
        k = torch.randn(2, skv, d, generator=gen, device="cuda").to(dtype)
        v = torch.randn(2, skv, d, generator=gen, device="cuda").to(dtype)
        kw = dict(num_q_heads=2, num_kv_heads=1, causal=causal,
                  window=window, softcap=softcap)
        out, lse = flash_attention_kernel(q, k, v, bq=64, bkv=64,
                                          return_lse=True, **kw)
        dout = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
        if dtype == torch.float32 and d == 256:
            with pytest.raises(ValueError, match="head dims"):
                flash_attention_backward_kernel(q, k, v, out, dout, lse, **kw)
            continue
        ref = flash_attention_backward_plain(q, k, v, out, dout, lse, **kw)
        got = flash_attention_backward_kernel(q, k, v, out, dout, lse, **kw)
        again = flash_attention_backward_kernel(q, k, v, out, dout, lse, **kw)
        ran = BACKWARD_LAUNCHES.tiles[(4, sq, skv, d, causal)]
        assert ran == {"body": "wgmma" if dtype == torch.bfloat16
                       else "simt", "capped": softcap is not None}, ran
        for g, a, r in zip(got, again, ref):
            assert g.dtype == dtype and bool(torch.isfinite(g).all())
            assert torch.equal(g, a), (dtype, d, "not bit-equal")
            err = float((g.float() - r.float()).abs().max())
            assert err <= tol * max(float(r.float().abs().max()), 1e-30), \
                (dtype, d, causal, sq, skv, window, softcap, err)
        if softcap:
            uncapped = flash_attention_backward_plain(
                q, k, v, out, dout, lse, **{**kw, "softcap": None})
            assert not any(
                float((u.float() - r.float()).abs().max())
                <= tol * float(r.float().abs().max())
                for u, r in zip(uncapped, ref)), (d, causal, window, softcap)


@pytest.mark.cuda
def test_cuda_ops_flash_attention_gradient_goes_through_the_kernels():
    """``ops.flash_attention`` on card tensors that require grad is the
    autograd Function: one forward launch (with lse), one backward launch,
    and gradients that agree with autograd through the plain version; with
    a window and a softcap too, where both launches count as windowed and
    the backward's as capped."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    gen = torch.Generator(device="cuda").manual_seed(2)
    for dtype, extra in itertools.product(
            (torch.bfloat16, torch.float32),
            ({}, dict(window=50, softcap=30.0))):
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-3
        leaves = [torch.randn(b, 200, 64, generator=gen, device="cuda"
                              ).to(dtype).requires_grad_() for b in (8, 2, 2)]
        kw = dict(num_q_heads=4, num_kv_heads=1, causal=True, **extra)
        f0, b0 = FLASH_LAUNCHES.count, BACKWARD_LAUNCHES.count
        fw0 = FLASH_LAUNCHES.windowed.count
        bw0 = BACKWARD_LAUNCHES.windowed.count
        out = ops.flash_attention(*leaves, **kw)
        assert out.requires_grad and FLASH_LAUNCHES.count == f0 + 1
        dout = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
        got = torch.autograd.grad(out, leaves, dout)
        assert BACKWARD_LAUNCHES.count == b0 + 1
        windowed = int("window" in extra)
        assert FLASH_LAUNCHES.windowed.count == fw0 + windowed
        assert BACKWARD_LAUNCHES.windowed.count == bw0 + windowed
        assert BACKWARD_LAUNCHES.tiles[(8, 200, 200, 64, True)]["capped"] \
            == ("softcap" in extra)
        ref = torch.autograd.grad(flash_attention_plain(*leaves, **kw),
                                  leaves, dout)
        for g, r in zip(got, ref):
            err = float((g.float() - r.float()).abs().max())
            assert err <= tol * float(r.float().abs().max()), (dtype, err)
        with torch.no_grad():                  # serving: no Function, no lse
            assert not ops.flash_attention(*leaves, **kw).requires_grad


@pytest.mark.cuda
def test_cuda_ops_without_a_backward_raise_on_grad():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    dev = dict(device="cuda", dtype=torch.bfloat16)
    x = torch.randn(2, 64, 64, **dev, requires_grad=True)
    calls = {
        "matmul": lambda: ops.matmul(x, torch.randn(64, 64, **dev)),
        "layernorm": lambda: ops.layernorm(
            x[0], x[0], torch.ones(64, **dev), torch.zeros(64, **dev)),
        "blocked_colsum": lambda: ops.blocked_colsum(x[0]),
    }
    for name, call in calls.items():
        with pytest.raises(ops.MissingBackwardError, match=name):
            call()
        with torch.no_grad():
            call()                         # serving is unaffected


def _rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def _ssd_inputs(gen, bh, h, s, dh, n, dtype):
    x = (torch.randn(bh, s, dh, generator=gen, device="cuda") * 0.5
         ).to(dtype)
    dt = 0.01 + 0.5 * torch.rand(bh, s, generator=gen, device="cuda")
    B, C = ((torch.randn(bh // h, s, n, generator=gen, device="cuda") * 0.3
             ).to(dtype) for _ in range(2))
    A = -0.5 - torch.rand(bh, generator=gen, device="cuda")
    return x, dt, B, C, A


@pytest.mark.cuda
def test_cuda_ssd_forward_is_bit_equal_with_states():
    """The forward writes each chunk's entering state when asked, and its
    output is the same bits either way; the states match the plain
    version's (wgmma chunks 64 / 128, SIMT f32 and the smoke shape)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    gen = torch.Generator(device="cuda").manual_seed(3)
    for dtype, (bh, h, s, dh, n, chunk) in itertools.product(
            (torch.bfloat16, torch.float32),
            ((48, 24, 300, 64, 128, 64), (24, 24, 256, 64, 128, 128),
             (8, 4, 100, 32, 32, 32))):
        ins = _ssd_inputs(gen, bh, h, s, dh, n, dtype)
        y0 = ssd_scan_kernel(*ins, chunk=chunk)
        y1, states = ssd_scan_kernel(*ins, chunk=chunk, return_states=True)
        _, ref = ssd_scan_plain(*ins, chunk=chunk, return_states=True)
        torch.cuda.synchronize()
        assert torch.equal(y0, y1), (dtype, bh, s, chunk)
        assert _rel(states, ref) <= 1e-4, (dtype, bh, s, chunk)


@pytest.mark.cuda
def test_cuda_ssd_backward_kernel_matches_plain():
    """Each gradient within 2e-2 (bf16) / 2e-4 (f32) x max |plain| at a
    ragged length with several chunks (the chain makes several hops) and B
    and C shared by h rows, two calls bit-equal, and ``ops.ssd_scan`` with
    grad on launching both kernels.  bf16 at (64, 128), chunks 64 and 128,
    runs the wgmma body (and the SIMT body, asked for, agrees too); f32 and
    (32, 32) the SIMT body: ``BACKWARD_LAUNCHES`` records which ran."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    gen = torch.Generator(device="cuda").manual_seed(4)
    for dtype, (bh, h, s, dh, n, chunk) in itertools.product(
            (torch.bfloat16, torch.float32),
            ((48, 24, 300, 64, 128, 64), (48, 24, 300, 64, 128, 128),
             (8, 4, 100, 32, 32, 32))):
        ins = _ssd_inputs(gen, bh, h, s, dh, n, dtype)
        _, states = ssd_scan_kernel(*ins, chunk=chunk, return_states=True)
        dy = torch.randn(bh, s, dh, generator=gen, device="cuda").to(dtype)
        got = ssd.ssd_scan_backward_kernel(*ins, states, dy, chunk=chunk)
        body = ssd.BACKWARD_LAUNCHES.tiles[(bh, s, dh, n)]["body"]
        again = ssd.ssd_scan_backward_kernel(*ins, states, dy, chunk=chunk)
        ref = ssd.ssd_scan_backward_plain(*ins, states, dy, chunk)
        torch.cuda.synchronize()
        wgmma = dtype == torch.bfloat16 and (dh, n) == (64, 128)
        assert body == ("sm90" if wgmma else "simt"), (dtype, dh, n, body)
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-4
        for g, a, r in zip(got, again, ref):
            assert torch.equal(g, a)
            assert bool(torch.isfinite(g).all()) and _rel(g, r) <= tol
        if wgmma:
            simt = ssd.ssd_scan_backward_kernel(*ins, states, dy, chunk=chunk,
                                                body="simt")
            torch.cuda.synchronize()
            assert ssd.BACKWARD_LAUNCHES.tiles[(bh, s, dh, n)]["body"] == \
                "simt"
            for g, r in zip(simt, ref):
                assert _rel(g, r) <= tol
    leaves = [t.requires_grad_() for t in _ssd_inputs(
        gen, 48, 24, 256, 64, 128, torch.bfloat16)]
    f0, b0 = SSD_LAUNCHES.count, ssd.BACKWARD_LAUNCHES.count
    y = ops.ssd_scan(*leaves)
    torch.autograd.grad(y, leaves, torch.ones_like(y))
    assert SSD_LAUNCHES.count == f0 + 1
    assert ssd.BACKWARD_LAUNCHES.count == b0 + 1
    assert ssd.BACKWARD_LAUNCHES.tiles[(48, 256, 64, 128)]["body"] == "sm90"


@pytest.mark.cuda
def test_cuda_moe_gmm_backward_kernel_matches_plain():
    """The bf16 backward body (``csrc/gmm_bwd_sm90.cuh``) at every compiled
    (bm, bn) of each product, each at the rule's CTA count, at one CTA (a
    CTA walks every tile, its ring running across their k steps), at five
    (an uneven share) walking n tiles fastest and walking m tiles fastest,
    all bit-equal to one another and within 2e-2 x max |plain|, with no
    spilled bytes; the rule's launch at g 192 (three 64-row warpgroups, 3 k
    steps in dw) and at k 2048 in dx; two f32 SIMT tiles at 2e-4; two calls
    bit-equal; and ``ops.moe_gmm`` with grad on at a shape that needs
    padding launching both kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    gen = torch.Generator(device="cuda").manual_seed(5)

    def inputs(e, g, k, n, dtype):
        x = torch.randn(e, g, k, generator=gen, device="cuda").to(dtype)
        w = (torch.randn(e, k, n, generator=gen, device="cuda") * 0.05
             ).to(dtype)
        dy = torch.randn(e, g, n, generator=gen, device="cuda").to(dtype)
        return x, w, dy

    # every tile divides (e 2, g 384, k 768, n 256) in both products
    x, w, dy = inputs(2, 384, 768, 256, torch.bfloat16)
    ref = gmm.moe_gmm_backward_plain(x, w, dy)
    for product, i in (("dx", 0), ("dw", 1)):
        for bm, bn in gmm.BACKWARD_SM90_TILES:
            attrs = gmm.backward_attributes(product, bm, bn)
            assert attrs["local_bytes"] == 0, (product, bm, bn, attrs)
            assert attrs["smem_bytes"] == gmm.backward_smem_bytes(bm, bn)
            first = None
            for extra in ({}, {"ctas": 1}, {"ctas": 5, "n_fast": 1},
                          {"n_fast": 0}):
                t = {"bm": bm, "bn": bn, **extra}
                got = gmm.moe_gmm_backward_kernel(
                    x, w, dy, products=(product,), **{product + "_tiles": t})
                torch.cuda.synchronize()
                assert got[1 - i] is None
                if first is None:
                    first = got[i]
                    assert _rel(first, ref[i]) <= 2e-2, (product, t)
                else:
                    assert torch.equal(got[i], first), (product, t)
    for e, g, k, n in ((2, 192, 512, 256), (2, 128, 256, 2048)):
        x, w, dy = inputs(e, g, k, n, torch.bfloat16)
        ref = gmm.moe_gmm_backward_plain(x, w, dy)
        got = gmm.moe_gmm_backward_kernel(x, w, dy)
        again = gmm.moe_gmm_backward_kernel(x, w, dy)
        torch.cuda.synchronize()
        tiles = gmm.BACKWARD_LAUNCHES.tiles[(e, g, k, n)]
        assert tiles == {p: tuple(t.values()) for p, t in
                         gmm.backward_tiles(e, g, k, n, torch.cuda.
                                            get_device_properties(0).
                                            multi_processor_count).items()}
        for a, b, r in zip(got, again, ref):
            assert torch.equal(a, b)
            assert _rel(a, r) <= 2e-2, (e, g, k, n)
    x, w, dy = inputs(2, 256, 512, 256, torch.float32)
    ref = gmm.moe_gmm_backward_plain(x, w, dy)
    for t in ((64, 64, 32), (128, 128, 32)):
        tt = dict(zip(("bg", "bn", "bk"), t))
        got = gmm.moe_gmm_backward_kernel(x, w, dy, dx_tiles=tt, dw_tiles=tt)
        again = gmm.moe_gmm_backward_kernel(x, w, dy, dx_tiles=tt,
                                            dw_tiles=tt)
        torch.cuda.synchronize()
        for a, b, r in zip(got, again, ref):
            assert torch.equal(a, b)
            assert _rel(a, r) <= 2e-4, t
    x = torch.randn(3, 100, 200, generator=gen, device="cuda"
                    ).to(torch.bfloat16).requires_grad_()
    w = torch.randn(3, 200, 96, generator=gen, device="cuda"
                    ).to(torch.bfloat16).requires_grad_()
    f0, b0 = gmm.LAUNCHES.count, gmm.BACKWARD_LAUNCHES.count
    out = ops.moe_gmm(x, w)
    dout = torch.randn(out.shape, generator=gen, device="cuda"
                       ).to(torch.bfloat16)
    got = torch.autograd.grad(out, (x, w), dout)
    assert gmm.LAUNCHES.count == f0 + 1
    assert gmm.BACKWARD_LAUNCHES.count == b0 + 1
    for a, r in zip(got, gmm.moe_gmm_backward_plain(x.detach(), w.detach(),
                                                    dout)):
        assert _rel(a, r) <= 2e-2
