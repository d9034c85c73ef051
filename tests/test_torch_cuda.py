"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc and skip without one.  The file
imports no JAX (the machine with the card has none), so on that machine

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

runs them.  Tolerances: 2e-2 abs and rel in bf16; in f32 2e-4 for the
matmul, the grouped matmul, the layernorm and the column sum, 2e-3 abs /
1e-3 rel for flash attention and 5e-3 abs / 1e-3 rel for the SSD scan
(tests/test_kernels.py's tolerances for each kernel).
"""

import itertools

import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import layernorm as ln
from repro_torch.kernels import moe_gmm as gmm
from repro_torch.kernels import reduce as cs
from repro_torch.kernels.flash_attention import LAUNCHES as FLASH_LAUNCHES
from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                 flash_attention_plain)
from repro_torch.core import H100, matmul_spec, moe_gmm_spec
from repro_torch.core.kernel_spec import (FLASH_SM90_TILES, SM90_TILES,
                                          flash_uses_sm90, ssd_scan_spec)
from repro_torch.kernels.matmul import LAUNCHES as MATMUL_LAUNCHES
from repro_torch.kernels.matmul import OUT_DTYPES, matmul_kernel, matmul_plain
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
