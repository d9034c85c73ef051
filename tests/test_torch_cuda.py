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
    """bf16 at d 64 and 128: every compiled wgmma tile; f32, and bf16 at
    d 256: the SIMT tile (32, 64).  Causal, full, window and soft-cap, GQA
    group 4 and 1, and ragged lengths (sq = skv = 200, sq 77 < skv 333,
    sq 333 > skv 130) that no tile divides."""
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
