"""The port's serving engine against the JAX package's, on the CPU.

Both engines serve the same converted f32 smoke llama3.2-1b weights (and,
for the leak test, the smoke mamba2-130m's) and the same prompts; the JAX
engine runs without warm start and without step plans.  Greedy outputs must
be identical token for token, through the synchronous loop and through the
async front-end with chunked prefill.  Sampled requests (temperature > 0)
draw from different generators in the two packages, so they are checked
only for their length and finish.  The step builds (``compile_counts``), the
engine's step plan and its refresh, warm start from the driver cache,
bucket accounting and the launcher's flags follow
``tests/test_system.py::TestServing`` and
``tests/test_step_plan.py::TestEngineStepPlan``.  A test checks that the
entry points need a card unless told otherwise.
"""

import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.distributed.sharding import Sharder
from repro.models import Model as RefModel
from repro.serving import sampling as ref_sampling
from repro.serving.engine import Request as RefRequest
from repro.serving.engine import ServingEngine as RefEngine

from repro_torch.configs import get_config
from repro_torch.core import registry
from repro_torch.kernels import ops
from repro_torch.launch import build_engine, make_prefill_step
from repro_torch.models import Model, params_from_reference
from repro_torch.serving import Request, ServingEngine, greedy, sample

SH = Sharder(mesh=None)
SRC = __file__.rsplit("/tests/", 1)[0] + "/src"


@pytest.fixture(scope="module")
def weights():
    jcfg = ref_get_config("llama3.2-1b", smoke=True).replace(
        dtype=jnp.float32)
    jmodel = RefModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config("llama3.2-1b", smoke=True).replace(dtype=torch.float32)
    params = params_from_reference(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    return jmodel, jparams, cfg, params


def _prompts(n, seed=10, vocab=512):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(2, vocab, size=4 + 3 * (i % 5))]
            for i in range(n)]


def _serve(engine, request_cls, prompts, temps, max_new):
    for i, (p, t) in enumerate(zip(prompts, temps)):
        engine.submit(request_cls(rid=i, prompt=list(p),
                                  max_new_tokens=max_new, temperature=t))
    done = engine.run()
    return {r.rid: r for r in done}


@pytest.mark.parametrize("batch,n_req", [(2, 5), (4, 8)])
def test_greedy_outputs_identical_to_reference(weights, batch, n_req):
    jmodel, jparams, cfg, params = weights
    prompts = _prompts(n_req)
    temps = [0.0 if i % 2 == 0 else 0.8 for i in range(n_req)]
    ref = RefEngine(jmodel, jparams, SH, batch=batch, max_seq=48,
                    warm_start=False, step_plans=False)
    ref_done = _serve(ref, RefRequest, prompts, temps, max_new=6)
    port = ServingEngine(Model(cfg, device="cpu"), params, batch=batch,
                         max_seq=48)
    port_done = _serve(port, Request, prompts, temps, max_new=6)
    assert sorted(port_done) == sorted(ref_done) == list(range(n_req))
    for rid, req in port_done.items():
        assert req.done
        theirs = ref_done[rid].output
        if req.temperature <= 0.0:
            assert req.output == theirs, rid
        else:
            stop = len(req.output) == 6 or req.output[-1] == port.eos_id
            assert 1 <= len(req.output) <= 6 and stop
    assert all(r is None for r in port.slot_req) and not port.pending


def test_finishes_on_eos_budget_and_cache_end(weights):
    jmodel, jparams, cfg, params = weights
    model = Model(cfg, device="cpu")
    prompt = _prompts(1, seed=3)[0]
    first = ServingEngine(model, params, batch=1, max_seq=64)
    out = _serve(first, Request, [prompt], [0.0], max_new=5)[0].output
    assert len(out) == 5                       # budget
    eos = out[2]
    stop = out.index(eos) + 1
    eng = ServingEngine(model, params, batch=1, max_seq=64, eos_id=eos)
    assert _serve(eng, Request, [prompt], [0.0], max_new=5)[0].output \
        == out[:stop]                          # EOS
    short = ServingEngine(model, params, batch=1, max_seq=len(prompt) + 2)
    assert len(_serve(short, Request, [prompt], [0.0],
                      max_new=5)[0].output) == 2     # end of the cache


def test_engine_first_token_is_prefill_argmax(weights):
    """The decode path's first token equals the argmax of the prefill
    step's logits on the same prompt."""
    _, _, cfg, params = weights
    model = Model(cfg, device="cpu")
    prompts = _prompts(4, seed=7)
    eng = ServingEngine(model, params, batch=2, max_seq=48)
    done = _serve(eng, Request, prompts, [0.0] * 4, max_new=2)
    step = make_prefill_step(model)
    for rid, p in enumerate(prompts):
        logits = step(params, torch.tensor([p]))
        assert done[rid].output[0] == int(greedy(logits)[0])


def test_sampling_matches_reference_where_it_can():
    logits = np.random.RandomState(0).randn(3, 50).astype(np.float32)
    t = torch.from_numpy(logits)
    np.testing.assert_array_equal(
        greedy(t).numpy(), np.asarray(ref_sampling.greedy(jnp.asarray(logits))))
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(sample(t, gen, temperature=0.0), greedy(t))
    top = torch.topk(t, 3, dim=-1).indices
    for _ in range(20):
        s = sample(t, gen, temperature=1.5, top_k=3)
        assert s.dtype == torch.int32
        assert all(int(s[i]) in top[i].tolist() for i in range(3))


def test_entry_points_need_a_card_unless_told(weights, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("llama3.2-1b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_engine(cfg, batch=1, max_seq=8)
    q = torch.zeros(4, 16, 64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.flash_attention(q, q, q, num_q_heads=4, num_kv_heads=4)
    # Told the CPU, they run (the plain versions).
    eng = build_engine(cfg.replace(dtype=torch.float32), batch=1, max_seq=8,
                       device="cpu")
    eng.submit(Request(rid=0, prompt=[3, 4], max_new_tokens=2))
    assert len(eng.run()[0].output) == 2
    x = torch.zeros(4, 16, 64)
    assert ops.flash_attention(x, x, x, num_q_heads=4,
                               num_kv_heads=4).shape == x.shape


# ---------------------------------------------------------------------------
# The async front-end and chunked prefill (tests/test_system.py::TestServing)
# ---------------------------------------------------------------------------

def _mixed_prompts(n=6):
    return [[2 + (5 * i + j) % 20 for j in range(3 + 4 * i)]
            for i in range(n)]


def _serve_mode(engine, request_cls, prompts, max_new, mode):
    for i, p in enumerate(prompts):
        engine.submit(request_cls(rid=i, prompt=list(p),
                                  max_new_tokens=max_new))
    done = engine.run() if mode == "sync" else engine.run_async()
    return {r.rid: list(r.output) for r in done}


def _ref_async(engine, prompts, max_new):
    """The JAX engine's async front-end until every request finished.  Its
    ``drain`` can return while the scheduler thread prefills a request it
    has taken from the queue (neither queued nor in a slot yet), so
    ``run_async`` may stop the thread early; waiting again covers that
    window (the port counts such a request as work)."""
    for i, p in enumerate(prompts):
        engine.submit(RefRequest(rid=i, prompt=list(p),
                                 max_new_tokens=max_new))
    engine.start()
    try:
        while len(engine.finished) < len(prompts):
            engine.drain(timeout=300)
    finally:
        engine.stop()
    return {r.rid: list(r.output) for r in engine.finished}


@pytest.fixture()
def clean_registry(tmp_path, monkeypatch):
    monkeypatch.setenv("KLARAPTOR_CACHE_DIR", str(tmp_path / "cache"))
    registry.clear()
    yield
    registry.clear()


def test_async_front_end_matches_sync(weights, clean_registry):
    """The async scheduler (chunked pow2 prefill) gives the token-by-token
    sync loop's greedy tokens, and the JAX engine's async front-end gives
    the same, from one decode-step build across mixed prompt lengths; the
    port builds the chunk sizes the JAX engine traces."""
    jmodel, jparams, cfg, params = weights
    prompts = _mixed_prompts()
    outs, counts = {}, {}
    for mode in ("sync", "async"):
        engine = build_engine(cfg, batch=2, max_seq=48, params=params,
                              seed=0, prefill_chunk=8, device="cpu")
        outs[mode] = _serve_mode(engine, Request, prompts, 3, mode)
        counts[mode] = dict(engine.compile_counts)
    ref = RefEngine(jmodel, jparams, SH, batch=2, max_seq=48,
                    warm_start=False, step_plans=False, prefill_chunk=8)
    ref_out = _ref_async(ref, prompts, 3)
    assert outs["sync"] == outs["async"] == ref_out
    assert sorted(ref_out) == list(range(6))
    assert counts["sync"] == {"decode_step": 1, "prefill_chunk": 0}
    assert counts["async"]["decode_step"] == 1
    # pow2 chunking: at most log2(prefill_chunk)+1 builds
    assert 1 <= counts["async"]["prefill_chunk"] <= 4
    assert counts["async"] == ref.compile_counts


def test_async_submit_while_running(weights, clean_registry):
    """Requests submitted after start() are picked up by the scheduler
    thread; drain() returns them all."""
    _, _, cfg, params = weights
    engine = ServingEngine(Model(cfg, device="cpu"), params, batch=2,
                           max_seq=32)
    engine.start()
    try:
        for i in range(4):
            engine.submit(Request(rid=i, prompt=[3 + i, 7, 11],
                                  max_new_tokens=2))
        finished = engine.drain(timeout=120)
    finally:
        engine.stop()
    assert sorted(r.rid for r in finished) == [0, 1, 2, 3]
    assert all(1 <= len(r.output) <= 2 for r in finished)
    assert engine.compile_counts["decode_step"] == 1


def test_scheduler_failure_is_raised_not_hung(weights, clean_registry,
                                              monkeypatch):
    """A step that fails in the scheduler thread stops it, and
    ``run_async`` raises instead of waiting forever."""
    _, _, cfg, params = weights
    engine = ServingEngine(Model(cfg, device="cpu"), params, batch=2,
                           max_seq=32)

    def broken(*a, **k):
        raise RuntimeError("step failed")

    monkeypatch.setattr(engine.model, "decode_step", broken)
    engine.submit(Request(rid=0, prompt=[3, 4, 5], max_new_tokens=2))
    with pytest.raises(RuntimeError, match="scheduler thread failed"):
        engine.run_async()
    assert engine._thread is None


@pytest.fixture(scope="module")
def mamba_weights():
    jcfg = ref_get_config("mamba2-130m", smoke=True).replace(
        dtype=jnp.float32)
    jmodel = RefModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config("mamba2-130m", smoke=True).replace(dtype=torch.float32)
    params = params_from_reference(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    return jmodel, jparams, cfg, params


def test_mamba_async_mirrors_reference_leak_included(mamba_weights,
                                                     clean_registry):
    """The smoke mamba through both front-ends, every request greedy: the
    chunked prefill steps every slot as the token-by-token loop does, so
    the recurrent state leaks between slots and requests the same way, and
    the tokens are the JAX async engine's."""
    jmodel, jparams, cfg, params = mamba_weights
    prompts = [[2 + (7 * i + j) % 50 for j in range(2 + 3 * i)]
               for i in range(5)]
    ref = RefEngine(jmodel, jparams, SH, batch=2, max_seq=32,
                    warm_start=False, step_plans=False, prefill_chunk=4)
    ref_out = _ref_async(ref, prompts, 3)
    outs = {}
    for mode in ("sync", "async"):
        engine = build_engine(cfg, batch=2, max_seq=32, params=params,
                              seed=0, prefill_chunk=4, device="cpu")
        outs[mode] = _serve_mode(engine, Request, prompts, 3, mode)
    assert outs["async"] == ref_out == outs["sync"]
    # the leak: through one slot, a request's tokens depend on what the
    # slot served before; only the first matches its run alone
    seq = _serve_mode(build_engine(cfg, batch=1, max_seq=32, params=params,
                                   device="cpu", prefill_chunk=4),
                      Request, prompts, 3, "async")
    alone = [_serve_mode(build_engine(cfg, batch=1, max_seq=32,
                                      params=params, device="cpu",
                                      prefill_chunk=4),
                         Request, [p], 3, "async")[0] for p in prompts]
    assert seq[0] == alone[0]
    assert any(seq[i] != alone[i] for i in range(1, 5))


def test_replacing_the_cache_rebuilds_the_steps(weights, clean_registry):
    _, _, cfg, params = weights
    engine = ServingEngine(Model(cfg, device="cpu"), params, batch=1,
                           max_seq=16)
    engine.submit(Request(rid=0, prompt=[3, 4], max_new_tokens=2))
    first = engine.run()[0].output
    engine.cache = engine.model.init_cache(1, 16)
    engine.finished.clear()
    engine.submit(Request(rid=1, prompt=[3, 4], max_new_tokens=2))
    assert engine.run()[0].output == first
    assert engine.compile_counts["decode_step"] == 2
    assert engine.graph_launches() == {} and engine.captures() == []


def test_dropped_steps_release_their_graphs_keep_their_launches(
        weights, clean_registry):
    """A rebuild releases every built step: ``captures`` forgets them,
    while ``graph_launches`` keeps counting what their replays launched."""
    _, _, cfg, params = weights
    engine = ServingEngine(Model(cfg, device="cpu"), params, batch=1,
                           max_seq=16)

    class Replayed:
        graph = object()

        def launched(self):
            return {"moe_gmm": 6}

    engine._decode, engine._chunks = Replayed(), {4: Replayed()}
    assert len(engine.captures()) == 2
    assert engine.graph_launches() == {"moe_gmm": 12}
    engine._drop_steps()
    assert engine._decode is None and engine._chunks == {}
    assert engine.captures() == []
    assert engine.graph_launches() == {"moe_gmm": 12}
    engine._decode = Replayed()
    assert engine.graph_launches() == {"moe_gmm": 18}


# ---------------------------------------------------------------------------
# Step plans, warm start and buckets in the engine
# (tests/test_step_plan.py::TestEngineStepPlan)
# ---------------------------------------------------------------------------

class TestEngineStepPlan:
    def test_engine_builds_and_refreshes(self, weights, clean_registry):
        """The engine builds its step plan from the model's kernel requests;
        a pinned override makes it stale, and the next step rebuilds the
        plan and the step (a re-capture on the card)."""
        _, _, cfg, params = weights
        engine = build_engine(cfg, batch=2, max_seq=16, params=params,
                              device="cpu")
        plan = engine._step_plan
        assert plan is not None and len(plan) > 0
        assert not plan.stale()
        engine.submit(Request(rid=0, prompt=[3, 5], max_new_tokens=2))
        engine.run()
        assert engine._step_plan is plan
        assert engine.compile_counts["decode_step"] == 1
        # a pinned override lands: the next step rebuilds against it
        some_kernel, some_D = next(iter(plan.table))
        registry.note_override(some_kernel, registry.hw_name(some_kernel),
                               dict(some_D),
                               dict(plan.table[(some_kernel, some_D)]))
        assert plan.stale()
        engine.submit(Request(rid=1, prompt=[3, 5], max_new_tokens=2))
        engine.run()
        assert engine._step_plan is not plan
        assert not engine._step_plan.stale()
        assert engine._step_plan.describe()["sources"]["override"] == 1
        assert engine.compile_counts["decode_step"] == 2

    def test_engine_without_step_plans_skips_plan(self, weights,
                                                  clean_registry):
        _, _, cfg, params = weights
        engine = build_engine(cfg, batch=1, max_seq=8, params=params,
                              device="cpu", step_plans=False)
        assert engine._step_plan is None
        engine.submit(Request(rid=0, prompt=[3, 5], max_new_tokens=2))
        engine.run()
        registry.note_override("flash_attn_d32_causal", "x", {"bh": 1},
                               {"bq": 64, "bkv": 64})
        engine.submit(Request(rid=1, prompt=[3, 5], max_new_tokens=2))
        engine.run()
        assert engine.compile_counts["decode_step"] == 1

    def test_warm_start_reads_a_driver_an_earlier_process_cached(
            self, mamba_weights, clean_registry, tmp_path):
        """A driver that an earlier process tuned and cached is loaded by
        the engine's warm start (the model's SSD spec names it), and the
        step plan resolves the decode step's SSD keys from it."""
        _, _, cfg, params = mamba_weights
        name = ops.ssd_kernel_name(cfg.mamba_head_dim, cfg.ssm_state)
        code = textwrap.dedent(f"""
            from repro_torch.core import (HopperModel, Klaraptor,
                                          ssd_probe_data, ssd_scan_spec)
            spec = ssd_scan_spec({cfg.mamba_head_dim}, {cfg.ssm_state}, 4)
            b = Klaraptor(HopperModel(noise=0.03, seed=7),
                          device="cpu").build_driver(
                spec, repeats=2, max_configs_per_size=16,
                probe_data=ssd_probe_data())
            assert b.driver.kernel == {name!r}
        """)
        import os
        env = dict(os.environ, PYTHONPATH=SRC)
        subprocess.run([sys.executable, "-c", code], check=True, env=env,
                       timeout=300)
        registry.clear()
        cold = ServingEngine(Model(cfg, device="cpu"), params, batch=2,
                             max_seq=64, warm_start=False)
        assert list(cold.warm_started) == [] and registry.get(name) is None
        # a bucket lattice over the SSD: its plan is compiled before the
        # step plan is built, so the step plan is not born stale
        from repro_torch.core import BucketLattice
        lat = BucketLattice.from_axes(name, {
            "bh": [2 * cfg.mamba_heads], "s": [1, 64], "chunkflops": [1]})
        engine = build_engine(cfg, batch=2, max_seq=64, params=params,
                              device="cpu", bucket_lattices={name: lat})
        ws = engine.warm_started
        assert list(ws) == [name] and ws.skipped_no_entry == 0
        assert registry.get(name) is not None
        assert len(engine._bucket_dispatch[name].table) > 0
        assert not engine._step_plan.stale()
        # the lattice's plan covers the decode step's SSD keys (s 1 and
        # max_seq), so the step plan reads them from it
        assert engine._step_plan.describe()["sources"] == {"plan": 2}

    def test_bucket_stats_equal_the_reference(self, weights,
                                              clean_registry):
        """The same traffic through both engines with a bucketed dispatch
        over the decode attention's lattice, built from one hand plan in
        each package: the same hits, misses, steps and padding waste."""
        from repro.core import BucketLattice as RefLattice
        from repro.core.device_plan import BucketedDispatch as RefDispatch
        from repro.core.plan import LaunchPlanTable as RefTable

        from repro_torch.core import (BucketedDispatch, BucketLattice,
                                      LaunchPlanTable)
        from repro_torch.launch.serve import default_bucket_lattices

        jmodel, jparams, cfg, params = weights
        batch, max_seq = 2, 48
        (key, lat), = default_bucket_lattices(cfg, batch, max_seq).items()
        ref_lat = RefLattice.from_axes(key, lat.envelope())
        # plan the buckets up to 16 positions; longer contexts miss
        planned = [b for b in lat.all_buckets()
                   if b["sq"] == b["skv"] <= 16]
        shapes = {d: np.array([b[d] for b in planned])
                  for d in lat.data_params}
        configs = {"bq": np.array([64] * len(planned)),
                   "bkv": np.array([64 if b["sq"] < 8 else 128
                                    for b in planned])}
        table = LaunchPlanTable.build(key, "hw", lat.data_params,
                                      ("bq", "bkv"), shapes, configs)
        ref_table = RefTable.build(key, "hw", lat.data_params,
                                   ("bq", "bkv"), shapes, configs)
        default = dict(ops.FLASH_DEFAULT)
        disp = BucketedDispatch.build(lat, table, default, device="cpu")
        ref_disp = RefDispatch.build(ref_lat, ref_table, default)
        prompts = _prompts(5, seed=4)
        engine = ServingEngine(Model(cfg, device="cpu"), params,
                               batch=batch, max_seq=max_seq,
                               bucket_lattices={key: disp})
        ref = RefEngine(jmodel, jparams, SH, batch=batch, max_seq=max_seq,
                        warm_start=False, step_plans=False,
                        bucket_lattices={key: ref_disp})
        out = _serve_mode(engine, Request, prompts, 6, "sync")
        ref_out = _serve_mode(ref, RefRequest, prompts, 6, "sync")
        assert out == ref_out
        stats, ref_stats = engine.bucket_stats, ref.bucket_stats
        assert stats["hits"] > 0 and stats["misses"] > 0
        assert {k: stats[k] for k in ("hits", "misses", "steps")} == \
            {k: ref_stats[k] for k in ("hits", "misses", "steps")}
        assert stats["waste_sum"] == pytest.approx(ref_stats["waste_sum"],
                                                   rel=1e-12)


# ---------------------------------------------------------------------------
# The launcher's engine flags
# ---------------------------------------------------------------------------

def test_serve_main_async_prefill_chunk_buckets_plans(capsys,
                                                      clean_registry):
    from repro_torch.launch.serve import main

    done = main(["--arch", "llama3.2-1b", "--smoke", "--async",
                 "--prefill-chunk", "8", "--buckets", "--plans",
                 "--device", "cpu", "--requests", "3", "--max-new", "3",
                 "--batch", "2"])
    out = capsys.readouterr().out
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert all(r.done and 1 <= len(r.output) <= 3 for r in done)
    assert "warm start: 0 driver(s) loaded [], 0 plan(s), " in out
    assert ("launch plans: 0 compiled, 0 loaded from cache, 4 skipped "
            "(no driver), 0 plan entries") in out
    assert "step plan: 2 kernel configs frozen at generation" in out
    assert "async front-end: 1 decode-step compile(s), " in out
    assert "prefill-chunk compile(s), chunk=8" in out
    assert "bucket dispatch: 0 hits, " in out
    assert "mean padding waste 0.000" in out
    for rid in range(3):
        assert f"req {rid}: prompt=" in out


def test_serve_main_no_step_plans_builds_no_plan(capsys, clean_registry):
    from repro_torch.launch.serve import main

    done = main(["--arch", "llama3.2-1b", "--smoke", "--no-step-plans",
                 "--device", "cpu", "--requests", "2", "--max-new", "2",
                 "--batch", "2"])
    out = capsys.readouterr().out
    assert len(done) == 2
    assert "warm start: " in out and "step plan:" not in out
    assert "async front-end" not in out and "bucket dispatch" not in out
