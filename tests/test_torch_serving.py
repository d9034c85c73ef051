"""The port's serving engine against the JAX package's, on the CPU.

Both engines serve the same converted f32 smoke llama3.2-1b weights and the
same prompts; the JAX engine runs without warm start and without step plans
(the port has neither).  Greedy outputs must be identical token for token.
Sampled requests (temperature > 0) draw from different generators in the
two packages, so they are checked only for their length and finish.  A last
test checks that the entry points need a card unless told otherwise.
"""

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
from repro_torch.kernels import ops
from repro_torch.launch import build_engine, make_prefill_step
from repro_torch.models import Model, params_from_reference
from repro_torch.serving import Request, ServingEngine, greedy, sample

SH = Sharder(mesh=None)


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
