"""The port's mamba2-130m against the JAX package's, on the CPU.

The smoke mamba2-130m config (2 layers, d_model 128, 8 SSM heads of dim 32,
state 32) in f32: the JAX package initialises its weights,
``params_from_reference`` converts them, and both packages compute on the
same weights and the same seeded tokens.  As for llama
(tests/test_torch_models.py), each tolerance is a fraction of the largest
value of the compared tensor (atol = tol * max|expected|, rtol = tol), since
the weights carry the reference's init fault and both packages sum in f32 in
different orders:

* the mixer layer: tol 1e-5;
* forward hidden states, logits, prefill and decode steps: tol 1e-4, against
  the JAX forward with its chunk-parallel SSD (``use_pallas=False``) and with
  its Pallas kernel in interpret mode (``use_pallas=True``);
* the port's decode against its own forward: 2e-3 absolute, the JAX test's
  bar (tests/test_models.py);
* the serving engines' greedy tokens: identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.distributed.sharding import Sharder
from repro.models import Model as RefModel
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.serving.engine import Request as RefRequest
from repro.serving.engine import ServingEngine as RefEngine

from repro_torch.configs import get_config
from repro_torch.kernels.ssd_scan import ssd_scan_plain
from repro_torch.launch import build_engine, make_prefill_step
from repro_torch.models import Model, params_from_reference, spec_leaves
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving import Request, ServingEngine

SH = Sharder(mesh=None)
TOL = 1e-4
LAYER_TOL = 1e-5
ARCH = "mamba2-130m"


@pytest.fixture(scope="module")
def pair():
    jcfg = ref_get_config(ARCH, smoke=True).replace(dtype=jnp.float32)
    jmodel = RefModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(ARCH, smoke=True).replace(dtype=torch.float32)
    model = Model(cfg, device="cpu")
    params = params_from_reference(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    return jcfg, jmodel, jparams, cfg, model, params


def _tokens(cfg, B=2, S=64, seed=1):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (B, S))


def _close(port, expected, tol=TOL):
    expected = np.asarray(expected, np.float32)
    np.testing.assert_allclose(port.detach().float().numpy(), expected,
                               atol=tol * float(np.abs(expected).max()),
                               rtol=tol)


def test_config_matches_reference_and_sizes():
    for smoke in (False, True):
        mine = get_config(ARCH, smoke=smoke)
        theirs = ref_get_config(ARCH, smoke=smoke)
        for f in mine.__dataclass_fields__:
            if f in ("dtype", "block_pattern"):
                continue
            assert getattr(mine, f) == getattr(theirs, f), f
        assert [b.__dict__ for b in mine.block_pattern] == \
            [b.__dict__ for b in theirs.block_pattern]
        assert mine.dtype == torch.bfloat16
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.mamba_d_inner, cfg.mamba_heads,
            cfg.mamba_head_dim, cfg.ssm_state, cfg.vocab_size) == \
        (24, 768, 1536, 24, 64, 128, 50280)
    count = Model(cfg, device="cpu").param_count()
    assert 0.1e9 <= count <= 0.2e9
    assert count == RefModel(ref_get_config(ARCH)).param_count()


def test_entry_points_need_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config(ARCH)
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_engine(cfg, batch=1, max_seq=8)
    assert Model(cfg, device="cpu").cfg is cfg


def test_conversion_carries_the_mamba_tree():
    """bf16 projections stay bf16 and the f32 leaves stay f32, value for
    value."""
    jcfg = ref_get_config(ARCH, smoke=True)
    jparams = RefModel(jcfg).init(jax.random.PRNGKey(1))
    params = params_from_reference(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    block = params["blocks"]["pos0"]
    for name in ("A_log", "D", "dt_bias", "ssm_norm", "conv_b", "norm"):
        assert block[name].dtype == torch.float32, name
    for name in ("in_proj", "conv_w", "out_proj"):
        assert block[name].dtype == torch.bfloat16, name
    for name, t in block.items():
        np.testing.assert_array_equal(
            t.float().numpy(),
            np.asarray(jparams["blocks"]["pos0"][name], np.float32))


def test_mamba_layer_matches(pair):
    jcfg, _, jparams, cfg, _, params = pair
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["pos0"])
    p = {k: v[0] for k, v in params["blocks"]["pos0"].items()}
    x = np.random.RandomState(3).randn(2, 64, cfg.d_model).astype(np.float32)
    _close(L.mamba(cfg, p, torch.from_numpy(x)),
           RL.mamba(jcfg, jp, jnp.asarray(x), SH), LAYER_TOL)
    xbc = x[:, :, :cfg.mamba_conv_dim // 2]
    w = np.random.RandomState(4).randn(4, xbc.shape[-1]).astype(np.float32)
    b = np.random.RandomState(5).randn(xbc.shape[-1]).astype(np.float32)
    _close(L._causal_conv(*(torch.from_numpy(a) for a in (xbc, w, b))),
           RL._causal_conv(*(jnp.asarray(a) for a in (xbc, w, b))),
           LAYER_TOL)


def test_layer_hands_shared_b_c_to_the_ssd(pair):
    """The layer hands the SSD op B and C as (B, S, n), one per batch row
    shared by its heads, with no per-head copy, and the op's result is the
    one on per-head copies."""
    _, _, _, cfg, _, params = pair
    p = {k: v[0] for k, v in params["blocks"]["pos0"].items()}
    x = torch.from_numpy(
        np.random.RandomState(6).randn(2, 64, cfg.d_model).astype(np.float32))
    seen = []

    def spy(xh, dth, Bs, Cs, Ah):
        seen.append((xh.shape, Bs.shape, Cs.shape))
        per_head = [t.repeat_interleave(cfg.mamba_heads, 0) for t in (Bs, Cs)]
        out = ssd_scan_plain(xh, dth, Bs, Cs, Ah)
        assert torch.equal(out, ssd_scan_plain(xh, dth, *per_head, Ah))
        return out

    y = L.mamba(cfg, p, x, ssd_op=spy)
    ((xs, bs, cs),) = seen
    assert tuple(xs) == (2 * cfg.mamba_heads, 64, cfg.mamba_head_dim)
    assert tuple(bs) == tuple(cs) == (2, 64, cfg.ssm_state)
    torch.testing.assert_close(y, L.mamba(cfg, p, x), rtol=0, atol=0)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_and_unembed_match(pair, use_pallas):
    jcfg, _, jparams, cfg, _, params = pair
    toks = _tokens(cfg, S=256)
    jc = jcfg.replace(use_pallas=use_pallas)
    jx = RT.embed_tokens(jc, jparams, jnp.asarray(toks))
    jh, _ = RT.forward(jc, jparams, jx, SH)
    x = T.embed_tokens(cfg, params, torch.from_numpy(toks))
    h, aux = T.forward(cfg, params, x)
    assert float(aux) == 0.0
    _close(h, jh)
    _close(T.unembed(cfg, params, h), RT.unembed(jc, jparams, jh))


def test_prefill_step_matches_reference_closure(pair):
    """The JAX prefill step is embed -> forward -> unembed of the last
    position; the port's step takes the prompt, at a length no chunk
    divides, and hands each layer's SSD to ``ssd_op`` when given one."""
    jcfg, _, jparams, cfg, model, params = pair
    toks = _tokens(cfg, S=77, seed=4)
    jx = RT.embed_tokens(jcfg, jparams, jnp.asarray(toks))
    jh, _ = RT.forward(jcfg, jparams, jx, SH)
    expected = RT.unembed(jcfg, jparams, jh[:, -1])
    logits = make_prefill_step(model)(params, torch.from_numpy(toks))
    assert logits.shape == (2, cfg.padded_vocab)
    assert logits.dtype == torch.float32
    _close(logits, expected)
    calls = []

    def recording(x, dt, B, C, A):
        calls.append(tuple(x.shape) + (B.shape[-1],))
        return ssd_scan_plain(x, dt, B, C, A, chunk=32)

    hooked = make_prefill_step(model, ssd_op=recording)(
        params, torch.from_numpy(toks))
    assert calls == [(2 * cfg.mamba_heads, 77, cfg.mamba_head_dim,
                      cfg.ssm_state)] * cfg.n_layers
    _close(hooked, expected)


def test_decode_steps_match_reference_and_forward(pair):
    jcfg, jmodel, jparams, cfg, model, params = pair
    B, S = 2, 12
    toks = _tokens(cfg, B, S, seed=5)
    jcache = jmodel.init_cache(B, S)
    cache = model.init_cache(B, S)
    h, _ = T.forward(cfg, params, T.embed_tokens(cfg, params,
                                                 torch.from_numpy(toks)))
    full = T.unembed(cfg, params, h)
    errs = []
    for t in range(S):
        pos = np.full((B,), t, np.int32)
        jl, jcache = jmodel.decode_step(jparams, jnp.asarray(toks[:, t]),
                                        jnp.asarray(pos), jcache, SH)
        lg, cache = model.decode_step(params, torch.from_numpy(toks[:, t]),
                                      torch.from_numpy(pos), cache)
        _close(lg, jl)
        errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) < 2e-3, errs
    for name in ("conv", "ssm"):
        _close(cache["pos0"][name], jcache["pos0"][name])


def test_sequential_prefill_matches_reference(pair):
    jcfg, jmodel, jparams, cfg, model, params = pair
    toks = _tokens(cfg, 2, 7, seed=6)
    jl, _ = jmodel.prefill(jparams, jnp.asarray(toks),
                           jmodel.init_cache(2, 16), SH)
    lg, _ = model.prefill(params, torch.from_numpy(toks),
                          model.init_cache(2, 16))
    _close(lg, jl)
    np.testing.assert_allclose(
        lg.numpy(), make_prefill_step(model)(params,
                                             torch.from_numpy(toks)).numpy(),
        atol=2e-3, rtol=0)


def test_kernel_requests_and_cache_specs_match_reference():
    for smoke in (True, False):
        jcfg = ref_get_config(ARCH, smoke=smoke)
        cfg = get_config(ARCH, smoke=smoke)
        mine = T.decode_kernel_requests(cfg, batch=4, max_seq=256)
        theirs = RT.decode_kernel_requests(jcfg, batch=4, max_seq=256)
        assert [(r.kernel, r.D, r.default) for r in mine] == \
            [(r.kernel, r.D, r.default) for r in theirs]
        jc = RT.init_cache_specs(jcfg, 4, 256)
        c = T.init_cache_specs(cfg, 4, 256)
        assert {k: s.shape for k, s in spec_leaves(c)} == \
            {f"pos0/{k}": jc["pos0"][k].shape for k in ("conv", "ssm")}
        assert c["pos0"]["conv"].dtype == torch.bfloat16
        assert c["pos0"]["ssm"].dtype == torch.float32


def _prompts(n, seed=10, vocab=512, lengths=None):
    rng = np.random.RandomState(seed)
    lengths = lengths or [4 + 3 * (i % 5) for i in range(n)]
    return [[int(t) for t in rng.randint(2, vocab, size=k)] for k in lengths]


def _serve(engine, request_cls, prompts, max_new, temps=None):
    temps = temps or [0.0] * len(prompts)
    for i, (p, t) in enumerate(zip(prompts, temps)):
        engine.submit(request_cls(rid=i, prompt=list(p),
                                  max_new_tokens=max_new, temperature=t))
    return {r.rid: r for r in engine.run()}


def _ref_engine(jmodel, jparams, batch, max_seq=48):
    return RefEngine(jmodel, jparams, SH, batch=batch, max_seq=max_seq,
                     warm_start=False, step_plans=False)


@pytest.mark.parametrize("batch,n_req", [(1, 4), (2, 5)])
def test_greedy_outputs_identical_to_reference(pair, batch, n_req):
    """Same tokens as the JAX engine, token for token.  Every request is
    greedy: a sampled request's tokens come from another generator in each
    package, and through the state the engines leak between requests (see
    the next test) they would change the greedy requests served after it."""
    _, jmodel, jparams, cfg, model, params = pair
    prompts = _prompts(n_req)
    ref_done = _serve(_ref_engine(jmodel, jparams, batch), RefRequest,
                      prompts, 4)
    port = ServingEngine(model, params, batch=batch, max_seq=48)
    port_done = _serve(port, Request, prompts, 4)
    assert sorted(port_done) == sorted(ref_done) == list(range(n_req))
    for rid, req in port_done.items():
        assert req.done and req.output == ref_done[rid].output, rid
    assert all(r is None for r in port.slot_req) and not port.pending


def test_sampled_requests_finish(pair):
    _, _, _, cfg, model, params = pair
    prompts = _prompts(6, seed=12)
    temps = [0.0 if i % 2 == 0 else 0.8 for i in range(6)]
    eng = ServingEngine(model, params, batch=4, max_seq=48)
    done = _serve(eng, Request, prompts, 5, temps)
    assert sorted(done) == list(range(6))
    for req in done.values():
        stop = len(req.output) == 5 or req.output[-1] == eng.eos_id
        assert req.done and 1 <= len(req.output) <= 5 and stop


def test_recurrent_state_leaks_between_requests_as_in_reference(pair):
    """The engines never reset a freed slot's conv and SSM states, so a
    request's tokens depend on what the slot served before: with 2-token
    prompts the conv window still holds the previous request's inputs.  The
    port reproduces the JAX engine, leak included; only the first request
    of a batch-1 engine matches its run alone."""
    _, jmodel, jparams, cfg, model, params = pair
    prompts = _prompts(4, seed=11, lengths=[2] * 4)
    ref_seq = _serve(_ref_engine(jmodel, jparams, 1), RefRequest, prompts, 3)
    port_seq = _serve(ServingEngine(model, params, batch=1, max_seq=48),
                      Request, prompts, 3)
    alone = [_serve(ServingEngine(model, params, batch=1, max_seq=48),
                    Request, [p], 3)[0].output for p in prompts]
    ref_alone = [_serve(_ref_engine(jmodel, jparams, 1), RefRequest, [p],
                        3)[0].output for p in prompts]
    assert [port_seq[i].output for i in range(4)] == \
        [ref_seq[i].output for i in range(4)]
    assert alone == ref_alone
    assert port_seq[0].output == alone[0]
    assert any(port_seq[i].output != alone[i] for i in range(1, 4))
