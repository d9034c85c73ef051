"""The port's MoE layer and qwen3-moe-235b against the JAX package's, on the
CPU.

The smoke qwen3-moe config (2 layers, d_model 128, 8 experts, top-2, expert
d_ff 128, qk-norm): the JAX package initialises its weights,
``params_from_reference`` converts them, and both packages compute on the
same weights and the same numpy-seeded inputs.  The JAX MoE layer runs as it
is (its expert products are ``einsum``s, no Pallas kernel); the port's runs
its expert products through ``ops.moe_gmm``, whose CPU path is the plain
grouped matmul.  Tolerances are fractions of the largest value of the
compared tensor (atol = tol * max|expected|, rtol = tol):

* the MoE layer in f32: 1e-5, the aux loss 1e-6 absolute, the top-k
  experts equal -- after a check that the k-th and (k+1)-th router
  probabilities of every token differ by a factor of at least
  exp(``MARGIN``) (their logs ``MARGIN`` apart: both packages' f32 routers
  agree far closer than that), since top-k breaks ties differently in the
  two packages;
* the MoE layer in bf16: 2e-2;
* the model's forward, aux, prefill step and decode steps: 1e-4, the dense
  llama's tolerance (tests/test_torch_models.py), with the routing margin
  checked at every MoE layer the port's forward runs;
* the engine's greedy tokens: identical.
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

from repro_torch.configs import REGISTRY, get_config
from repro_torch.core import (HopperModel, Klaraptor, gmm_probe_data,
                              moe_gmm_spec, register_driver, registry,
                              set_choice_listener)
from repro_torch.core.step_plan import build_step_plan, use_step_plan
from repro_torch.kernels import ops
from repro_torch.kernels.moe_gmm import moe_gmm_plain
from repro_torch.launch import make_prefill_step
from repro_torch.models import (Model, init_params, params_from_reference,
                                spec_leaves)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving import Request, ServingEngine

ARCH = "qwen3-moe-235b-a22b"
SH = Sharder(mesh=None)
TOL = 1e-4
LAYER_TOL = 1e-5
BF16_TOL = 2e-2
MARGIN = 1e-4


def _pair(dtype):
    jcfg = ref_get_config(ARCH, smoke=True).replace(dtype=dtype)
    jmodel = RefModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    cfg = get_config(ARCH, smoke=True).replace(dtype=tdtype)
    model = Model(cfg, device="cpu")
    params = params_from_reference(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    return jcfg, jmodel, jparams, cfg, model, params


@pytest.fixture(scope="module")
def pair():
    return _pair(jnp.float32)


@pytest.fixture(scope="module")
def pair_bf16():
    return _pair(jnp.bfloat16)


@pytest.fixture()
def clean(tmp_path, monkeypatch):
    monkeypatch.setenv("KLARAPTOR_CACHE_DIR", str(tmp_path / "cache"))
    registry.clear()
    set_choice_listener(None)
    yield
    registry.clear()
    set_choice_listener(None)


@pytest.fixture()
def margins(monkeypatch):
    """Record the top-k margin of every routing the port makes."""
    seen = []
    route = L.moe_route

    def recording(cfg, p, xg):
        probs, gate, expert = route(cfg, p, xg)
        top = torch.topk(probs, cfg.top_k + 1, dim=-1).values.log()
        seen.append(float((top[..., -2] - top[..., -1]).min()))
        return probs, gate, expert

    monkeypatch.setattr(L, "moe_route", recording)
    return seen


def _tokens(cfg, B=2, S=64, seed=1):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (B, S))


def _close(port, expected, tol=TOL):
    expected = np.asarray(expected, np.float32)
    np.testing.assert_allclose(port.detach().float().numpy(), expected,
                               atol=tol * float(np.abs(expected).max()),
                               rtol=tol)


def _block0(jparams, params):
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["pos0"])
    p = {k: v[0] for k, v in params["blocks"]["pos0"].items()}
    return jp, p


def _ref_route(jcfg, jp, x):
    """The JAX router's probabilities and top-k experts of x (B, S, d)."""
    xg = jnp.asarray(x).reshape(-1, x.shape[-1])
    logits = jnp.einsum("td,de->te", xg, jp["router"].astype(xg.dtype),
                        preferred_element_type=jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, expert = jax.lax.top_k(probs, jcfg.top_k)
    return np.asarray(probs), np.asarray(expert)


def _check_margin(probs, k):
    top = np.log(-np.sort(-probs.astype(np.float64), axis=-1))
    assert float((top[:, k - 1] - top[:, k]).min()) > MARGIN


def _moe_input(cfg, dtype=np.float32, B=2, S=64, seed=3):
    x = np.random.RandomState(seed).randn(B, S, cfg.d_model)
    return x.astype(dtype)


# ---------------------------------------------------------------------------
# config and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_matches_reference(smoke):
    mine = get_config(ARCH, smoke=smoke)
    theirs = ref_get_config(ARCH, smoke=smoke)
    for f in mine.__dataclass_fields__:
        if f in ("dtype", "block_pattern"):
            continue
        assert getattr(mine, f) == getattr(theirs, f), f
    assert [b.__dict__ for b in mine.block_pattern] == \
        [b.__dict__ for b in theirs.block_pattern]
    assert mine.dtype == torch.bfloat16
    assert ARCH in REGISTRY


def test_moe_config_fields_match_reference():
    """The MoE fields of the port's ModelConfig and their defaults."""
    from repro.models.config import ModelConfig as RefConfig

    from repro_torch.models import ModelConfig
    for f in ("n_experts", "top_k", "moe_d_ff", "capacity_factor",
              "router_aux_coef", "moe_group"):
        assert ModelConfig.__dataclass_fields__[f].default == \
            RefConfig.__dataclass_fields__[f].default, f


def test_spec_moe_matches_reference():
    for smoke in (False, True):
        cfg = get_config(ARCH, smoke=smoke)
        mine = L.spec_moe(cfg)
        theirs = RL.spec_moe(ref_get_config(ARCH, smoke=smoke))
        assert sorted(mine) == sorted(theirs)
        for k, s in mine.items():
            js = theirs[k]
            assert (s.shape, s.axes, s.init, s.init_scale) == \
                (js.shape, js.axes, js.init, js.init_scale), k
            assert str(s.dtype).split(".")[-1] == jnp.dtype(js.dtype).name
    full = L.spec_moe(get_config(ARCH))
    assert full["we_gate"].shape == (128, 4096, 1536)
    assert full["we_down"].shape == (128, 1536, 4096)
    assert full["router"].dtype == torch.float32


def test_init_follows_the_reference_rule():
    """Stacked MoE leaves take std 1/sqrt(n_groups), the reference's
    fan-in fault, router and experts alike."""
    cfg = get_config(ARCH, smoke=True)
    specs = dict(spec_leaves(T.model_specs(cfg)))
    jspecs = RefModel(ref_get_config(ARCH, smoke=True)).specs()
    jleaves = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda s: hasattr(s, "initializer"))[0]
    assert sorted(specs) == sorted("/".join(k.key for k in path)
                                   for path, _ in jleaves)
    vals = init_params(T.model_specs(cfg), torch.Generator().manual_seed(0))
    for leaf in ("router", "we_gate", "we_up", "we_down"):
        s = specs[f"blocks/pos0/{leaf}"]
        assert s.std() == pytest.approx(2 ** -0.5)
        t = vals["blocks"]["pos0"][leaf].float()
        assert abs(float(t.std()) / s.std() - 1) < 0.1, leaf
    assert vals["blocks"]["pos0"]["router"].dtype == torch.float32
    assert vals["blocks"]["pos0"]["we_gate"].dtype == torch.bfloat16


@pytest.mark.parametrize("which", ["f32", "bf16"])
def test_conversion_carries_the_moe_tree(pair, pair_bf16, which):
    """The f32 router and the (E, d, f) / (E, f, d) experts convert leaf
    for leaf, bf16 experts exactly."""
    _, _, jparams, cfg, _, params = pair if which == "f32" else pair_bf16
    jb, b = jparams["blocks"]["pos0"], params["blocks"]["pos0"]
    want = torch.float32 if which == "f32" else torch.bfloat16
    assert b["router"].dtype == torch.float32
    for leaf in ("we_gate", "we_up", "we_down"):
        assert b[leaf].dtype == want
    for leaf in ("router", "we_gate", "we_up", "we_down", "mlp_norm"):
        assert tuple(b[leaf].shape) == jb[leaf].shape
        np.testing.assert_array_equal(b[leaf].float().numpy(),
                                      np.asarray(jb[leaf], np.float32))


@pytest.mark.parametrize("n_tokens", [1, 4, 8, 64, 100, 128, 1000, 1024,
                                      4096])
def test_moe_capacity_matches_reference(n_tokens):
    for smoke in (False, True):
        cfg = get_config(ARCH, smoke=smoke)
        jcfg = ref_get_config(ARCH, smoke=smoke)
        assert L.moe_capacity(cfg, n_tokens) == \
            RL.moe_capacity(jcfg, n_tokens)
        for cf in (0.5, 2.0):
            assert L.moe_capacity(cfg.replace(capacity_factor=cf),
                                  n_tokens) == \
                RL.moe_capacity(jcfg.replace(capacity_factor=cf), n_tokens)


def test_moe_groups_of_the_full_config():
    """The expert rows the full model's grouped matmul runs at: a 4096-token
    prefill is 4 groups of 1024 with 80 slots each (320 rows); a 4-token
    decode step one group with the floor of 8 slots."""
    cfg = get_config(ARCH)
    assert L.moe_groups(cfg, 4096) == (4, 1024, 80)
    assert L.moe_groups(cfg, 4) == (1, 4, 8)
    with pytest.raises(ValueError, match="groups"):
        L.moe_groups(cfg, 1500)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_layer_matches_reference(pair, capacity_factor):
    jcfg, _, jparams, cfg, _, params = pair
    jcfg = jcfg.replace(capacity_factor=capacity_factor)
    cfg = cfg.replace(capacity_factor=capacity_factor)
    jp, p = _block0(jparams, params)
    x = _moe_input(cfg)
    probs, jexpert = _ref_route(jcfg, jp, x)
    _check_margin(probs, cfg.top_k)
    _, _, expert = L.moe_route(cfg, p, torch.from_numpy(x).reshape(
        1, -1, cfg.d_model))
    np.testing.assert_array_equal(expert[0].numpy(), jexpert)
    jy, jaux = RL.moe(jcfg, jp, jnp.asarray(x), SH)
    y, aux = L.moe(cfg, p, torch.from_numpy(x))
    assert y.shape == x.shape and y.dtype == torch.float32
    assert aux.dtype == torch.float32 and aux.ndim == 0
    _close(y, jy, LAYER_TOL)
    assert abs(float(aux) - float(jaux)) < 1e-6
    # every (token, choice) pair of rank >= C is dropped
    T_ = x.shape[0] * x.shape[1]
    C = L.moe_capacity(cfg, T_)
    load = np.bincount(jexpert.reshape(-1), minlength=cfg.n_experts)
    dropped = int(np.maximum(load - C, 0).sum())
    if capacity_factor < 1:
        assert dropped > 0, (load, C)


def test_moe_layer_drops_fall_back_to_the_residual(pair):
    """With a capacity below every expert's load each expert keeps its
    first C pairs in token order; a token whose choices were all dropped
    gets a zero MoE output."""
    jcfg, _, jparams, cfg, _, params = pair
    cfg = cfg.replace(capacity_factor=0.05)
    jcfg = jcfg.replace(capacity_factor=0.05)
    jp, p = _block0(jparams, params)
    x = _moe_input(cfg, S=256, seed=5)
    C = L.moe_capacity(cfg, x.shape[0] * x.shape[1])
    y, _ = L.moe(cfg, p, torch.from_numpy(x))
    jy, _ = RL.moe(jcfg, jp, jnp.asarray(x), SH)
    _close(y, jy, LAYER_TOL)
    _, expert = _ref_route(jcfg, jp, x)
    kept = np.zeros(expert.shape, bool)
    seen = np.zeros(cfg.n_experts, int)
    for t in range(expert.shape[0]):
        for j in range(cfg.top_k):
            e = expert[t, j]
            kept[t, j] = seen[e] < C
            seen[e] += 1
    none = ~kept.any(1)
    assert none.any() and kept.any()
    assert not y.reshape(-1, cfg.d_model)[torch.from_numpy(none)].any()


def test_moe_layer_bf16_matches_reference(pair_bf16):
    jcfg, _, jparams, cfg, _, params = pair_bf16
    jp, p = _block0(jparams, params)
    xf = _moe_input(cfg)
    xb = torch.from_numpy(xf).to(torch.bfloat16)
    jx = jnp.asarray(xb.float().numpy(), jnp.bfloat16)
    probs, _ = _ref_route(jcfg, jp, np.asarray(jx))
    _check_margin(probs, cfg.top_k)
    jy, jaux = RL.moe(jcfg, jp, jx, SH)
    y, aux = L.moe(cfg, p, xb)
    assert y.dtype == torch.bfloat16
    _close(y, jy, BF16_TOL)
    assert abs(float(aux) - float(jaux)) < 1e-5


def test_moe_runs_three_grouped_matmuls_on_the_expert_rows(pair):
    """gate, up and down go through ``gmm_op`` at (E, G * C, .), and the
    default op (``ops.moe_gmm``, plain on the CPU) gives the same result
    as passing the plain grouped matmul."""
    jparams, cfg, params = pair[2], pair[3], pair[5]
    _, p = _block0(jparams, params)
    x = torch.from_numpy(_moe_input(cfg))
    calls = []

    def recording(a, w):
        calls.append((tuple(a.shape), tuple(w.shape)))
        return moe_gmm_plain(a, w)

    y, aux = L.moe(cfg, p, x, gmm_op=recording)
    G, _, C = L.moe_groups(cfg, x.shape[0] * x.shape[1])
    E, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    assert calls == [((E, G * C, d), (E, d, f)), ((E, G * C, d), (E, d, f)),
                     ((E, G * C, f), (E, f, d))]
    y2, aux2 = L.moe(cfg, p, x)
    assert torch.equal(y, y2) and torch.equal(aux, aux2)


def test_moe_is_deterministic_and_grouped(pair):
    """Two calls give the same bits; groups of ``moe_group`` tokens route
    and fill their slots independently."""
    jcfg, _, jparams, cfg, _, params = pair
    jp, p = _block0(jparams, params)
    x = _moe_input(cfg, S=64)
    y1, _ = L.moe(cfg, p, torch.from_numpy(x))
    y2, _ = L.moe(cfg, p, torch.from_numpy(x))
    assert torch.equal(y1, y2)
    small = cfg.replace(moe_group=32)
    y, aux = L.moe(small, p, torch.from_numpy(x))
    jy, jaux = RL.moe(jcfg.replace(moe_group=32), jp, jnp.asarray(x), SH)
    _close(y, jy, LAYER_TOL)
    assert abs(float(aux) - float(jaux)) < 1e-6


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_and_aux_match(pair, margins, use_pallas):
    jcfg, _, jparams, cfg, _, params = pair
    toks = _tokens(cfg)
    jc = jcfg.replace(use_pallas=use_pallas)
    jx = RT.embed_tokens(jc, jparams, jnp.asarray(toks))
    jh, jaux = RT.forward(jc, jparams, jx, SH)
    x = T.embed_tokens(cfg, params, torch.from_numpy(toks))
    h, aux = T.forward(cfg, params, x)
    assert len(margins) == cfg.n_layers and min(margins) > MARGIN
    _close(h, jh)
    assert float(jaux) > 0
    assert abs(float(aux) - float(jaux)) < 1e-5
    _close(T.unembed(cfg, params, h), RT.unembed(jc, jparams, jh))


def test_prefill_step_matches_reference_closure(pair, margins):
    jcfg, _, jparams, cfg, model, params = pair
    toks = _tokens(cfg, S=48, seed=4)
    jx = RT.embed_tokens(jcfg, jparams, jnp.asarray(toks))
    jh, _ = RT.forward(jcfg, jparams, jx, SH)
    expected = RT.unembed(jcfg, jparams, jh[:, -1])
    logits = make_prefill_step(model)(params, torch.from_numpy(toks))
    assert min(margins) > MARGIN
    assert logits.shape == (2, cfg.padded_vocab)
    assert logits.dtype == torch.float32
    _close(logits, expected)


def test_prefill_step_takes_a_gmm_op(pair):
    _, _, _, cfg, model, params = pair
    toks = torch.from_numpy(_tokens(cfg, S=16, seed=8))
    calls = []

    def plain(a, w):
        calls.append(tuple(a.shape))
        return moe_gmm_plain(a, w)

    got = make_prefill_step(model, gmm_op=plain)(params, toks)
    assert len(calls) == 3 * cfg.n_layers
    assert torch.equal(got, make_prefill_step(model)(params, toks))


def test_decode_steps_match_reference(pair, margins):
    jcfg, jmodel, jparams, cfg, model, params = pair
    B, S = 2, 10
    toks = _tokens(cfg, B, S, seed=5)
    jcache = jmodel.init_cache(B, S)
    cache = model.init_cache(B, S)
    for t in range(S):
        pos = np.full((B,), t, np.int32)
        jl, jcache = jmodel.decode_step(jparams, jnp.asarray(toks[:, t]),
                                        jnp.asarray(pos), jcache, SH)
        lg, cache = model.decode_step(params, torch.from_numpy(toks[:, t]),
                                      torch.from_numpy(pos), cache)
        _close(lg, jl)
    assert len(margins) == S * cfg.n_layers and min(margins) > MARGIN
    for name in ("k", "v"):
        _close(cache["pos0"][name], jcache["pos0"][name])


def test_decode_steps_match_the_forward_without_drops(pair):
    """Each decode step routes its B tokens as one group, the forward all
    B * S; with capacity for every pair (no drops) a token's MoE output
    does not depend on its group, so the two agree."""
    cfg, params = pair[3].replace(capacity_factor=8.0), pair[5]
    model = Model(cfg, device="cpu")
    B, S = 2, 10
    toks = torch.from_numpy(_tokens(cfg, B, S, seed=5))
    h, _ = T.forward(cfg, params, T.embed_tokens(cfg, params, toks))
    full = T.unembed(cfg, params, h)
    cache = model.init_cache(B, S)
    for t in range(S):
        lg, cache = model.decode_step(params, toks[:, t],
                                      torch.full((B,), t, dtype=torch.int32),
                                      cache)
        _close(lg, full[:, t].numpy())


def test_sequential_prefill_matches_reference(pair):
    jcfg, jmodel, jparams, cfg, model, params = pair
    toks = _tokens(cfg, 2, 7, seed=6)
    jl, _ = jmodel.prefill(jparams, jnp.asarray(toks),
                           jmodel.init_cache(2, 16), SH)
    lg, _ = model.prefill(params, torch.from_numpy(toks),
                          model.init_cache(2, 16))
    _close(lg, jl)


@pytest.mark.parametrize("batch,n_req", [(2, 5), (4, 8)])
def test_engine_greedy_tokens_match_reference(pair, batch, n_req):
    jcfg, jmodel, jparams, cfg, model, params = pair
    rng = np.random.RandomState(10)
    prompts = [[int(t) for t in rng.randint(2, cfg.vocab_size,
                                            size=4 + 3 * (i % 5))]
               for i in range(n_req)]

    def serve(engine, cls):
        for i, pr in enumerate(prompts):
            engine.submit(cls(rid=i, prompt=list(pr), max_new_tokens=6))
        return {r.rid: r for r in engine.run()}

    ref = serve(RefEngine(jmodel, jparams, SH, batch=batch, max_seq=48,
                          warm_start=False, step_plans=False), RefRequest)
    port = serve(ServingEngine(model, params, batch=batch, max_seq=48),
                 Request)
    assert sorted(port) == sorted(ref) == list(range(n_req))
    for rid, req in port.items():
        assert req.done and req.output == ref[rid].output, rid


# ---------------------------------------------------------------------------
# the launch manifest and step plans
# ---------------------------------------------------------------------------

def test_kernel_requests_extend_the_reference_manifest():
    """The non-MoE entries equal the JAX manifest's; the grouped-matmul
    entries come after them, two keys per sequence length at the full
    config (gate and up share one), at the padded rows per expert."""
    for smoke in (False, True):
        cfg = get_config(ARCH, smoke=smoke)
        jcfg = ref_get_config(ARCH, smoke=smoke)
        mine = T.decode_kernel_requests(cfg, batch=4, max_seq=256)
        theirs = RT.decode_kernel_requests(jcfg, batch=4, max_seq=256)
        flash = [(r.kernel, r.D) for r in mine
                 if not r.kernel.startswith("moe_gmm")]
        assert flash == [(r.kernel, r.D) for r in theirs]
        assert not any(r.kernel.startswith("moe_gmm") for r in theirs)
    full = T.decode_kernel_requests(get_config(ARCH), batch=1, max_seq=4096,
                                    seqs=(1, 4096))
    gmm = [dict(r.D) for r in full if r.kernel == "moe_gmm_b16"]
    assert gmm == [{"e": 128, "g": 64, "k": 4096, "n": 1536},
                   {"e": 128, "g": 64, "k": 1536, "n": 4096},
                   {"e": 128, "g": 320, "k": 4096, "n": 1536},
                   {"e": 128, "g": 320, "k": 1536, "n": 4096}]
    assert all(dict(r.default) == ops.GMM_DEFAULT for r in full
               if r.kernel == "moe_gmm_b16")


@pytest.mark.parametrize("seq", [1, 24])
def test_kernel_requests_are_the_keys_a_forward_resolves(pair, clean, seq):
    jcfg, _, _, cfg, model, params = pair
    B = 2
    events = []
    set_choice_listener(events.append)
    toks = torch.from_numpy(_tokens(cfg, B, seq, seed=9))
    make_prefill_step(model)(params, toks)
    set_choice_listener(None)
    resolved = {(e.kernel, tuple(sorted(e.D.items()))) for e in events}
    listed = {(r.kernel, tuple(sorted(dict(r.D).items())))
              for r in T.decode_kernel_requests(cfg, batch=B, max_seq=seq,
                                                seqs=(seq,))}
    assert {k for k in resolved if k[0] == "moe_gmm_b32"} == \
        {k for k in listed if k[0] == "moe_gmm_b32"}
    assert len([e for e in events if e.kernel == "moe_gmm_b32"]) \
        == 3 * cfg.n_layers


@pytest.fixture(scope="module")
def gmm_f32_driver():
    return Klaraptor(HopperModel(noise=0.03, seed=7), device="cpu",
                     cache=False).build_driver(
        moe_gmm_spec(4), probe_data=gmm_probe_data(), repeats=2,
        max_configs_per_size=16, register=False).driver


def test_forward_under_a_step_plan_leaves_the_registry(pair, clean,
                                                       gmm_f32_driver):
    """A step plan built over ``decode_kernel_requests`` resolves every
    grouped-matmul launch of the prefill and of a decode step: no choice
    event, the registry's stats and memo untouched, the same bits as the
    registry-resolved step."""
    _, _, _, cfg, model, params = pair
    register_driver(gmm_f32_driver)
    B, S = 2, 24
    toks = torch.from_numpy(_tokens(cfg, B, S, seed=11))
    step = make_prefill_step(model)
    want = step(params, toks)
    cache = model.init_cache(B, S)
    tok, pos = toks[:, 0], torch.zeros(B, dtype=torch.int32)
    want_dec, _ = model.decode_step(params, tok, pos, cache)
    plan = build_step_plan(T.decode_kernel_requests(cfg, batch=B,
                                                    max_seq=S))
    assert plan.describe()["sources"].get("driver", 0) >= 1
    stats, memo = registry.stats(), registry.memo_size()
    hits = registry.memo_hits()
    events = []
    set_choice_listener(events.append)
    with use_step_plan(plan):
        got = step(params, toks)
        got_dec, _ = model.decode_step(params, tok, pos,
                                       model.init_cache(B, S))
    set_choice_listener(None)
    assert events == [] and registry.stats() == stats
    assert registry.memo_size() == memo and registry.memo_hits() == hits
    assert torch.equal(got, want) and torch.equal(got_dec, want_dec)


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

def test_serve_main_serves_qwen3_moe_on_the_cpu(capsys):
    from repro_torch.launch.serve import main

    done = main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests",
                 "3", "--max-new", "3", "--batch", "2"])
    out = capsys.readouterr().out
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert all(r.done and 1 <= len(r.output) <= 3 for r in done)
    for rid in range(3):
        assert f"req {rid}: prompt=" in out


def test_model_needs_a_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(get_config(ARCH, smoke=True))
