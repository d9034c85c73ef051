"""The port's llama model against the JAX package's, on the CPU.

The smoke llama3.2-1b config in f32: the JAX package initialises its
weights, ``params_from_reference`` converts them, and both packages compute
on the same weights and the same seeded tokens.  The weights inherit the
reference's init fault (stacked "scaled" leaves get std 1/sqrt(n_groups) =
0.71 here), so activations reach 10^3: each tolerance is a fraction of the
largest value of the compared tensor (atol = tol * max|expected|, rtol =
tol), since both packages sum in f32 in different orders.

* layers (rmsnorm, rope, attention, mlp): tol 1e-5;
* forward hidden states, logits and decode steps: tol 1e-4, against the JAX
  forward with its plain attention (``use_pallas=False``) and with its
  Pallas kernel in interpret mode (``use_pallas=True``, as the JAX ops
  default); S = 64, which the Pallas path's tiles divide;
* the port's decode against its own forward: 2e-3 absolute, the JAX test's
  bar (tests/test_models.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.distributed.sharding import Sharder
from repro.models import Model as RefModel
from repro.models import init_params as ref_init_params
from repro.models import layers as RL
from repro.models import transformer as RT

from repro_torch.configs import PENDING, get_config
from repro_torch.launch import make_prefill_step
from repro_torch.models import (Model, init_params, params_from_reference,
                                spec_leaves)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

SH = Sharder(mesh=None)
TOL = 1e-4
LAYER_TOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    jcfg = ref_get_config("llama3.2-1b", smoke=True).replace(
        dtype=jnp.float32)
    jmodel = RefModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config("llama3.2-1b", smoke=True).replace(dtype=torch.float32)
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


def _block0(jparams, params):
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["pos0"])
    p = {k: v[0] for k, v in params["blocks"]["pos0"].items()}
    return jp, p


def test_conversion_keeps_tree_shapes_and_values(pair):
    _, _, jparams, _, _, params = pair
    jleaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(jleaves) == len(spec_leaves(T.model_specs(pair[3])))
    for path, a in jleaves:
        t = params
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == a.shape and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))


def test_bf16_conversion_is_exact():
    a = jnp.asarray(np.random.RandomState(0).randn(4, 8), jnp.bfloat16)
    t = params_from_reference({"w": np.asarray(a)}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(a, np.float32))


def test_rmsnorm_and_rope_match(pair):
    jcfg, _, _, cfg, _, _ = pair
    rng = np.random.RandomState(2)
    x = rng.randn(2, 9, 4, 32).astype(np.float32)
    w = rng.randn(32).astype(np.float32) * 0.1
    _close(L.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)),
           RL.rmsnorm(jnp.asarray(x), jnp.asarray(w)), LAYER_TOL)
    pos = np.tile(np.arange(9), (2, 1)) + 100
    _close(L.rope(torch.from_numpy(x), torch.from_numpy(pos), cfg.rope_theta),
           RL.rope(jnp.asarray(x), jnp.asarray(pos), jcfg.rope_theta),
           LAYER_TOL)


def test_attention_and_mlp_layers_match(pair):
    jcfg, _, jparams, cfg, _, params = pair
    jp, p = _block0(jparams, params)
    x = np.random.RandomState(3).randn(2, 64, cfg.d_model).astype(np.float32)
    pos = np.tile(np.arange(64), (2, 1))
    desc = cfg.block_pattern[0]
    jdesc = jcfg.block_pattern[0]
    _close(L.attention(cfg, p, torch.from_numpy(x), desc,
                       torch.from_numpy(pos)),
           RL.attention(jcfg, jp, jnp.asarray(x), SH, jdesc,
                        jnp.asarray(pos)), LAYER_TOL)
    _close(L.mlp(cfg, p, torch.from_numpy(x)),
           RL.mlp(jcfg, jp, jnp.asarray(x), SH), LAYER_TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_and_unembed_match(pair, use_pallas):
    jcfg, _, jparams, cfg, _, params = pair
    toks = _tokens(cfg)
    jc = jcfg.replace(use_pallas=use_pallas)
    jx = RT.embed_tokens(jc, jparams, jnp.asarray(toks))
    jh, _ = RT.forward(jc, jparams, jx, SH)
    x = T.embed_tokens(cfg, params, torch.from_numpy(toks))
    _close(x, jx)
    h, aux = T.forward(cfg, params, x)
    assert float(aux) == 0.0
    _close(h, jh)
    _close(T.unembed(cfg, params, h), RT.unembed(jc, jparams, jh))


def test_prefill_step_matches_reference_closure(pair):
    """The JAX prefill step (launch/steps.py) is embed -> forward ->
    unembed of the last position; the port's step takes the prompt."""
    jcfg, _, jparams, cfg, model, params = pair
    toks = _tokens(cfg, S=48, seed=4)
    jx = RT.embed_tokens(jcfg, jparams, jnp.asarray(toks))
    jh, _ = RT.forward(jcfg, jparams, jx, SH)
    expected = RT.unembed(jcfg, jparams, jh[:, -1])
    logits = make_prefill_step(model)(params, torch.from_numpy(toks))
    assert logits.shape == (2, cfg.padded_vocab)
    assert logits.dtype == torch.float32
    _close(logits, expected)


def test_decode_steps_match_reference_and_forward(pair):
    jcfg, jmodel, jparams, cfg, model, params = pair
    B, S = 2, 10
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
    for name in ("k", "v"):
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


def test_decode_past_the_cache_writes_nothing(pair):
    """A position outside the cache writes nothing, as JAX's one-hot blend."""
    jcfg, jmodel, jparams, cfg, model, params = pair
    jcache = jmodel.init_cache(2, 4)
    cache = model.init_cache(2, 4)
    tok, pos = np.array([3, 4], np.int32), np.array([1, 4], np.int32)
    jl, jcache = jmodel.decode_step(jparams, jnp.asarray(tok),
                                    jnp.asarray(pos), jcache, SH)
    lg, cache = model.decode_step(params, torch.from_numpy(tok),
                                  torch.from_numpy(pos), cache)
    _close(lg, jl)
    _close(cache["pos0"]["k"], jcache["pos0"]["k"])
    assert not torch.any(cache["pos0"]["k"][:, 1])


def test_init_follows_the_reference_rule():
    """Same spec tree, and per-leaf std from the same rule, fan-in fault
    included: stacked "scaled" leaves take 1/sqrt(n_groups)."""
    jcfg = ref_get_config("llama3.2-1b", smoke=True)
    cfg = get_config("llama3.2-1b", smoke=True)
    jspecs = RefModel(jcfg).specs()
    specs = T.model_specs(cfg)
    jleaves = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda s: hasattr(s, "initializer"))[0]
    leaves = dict(spec_leaves(specs))
    assert len(jleaves) == len(leaves)
    jvals = ref_init_params(jspecs, jax.random.PRNGKey(0))
    vals = init_params(specs, torch.Generator().manual_seed(0))
    for path, js in jleaves:
        key = "/".join(k.key for k in path)
        s = leaves[key]
        assert s.shape == js.shape and s.init == js.init and s.axes == js.axes
        a = np.asarray(_get(jvals, path), np.float32)
        t = _get_t(vals, key).float().numpy()
        if s.std() is None:
            np.testing.assert_array_equal(t, a)
            continue
        assert abs(t.std() / a.std() - 1) < 0.1, (key, t.std(), a.std())
        assert abs(a.std() / s.std() - 1) < 0.1, (key, a.std(), s.std())
    wq = leaves["blocks/pos0/wq"]
    assert wq.shape[0] == cfg.n_groups == 2
    assert wq.std() == pytest.approx(2 ** -0.5)


def _get(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def _get_t(tree, key):
    for k in key.split("/"):
        tree = tree[k]
    return tree


def test_configs_match_reference():
    for smoke in (False, True):
        mine = get_config("llama3.2-1b", smoke=smoke)
        theirs = ref_get_config("llama3.2-1b", smoke=smoke)
        for f in mine.__dataclass_fields__:
            if f == "dtype":
                continue
            assert getattr(mine, f) == getattr(theirs, f) or \
                f == "block_pattern", f
        assert [b.__dict__ for b in mine.block_pattern] == \
            [b.__dict__ for b in theirs.block_pattern]
        assert mine.dtype == torch.bfloat16
    assert set(theirs.__dataclass_fields__) - \
        set(mine.__dataclass_fields__) == {"use_pallas"}
    for arch in PENDING:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            get_config(arch)
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_kernel_requests_and_cache_specs_match_reference():
    jcfg = ref_get_config("llama3.2-1b", smoke=True)
    cfg = get_config("llama3.2-1b", smoke=True)
    mine = T.decode_kernel_requests(cfg, batch=4, max_seq=256)
    theirs = RT.decode_kernel_requests(jcfg, batch=4, max_seq=256)
    assert [(r.kernel, r.D) for r in mine] == \
        [(r.kernel, r.D) for r in theirs]
    jc = RT.init_cache_specs(jcfg, 4, 256)
    c = T.init_cache_specs(cfg, 4, 256)
    assert {k: s.shape for k, s in spec_leaves(c)} == \
        {"pos0/k": jc["pos0"]["k"].shape, "pos0/v": jc["pos0"]["v"].shape}


def test_unported_layers_name_their_roadmap_item():
    cfg = get_config("llama3.2-1b", smoke=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        L.spec_moe(cfg)
    for kind in ("vlm", "encdec"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Model(cfg.replace(arch_kind=kind), device="cpu")
