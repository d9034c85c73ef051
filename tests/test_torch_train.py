"""The port's training path against the JAX package's, on the CPU.

The chunked loss, ``Model.train_loss`` and its gradient over every
parameter leaf (the ten architectures' smoke configs), remat, AdamW, the
schedules, the compression, the synthetic stream and its prefetcher, the
checkpoint manager (its on-disk layout read by both packages), three train
steps and the trainer's crash and resume.  Inputs are numpy-seeded and
handed to both packages; the JAX package initialises the weights and
``params_from_reference`` converts them.  Configs are f32 (``replace(dtype=
...)`` in both packages) unless a test says otherwise; the JAX models run
their plain attention (``use_pallas=False``, the reference's training
setting).  Tolerances:

* the loss and the cross-entropy: 1e-5 relative;
* ``train_loss``'s loss and metrics, and each leaf's gradient: max |d| <=
  1e-4 x max |g_ref| per leaf; the bf16 llama case: 2e-2.  The gradients
  are compared on weights whose stacked "scaled" leaves are rescaled to
  std 1 / sqrt(fan-in) (``_fan_in_scaled``, as tests/test_torch_archs.py's
  bf16 test does): on the reference's own init (std 1 / sqrt(n_groups), a
  fault the port mirrors) attention is near one-hot, and the two packages'
  f32 gradients, summed in different orders, differ by up to 4e-4 of max
  |g| (smoke llama's attention norm), against 2e-6 on the rescaled
  weights.  The loss itself is compared on the reference's init too;
* AdamW's f32 leaves after three steps: 1e-6 relative, bf16 state within
  one bf16 ulp; three train steps' metrics and leaves: 1e-4 relative;
* the data stream, the checkpoints and the crash-resumed run: bit-equal.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefManager
from repro.configs import get_config as ref_get_config
from repro.data import Prefetcher as RefPrefetcher
from repro.data import SyntheticConfig as RefSynthConfig
from repro.data import SyntheticStream as RefStream
from repro.distributed.sharding import Sharder
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import Model as RefModel
from repro.models.loss import chunked_cross_entropy as ref_chunked_ce
from repro.models.loss import lm_loss as ref_lm_loss
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import compress as ref_compress
from repro.optim import ef_compress_tree as ref_ef_compress_tree
from repro.optim import warmup_cosine as ref_warmup_cosine
from repro.optim import warmup_linear as ref_warmup_linear
from repro.optim import constant as ref_constant

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_IDS, BF16_OPT_STATE, get_config
from repro_torch.configs.base import ShapePreset
from repro_torch.data import Prefetcher, SyntheticConfig, SyntheticStream
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.launch.train import TrainLoop
from repro_torch.models import Model, params_from_reference, spec_leaves
from repro_torch.models.loss import chunked_cross_entropy, lm_loss
from repro_torch.models.module import ParamSpec
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               adamw_update_, clip_by_global_norm, compress, constant,
                               decompress, ef_compress_tree, ef_update_tree,
                               global_norm, init_error_feedback,
                               stochastic_round, warmup_cosine,
                               warmup_linear)
from repro_torch.tree import tree_leaves, tree_map, tree_paths

SH = Sharder(mesh=None)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _leafwise(port_tree, ref_tree, tol, what=""):
    """max |port - ref| <= tol * max |ref| on every leaf (paths by
    ``keystr``, so the trees are matched by name)."""
    ref = {jax.tree_util.keystr(p): np.asarray(v, np.float32)
           for p, v in jax.tree_util.tree_flatten_with_path(ref_tree)[0]}
    port = dict(tree_paths(port_tree))
    assert sorted(port) == sorted(ref), what
    for path, r in ref.items():
        d = float(np.abs(_np(port[path]) - r).max())
        scale = float(np.abs(r).max())
        assert d <= tol * max(scale, 1e-30), (what, path, d, scale)


# ---------------------------------------------------------------------------
# the chunked loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    dict(),                                       # S a multiple of the chunk
    dict(final_softcap=30.0),
    dict(vocab_size=500),                         # padded to 512: masked
    dict(masked=True),
    dict(S=23),                                   # a ragged last chunk
    dict(tie=False, S=23, masked=True, final_softcap=15.0, vocab_size=500),
], ids=["plain", "softcap", "padded_vocab", "mask", "ragged", "all"])
def test_chunked_cross_entropy_and_lm_loss_match_reference(case):
    case = dict(case)
    S, masked, tie = case.pop("S", 32), case.pop("masked", False), \
        case.pop("tie", True)
    kw = dict(logits_chunk=8, tie_embeddings=tie, **case)
    jcfg = ref_get_config("llama3.2-1b", smoke=True).replace(
        dtype=jnp.float32, **kw)
    cfg = get_config("llama3.2-1b", smoke=True).replace(
        dtype=torch.float32, **kw)
    assert cfg.padded_vocab == jcfg.padded_vocab
    rng = np.random.RandomState(3)
    B, d, V = 2, cfg.d_model, cfg.padded_vocab
    w = (rng.randn(V, d) * 0.3).astype(np.float32)
    p_np = {"embed": w} if tie else {"embed": w, "lm_head": np.ascontiguousarray(w.T)}
    hidden = rng.randn(B, S, d).astype(np.float32)
    labels = rng.randint(0, cfg.vocab_size, (B, S))
    mask = (rng.rand(B, S) > 0.3).astype(np.float32) if masked else None
    aux = np.float32(0.37)
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    tp = {k: torch.from_numpy(v) for k, v in p_np.items()}
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    ref = ref_chunked_ce(jcfg, jp, jnp.asarray(hidden), jnp.asarray(labels),
                         SH, jmask)
    got = chunked_cross_entropy(cfg, tp, torch.from_numpy(hidden),
                                torch.from_numpy(labels), tmask)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    rl, rm = ref_lm_loss(jcfg, jp, jnp.asarray(hidden), jnp.asarray(labels),
                         jnp.asarray(aux), SH, jmask)
    tl, tm = lm_loss(cfg, tp, torch.from_numpy(hidden),
                     torch.from_numpy(labels), torch.tensor(aux), tmask)
    for k in ("loss", "ce", "router_aux"):
        np.testing.assert_allclose(float(tm[k]), float(rm[k]), rtol=1e-5)
    np.testing.assert_allclose(float(tl), float(rl), rtol=1e-5)


def test_chunked_loss_gradient_matches_reference():
    """The chunk's recompute (torch.utils.checkpoint) gives the gradient of
    the reference's rematted chunks."""
    jcfg = ref_get_config("llama3.2-1b", smoke=True).replace(
        dtype=jnp.float32, logits_chunk=8, vocab_size=500)
    cfg = get_config("llama3.2-1b", smoke=True).replace(
        dtype=torch.float32, logits_chunk=8, vocab_size=500)
    rng = np.random.RandomState(4)
    w = (rng.randn(cfg.padded_vocab, cfg.d_model) * 0.3).astype(np.float32)
    hidden = rng.randn(2, 21, cfg.d_model).astype(np.float32)
    labels = rng.randint(0, cfg.vocab_size, (2, 21))
    gw, gh = jax.grad(lambda w_, h_: ref_chunked_ce(
        jcfg, {"embed": w_}, h_, jnp.asarray(labels), SH),
        argnums=(0, 1))(jnp.asarray(w), jnp.asarray(hidden))
    tw = torch.from_numpy(w).requires_grad_()
    th = torch.from_numpy(hidden).requires_grad_()
    loss = chunked_cross_entropy(cfg, {"embed": tw}, th,
                                 torch.from_numpy(labels))
    dw, dh = torch.autograd.grad(loss, (tw, th))
    for got, ref in ((dw, gw), (dh, gh)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref,
                                   atol=1e-5 * np.abs(ref).max(), rtol=1e-5)


# ---------------------------------------------------------------------------
# Model.train_loss and its gradient, every architecture
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _pair(arch: str, dtype=jnp.float32, head_dim=None, n_experts=None):
    """Both packages' smoke config of ``arch`` (at ``head_dim`` and with
    ``n_experts`` if given), the JAX model and its weights, and the port's
    model."""
    more = {k: v for k, v in (("head_dim", head_dim),
                              ("n_experts", n_experts)) if v is not None}
    jcfg = ref_get_config(arch, smoke=True).replace(dtype=dtype,
                                                    use_pallas=False, **more)
    jmodel = RefModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    cfg = get_config(arch, smoke=True).replace(dtype=tdtype, **more)
    model = Model(cfg, device="cpu")
    return jcfg, jmodel, jparams, cfg, model


def _params(jparams) -> dict:
    return params_from_reference(jax.tree.map(np.asarray, jparams),
                                 device="cpu")


@functools.lru_cache(maxsize=None)
def _fan_in_scaled(arch: str, dtype=jnp.float32, head_dim=None,
                   n_experts=None):
    """The reference's weights with every stacked "scaled" leaf rescaled to
    std 1 / sqrt(its fan-in), as (JAX tree, the port's tree).  Cached: a
    test that steps the port's tree (the train step updates it in place)
    steps a clone."""
    _, _, jparams, _, model = _pair(arch, dtype, head_dim, n_experts)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    for path, spec in spec_leaves(model.specs()):
        if spec.init == "scaled" and spec.axes[:1] == ("layers",):
            *parents, leaf = path.split("/")
            node = functools.reduce(dict.__getitem__, parents, tree)
            node[leaf] = node[leaf] * np.float32(
                spec.shape[-2] ** -0.5 / spec.std())
    jtree = jax.tree.map(lambda a, ref: jnp.asarray(a, ref.dtype), tree,
                         jparams)
    return jtree, _params(jtree)


def _batch(cfg, B=2, S=16, seed=5) -> dict:
    """A numpy training batch: tokens (B, S + 1), and the vlm's patches or
    the encdec's frames."""
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(0, cfg.vocab_size, (B, S + 1))}
    if cfg.arch_kind == "vlm":
        batch["patches"] = rng.randn(B, cfg.num_patches, cfg.d_model
                                     ).astype(np.float32)
    if cfg.arch_kind == "encdec":
        batch["frames"] = rng.randn(B, cfg.encoder_seq, cfg.d_model
                                    ).astype(np.float32)
    return batch


def _ref_loss_and_grads(jmodel, jparams, batch):
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: jmodel.train_loss(p, jbatch, SH), has_aux=True)(jparams)
    return metrics, grads


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_loss_and_every_leaf_gradient_match_reference(arch):
    jcfg, jmodel, jparams, cfg, model = _pair(arch)
    batch = _batch(cfg)
    loss, metrics = model.train_loss(_params(jparams), batch)
    rloss, rmetrics = jmodel.train_loss(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, SH)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
    jscaled, scaled = _fan_in_scaled(arch)
    rm, rg = _ref_loss_and_grads(jmodel, jscaled, batch)
    tm, tg = loss_and_grads(model, scaled, batch)
    for k in ("loss", "ce", "router_aux"):
        np.testing.assert_allclose(float(tm[k]), float(rm[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    _leafwise(tg, rg, 1e-4, arch)
    zero = [p for p, g in tree_paths(tg) if not bool((g != 0).any())]
    assert not zero, (arch, zero)     # the reference's grads-flow test


@pytest.mark.parametrize("arch", ["mamba2-130m", "qwen3-moe-235b-a22b"])
def test_train_gradient_through_the_ssd_and_gmm_functions(arch, monkeypatch):
    """``Model.train_loss`` and every leaf's gradient with the SSD scan and
    the grouped matmul running as their autograd Functions (``_SsdScan``,
    ``_MoeGmm``; on the card they run for CUDA inputs that require grad,
    here forced on CPU tensors), their kernel calls patched to the plain
    forward and the plain backward, against the JAX package's
    ``value_and_grad`` as in
    ``test_train_loss_and_every_leaf_gradient_match_reference``."""
    from repro_torch.kernels import moe_gmm as port_gmm
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as port_ssd

    calls = {"ssd": 0, "ssd_bwd": 0, "gmm": 0, "gmm_bwd": 0}

    def ssd(x, dt, B, C, A, *, chunk, return_states=False):
        calls["ssd"] += 1
        return port_ssd.ssd_scan_plain(x, dt, B, C, A, chunk=chunk,
                                       return_states=return_states)

    def ssd_bwd(x, dt, B, C, A, states, dy, *, chunk):
        calls["ssd_bwd"] += 1
        return port_ssd.ssd_scan_backward_plain(x, dt, B, C, A, states, dy,
                                                chunk)

    def gmm(x, w, **tiles):
        calls["gmm"] += 1
        return port_gmm.moe_gmm_plain(x, w)

    def gmm_bwd(x, w, dy, **tiles):
        calls["gmm_bwd"] += 1
        return port_gmm.moe_gmm_backward_plain(x, w, dy)

    monkeypatch.setattr(ops, "_wants_grad", lambda *t: torch.is_grad_enabled()
                        and any(a.requires_grad for a in t))
    for name, fn in (("ssd_scan_kernel", ssd),
                     ("ssd_scan_backward_kernel", ssd_bwd),
                     ("moe_gmm_kernel", gmm),
                     ("moe_gmm_backward_kernel", gmm_bwd)):
        monkeypatch.setattr(ops, name, fn)
    jcfg, jmodel, jparams, cfg, model = _pair(arch)
    batch = _batch(cfg)
    jscaled, scaled = _fan_in_scaled(arch)
    rm, rg = _ref_loss_and_grads(jmodel, jscaled, batch)
    tm, tg = loss_and_grads(model, scaled, batch)
    kind = "ssd" if arch.startswith("mamba") else "gmm"
    assert calls[kind] and calls[kind + "_bwd"], calls
    for k in ("loss", "ce", "router_aux"):
        np.testing.assert_allclose(float(tm[k]), float(rm[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    _leafwise(tg, rg, 1e-4, arch)


def test_gemma2_gradient_through_the_flash_backward(monkeypatch):
    """gemma2-2b's smoke config (a window of 16 on every other layer, the
    attention softcap 50, the final one 30) at head dim 64, the smallest
    the flash kernels are built for: ``loss_and_grads`` with
    ``ops.flash_attention`` running as ``_FlashAttention`` (on the card it
    does for CUDA inputs that require grad; here its CPU branch is sent
    there, and the Function's wrappers take the plain forward with lse and
    the plain backward for CPU tensors), at S 40 so that the window hides
    pairs, against the JAX package's ``value_and_grad`` as in
    ``test_train_loss_and_every_leaf_gradient_match_reference``; the
    backward ran once a layer, with that layer's window and the softcap."""
    from repro_torch.kernels import ops

    calls = []
    real_bwd = ops.flash_attention_backward_kernel

    def function(q, k, v, *, q_chunk=None, **kw):
        assert torch.is_grad_enabled() and q.requires_grad
        return ops._FlashAttention.apply(q, k, v, 32, 64, kw)

    def bwd(*args, **kw):
        calls.append((kw["window"], kw["softcap"]))
        return real_bwd(*args, **kw)

    monkeypatch.setattr(ops, "flash_attention_plain", function)
    monkeypatch.setattr(ops, "flash_attention_backward_kernel", bwd)
    arch = "gemma2-2b"
    jcfg, jmodel, jparams, cfg, model = _pair(arch, head_dim=64)
    assert [d.window for d in cfg.block_pattern] == [16, None]
    assert cfg.attn_softcap == 50.0
    batch = _batch(cfg, S=40)
    jscaled, scaled = _fan_in_scaled(arch, head_dim=64)
    rm, rg = _ref_loss_and_grads(jmodel, jscaled, batch)
    tm, tg = loss_and_grads(model, scaled, batch)
    windows = [cfg.block_pattern[i % len(cfg.block_pattern)].window
               for i in range(cfg.n_layers)]
    assert sorted(calls, key=str) == sorted(
        ((w, cfg.attn_softcap) for w in windows), key=str), calls
    for k in ("loss", "ce"):
        np.testing.assert_allclose(float(tm[k]), float(rm[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    _leafwise(tg, rg, 1e-4, arch)
    zero = [p for p, g in tree_paths(tg) if not bool((g != 0).any())]
    assert not zero, zero


def test_loss_and_grads_ops_reach_the_layers():
    """``loss_and_grads(ssd_op=, gmm_op=)`` (as ``attn_op=``) replaces the
    op in every Mamba-2 and MoE layer, and the gradient flows through it."""
    from repro_torch.kernels.moe_gmm import moe_gmm_plain
    from repro_torch.kernels.ssd_scan import ssd_scan_plain

    seen = []

    def ssd_op(x, dt, B, C, A):
        seen.append("ssd")
        return ssd_scan_plain(x, dt, B, C, A, chunk=8)

    def gmm_op(x, w):
        seen.append("gmm")
        return moe_gmm_plain(x, w)

    for arch, kind in (("mamba2-130m", "ssd"), ("qwen3-moe-235b-a22b", "gmm"),
                       ("jamba-1.5-large-398b", None)):
        _, _, _, cfg, model = _pair(arch)
        seen.clear()
        _, grads = loss_and_grads(model, _fan_in_scaled(arch)[1],
                                  _batch(cfg), ssd_op=ssd_op, gmm_op=gmm_op)
        layers = {"ssd": sum(d.kind != "attn" for d in cfg.block_pattern),
                  "gmm": sum(bool(d.moe) for d in cfg.block_pattern)}
        for op in ("ssd", "gmm"):
            want = layers[op] * cfg.n_groups * (3 if op == "gmm" else 1)
            # remat "full" runs each block's forward again in the backward
            assert seen.count(op) in (want, 2 * want), (arch, op, seen)
        if kind:
            assert seen.count(kind) > 0
        assert all(bool((g != 0).any()) for _, g in tree_paths(grads))


def test_grads_flow_everywhere_on_the_references_init():
    """tests/test_models.py's grads-flow test on the port, on the
    reference's own (faulted) init: no leaf's gradient is exactly zero."""
    for arch in ARCH_IDS:
        _, _, jparams, cfg, model = _pair(arch)
        _, grads = loss_and_grads(model, _params(jparams), _batch(cfg))
        zero = [p for p, g in tree_paths(grads) if not bool((g != 0).any())]
        assert not zero, (arch, zero)


def test_train_loss_bf16_llama_matches_reference():
    jcfg, jmodel, _, cfg, model = _pair("llama3.2-1b", jnp.bfloat16)
    jparams, params = _fan_in_scaled("llama3.2-1b", jnp.bfloat16)
    batch = _batch(cfg)
    rm, rg = _ref_loss_and_grads(jmodel, jparams, batch)
    assert params["embed"].dtype == torch.bfloat16
    tm, tg = loss_and_grads(model, params, batch)
    np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]),
                               rtol=2e-2)
    _leafwise(tg, rg, 2e-2, "bf16 llama")


def test_whisper_sinusoid_matches_reference():
    """The positions ``train_loss`` adds to whisper's frames (the prefill
    step adds none): the reference's ``_sinusoid``, at an odd length."""
    from repro.models.api import _sinusoid as ref_sinusoid
    from repro_torch.models.api import _sinusoid
    np.testing.assert_allclose(_sinusoid(37, 64, "cpu").numpy(),
                               np.asarray(ref_sinusoid(37, 64)), atol=1e-6)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

def test_remat_full_gives_the_grads_of_none_and_dots_raises():
    jcfg, jmodel, jparams, cfg, _ = _pair("llama3.2-1b")
    batch = _batch(cfg)
    params = _params(jparams)
    _, g_none = loss_and_grads(Model(cfg.replace(remat="none"), "cpu"),
                               params, batch)
    _, g_full = loss_and_grads(Model(cfg.replace(remat="full"), "cpu"),
                               params, batch)
    for (path, a), (_, b) in zip(tree_paths(g_none), tree_paths(g_full)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * float(
            b.abs().max()), msg=path)
    with pytest.raises(NotImplementedError):
        loss_and_grads(Model(cfg.replace(remat="dots"), "cpu"), params,
                       batch)
    with torch.no_grad():                 # no backward: nothing to remat
        loss, _ = Model(cfg.replace(remat="dots"), "cpu").train_loss(
            params, batch)
    assert bool(torch.isfinite(loss))
    loss, _ = Model(cfg.replace(remat="dots"), "cpu").train_loss(
        params, batch)                    # no parameter requires grad
    assert bool(torch.isfinite(loss))


def test_remat_full_recomputes_each_block_in_the_backward(monkeypatch):
    """With remat "full" each attention layer's forward runs twice per
    step (once more in the backward), with "none" once."""
    _, _, jparams, cfg, _ = _pair("llama3.2-1b")
    calls = []
    from repro_torch.kernels import ops

    def counting(*a, **kw):
        calls.append(1)
        return ops.flash_attention(*a, **kw)

    params, batch = _params(jparams), _batch(cfg)
    for remat, per_layer in (("none", 1), ("full", 2)):
        calls.clear()
        model = Model(cfg.replace(remat=remat), "cpu")
        loss_and_grads(model, params, batch, attn_op=counting)
        assert len(calls) == per_layer * cfg.n_layers, remat


# ---------------------------------------------------------------------------
# AdamW, schedules, compression
# ---------------------------------------------------------------------------

def _opt_trees(rng):
    shapes = {"a": (7, 5), "b": {"c": (11,), "d": (3, 4, 2)}}
    to_np = lambda s: (rng.randn(*s) * 0.5).astype(np.float32)
    p = jax.tree.map(to_np, shapes, is_leaf=lambda x: isinstance(x, tuple))
    return p, shapes


@pytest.mark.parametrize("state", ["f32", "bf16"])
@pytest.mark.parametrize("clip", [1.0, None])
def test_adamw_update_matches_reference_over_three_steps(state, clip):
    rng = np.random.RandomState(7)
    p_np, shapes = _opt_trees(rng)
    rcfg = RefAdamWConfig(lr=ref_warmup_cosine(1e-2, 2, 10),
                          weight_decay=0.1, clip_norm=clip,
                          state_dtype=jnp.float32 if state == "f32"
                          else jnp.bfloat16)
    tcfg = AdamWConfig(lr=warmup_cosine(1e-2, 2, 10), weight_decay=0.1,
                       clip_norm=clip, state_dtype=torch.float32
                       if state == "f32" else torch.bfloat16)
    jp = jax.tree.map(jnp.asarray, p_np)
    tp = tree_map(torch.from_numpy, p_np)
    js, ts = ref_adamw_init(rcfg, jp), adamw_init(tcfg, tp)
    for step in range(3):
        g_np = jax.tree.map(lambda a: (rng.randn(*a.shape) * 2).astype(
            np.float32), p_np)
        jp, js, jm = ref_adamw_update(rcfg, jax.tree.map(jnp.asarray, g_np),
                                      js, jp)
        tp, ts, tm = adamw_update(tcfg, tree_map(torch.from_numpy, g_np),
                                  ts, tp)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        if clip is not None:
            np.testing.assert_allclose(float(tm["grad_norm"]),
                                       float(jm["grad_norm"]), rtol=1e-6)
        else:
            assert "grad_norm" not in tm and "grad_norm" not in jm
    assert int(ts["step"]) == int(js["step"]) == 3
    _leafwise(tp, jp, 1e-6, "params")
    ulp = 1e-6 if state == "f32" else 2.0 ** -7    # one bf16 ulp, relative
    for key in ("mu", "nu"):
        ref = {jax.tree_util.keystr(p): np.asarray(v, np.float32) for p, v
               in jax.tree_util.tree_flatten_with_path(js[key])[0]}
        for path, leaf in tree_paths(ts[key]):
            assert leaf.dtype == tcfg.state_dtype
            np.testing.assert_allclose(_np(leaf), ref[path], rtol=ulp,
                                       atol=1e-30, err_msg=path)


@pytest.mark.parametrize("state", ["float32", "bfloat16"])
@pytest.mark.parametrize("sr", [False, True])
def test_adamw_update_in_chunks_is_bit_equal(state, sr, monkeypatch):
    """The update runs each leaf in flat chunks of ``UPDATE_CHUNK``
    elements (the clip's scale applied chunk by chunk): the same bits as
    one chunk per leaf, with and without stochastic rounding (which draws
    a leaf's noise in one piece)."""
    from repro_torch.optim import adamw as port_adamw

    rng = np.random.RandomState(0)
    params = {"a": torch.from_numpy(rng.randn(3, 1000).astype(np.float32)
                                    ).bfloat16(),
              "b": torch.from_numpy(rng.randn(77).astype(np.float32))}
    grads = {k: torch.from_numpy(rng.randn(*v.shape).astype(np.float32)
                                 ).to(v.dtype) for k, v in params.items()}
    cfg = AdamWConfig(lr=1e-3, state_dtype=getattr(torch, state))
    opt = adamw_init(cfg, params)
    opt["mu"] = tree_map(lambda m: torch.from_numpy(
        rng.randn(*m.shape).astype(np.float32)).to(m.dtype), opt["mu"])
    opt["nu"] = tree_map(lambda m: torch.from_numpy(
        rng.rand(*m.shape).astype(np.float32)).to(m.dtype), opt["nu"])

    def update():
        gen = torch.Generator().manual_seed(3) if sr else None
        p, st, m = adamw_update(cfg, grads, opt, params, sr_gen=gen)
        return tree_leaves({"p": p, "mu": st["mu"], "nu": st["nu"]}), m

    whole, m0 = update()
    monkeypatch.setattr(port_adamw, "UPDATE_CHUNK", 7)
    chunked, m1 = update()
    assert all(torch.equal(a, b) for a, b in zip(whole, chunked))
    assert torch.equal(m0["grad_norm"], m1["grad_norm"])


@pytest.mark.parametrize("param", ["float32", "bfloat16"])
@pytest.mark.parametrize("state", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, None])
def test_adamw_update_in_place_is_bit_equal_to_functional(param, state,
                                                          clip):
    """``adamw_update_`` writes three steps into the parameter and moment
    tensors it is given (and the step counter), leaf by leaf the bits of
    ``adamw_update``'s new trees; its outputs are its inputs."""
    rng = np.random.RandomState(11)
    p_np, _ = _opt_trees(rng)
    cfg = AdamWConfig(lr=warmup_cosine(1e-2, 2, 10), weight_decay=0.1,
                      clip_norm=clip, state_dtype=getattr(torch, state))
    fp = tree_map(lambda a: torch.from_numpy(a).to(getattr(torch, param)),
                  p_np)
    ip = tree_map(torch.clone, fp)
    fs, is_ = adamw_init(cfg, fp), adamw_init(cfg, ip)
    ptrs = [t.data_ptr() for t in tree_leaves({"p": ip, "s": is_})]
    for _ in range(3):
        g = tree_map(lambda a: torch.from_numpy(
            (rng.randn(*a.shape) * 2).astype(np.float32)).to(
                getattr(torch, param)), p_np)
        fp, fs, fm = adamw_update(cfg, g, fs, fp)
        out_p, out_s, im = adamw_update_(cfg, g, is_, ip)
        assert out_p is ip and out_s is is_
        assert sorted(fm) == sorted(im)
        assert all(torch.equal(fm[k], im[k]) for k in fm)
    assert [t.data_ptr() for t in tree_leaves({"p": ip, "s": is_})] == ptrs
    assert int(is_["step"]) == int(fs["step"]) == 3
    for (path, a), (_, b) in zip(tree_paths({"p": fp, "s": fs}),
                                 tree_paths({"p": ip, "s": is_})):
        assert a.dtype == b.dtype and torch.equal(a, b), path


@pytest.mark.parametrize("fault", ["shared", "overlapping", "strided",
                                   "moment_dtype"])
def test_adamw_update_in_place_refuses_trees_it_would_corrupt(fault):
    """Two leaves on one storage (the step would apply twice to it), a
    leaf that is not contiguous (its flat view would be a copy) and a
    moment in another dtype than the config's are refused before anything
    is written."""
    cfg = AdamWConfig(lr=1e-2)
    base = torch.arange(12, dtype=torch.float32)
    params = {"a": base[:6].view(2, 3).clone(), "b": base[6:].clone()}
    if fault == "shared":
        params["b"] = params["a"]
    elif fault == "overlapping":
        whole = base.clone()
        params = {"a": whole[:6], "b": whole[6:]}
    elif fault == "strided":
        params["a"] = base.clone().view(3, 4).t()[:, :2]
    state = adamw_init(cfg, params)
    if fault == "moment_dtype":
        state["mu"]["a"] = state["mu"]["a"].bfloat16()
    before = tree_map(torch.clone, {"p": params, "s": state})
    grads = tree_map(torch.ones_like, params)
    with pytest.raises(ValueError):
        adamw_update_(cfg, grads, state, params)
    for a, b in zip(tree_leaves(before), tree_leaves({"p": params,
                                                      "s": state})):
        assert torch.equal(a, b)


def test_global_norm_sums_a_large_leaf_in_chunks(monkeypatch):
    """A leaf of more than ``NORM_CHUNK`` elements is squared and summed in
    chunks (its f32 copy and square stay at a chunk's size): the norm
    within f32 rounding of the whole-leaf sum and of the reference's; a
    leaf of at most one chunk keeps the whole-leaf sum's bits."""
    from repro.optim import global_norm as ref_global_norm
    from repro_torch.optim import adamw as port_adamw

    rng = np.random.RandomState(4)
    tree = {"a": rng.randn(40, 25).astype(np.float32),
            "b": rng.randn(7).astype(np.float32)}
    port = tree_map(torch.from_numpy, tree)
    whole = global_norm(port)
    monkeypatch.setattr(port_adamw, "NORM_CHUNK", 64)
    chunked = global_norm(port)
    assert torch.equal(global_norm({"b": port["b"]}),
                       torch.sqrt(torch.sum(torch.square(port["b"]))))
    ref = float(ref_global_norm(jax.tree.map(jnp.asarray, tree)))
    np.testing.assert_allclose(float(chunked), float(whole), rtol=1e-6)
    np.testing.assert_allclose(float(chunked), ref, rtol=1e-6)


def test_stochastic_rounding_is_unbiased_and_within_one_ulp():
    """The port's rounding noise comes from a torch.Generator, so its bits
    differ from the reference's jax.random draws (a divergence by design);
    what both promise is an unbiased rounding to a bf16 neighbour."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.randn(64) * 3).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    draws = stochastic_round(x.repeat(4096, 1), gen).float()
    lo = x.to(torch.bfloat16).float()
    # the two bf16 neighbours of x
    down = torch.where(lo <= x, lo, torch.nextafter(
        lo.to(torch.bfloat16), torch.tensor(-float("inf"),
                                            dtype=torch.bfloat16)).float())
    up = torch.where(lo >= x, lo, torch.nextafter(
        lo.to(torch.bfloat16), torch.tensor(float("inf"),
                                            dtype=torch.bfloat16)).float())
    assert bool(((draws == down) | (draws == up)).all())
    ulp = (up - down).clamp_min(1e-30)
    bias = (draws.mean(0) - x).abs() / ulp
    assert float(bias.max()) < 0.05           # 4096 draws: sd 0.008 ulp
    gen2 = torch.Generator().manual_seed(0)
    assert torch.equal(stochastic_round(x.repeat(4096, 1), gen2).float(),
                       draws)                 # reseeded: the same bits
    tcfg = AdamWConfig(lr=1e-3, clip_norm=None)
    p = {"w": x.to(torch.bfloat16)}
    out, _, _ = adamw_update(tcfg, {"w": torch.zeros(64)}, adamw_init(
        tcfg, p), p, sr_gen=torch.Generator().manual_seed(1))
    assert out["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 57, 100, 150])
def test_schedules_match_reference(step):
    pairs = ((constant(0.3), ref_constant(0.3)),
             (warmup_linear(1.0, 10, 100, 0.1),
              ref_warmup_linear(1.0, 10, 100, 0.1)),
             (warmup_cosine(1.0, 10, 100), ref_warmup_cosine(1.0, 10, 100)))
    for port, ref in pairs:
        got = port(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(ref(jnp.asarray(step))),
                                   rtol=1e-6, atol=1e-7)
        assert float(port(step)) == float(got)         # an int step too


@pytest.mark.parametrize("seed", range(8))
def test_compression_roundtrip_bounded_and_equal_to_reference(seed):
    rng = np.random.RandomState(seed)
    g = (rng.randn(64) * rng.uniform(0.1, 10)).astype(np.float32)
    q, s = compress(torch.from_numpy(g))
    rq, rs = ref_compress(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_allclose(float(s), float(rs), rtol=1e-7)
    back = decompress(q, s)
    assert float((back - torch.from_numpy(g)).abs().max()) <= \
        float(s) * 0.5 + 1e-9


def test_error_feedback_accumulates_residual_as_the_reference():
    rng = np.random.RandomState(0)
    grads = {"w": torch.from_numpy(rng.randn(128) * 0.01).float()}
    err = init_error_feedback(grads)
    rerr = jax.tree.map(lambda g: jnp.zeros(g.shape, jnp.float32),
                        {"w": np.zeros(128)})
    applied = torch.zeros(128)
    true = torch.zeros(128)
    for _ in range(30):
        g_np = (rng.randn(128) * 0.01).astype(np.float32)
        g = {"w": torch.from_numpy(g_np)}
        qs, ss, err = ef_compress_tree(g, err)
        rqs, rss, rerr = ref_ef_compress_tree({"w": jnp.asarray(g_np)}, rerr)
        np.testing.assert_array_equal(qs["w"].numpy(), np.asarray(rqs["w"]))
        applied = applied + ef_update_tree(qs, ss)["w"]
        true = true + g["w"]
    np.testing.assert_allclose(err["w"].numpy(), np.asarray(rerr["w"]),
                               atol=1e-9)
    assert float((applied + err["w"] - true).abs().max()) < 1e-4


def test_adamw_reference_cases():
    """tests/test_substrate.py's TestAdamW, on the port."""
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, clip_norm=None)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw_init(cfg, params)
    target = torch.tensor([1.0, 2.0])
    for _ in range(300):
        params, state, _ = adamw_update(cfg, {"w": params["w"] - target},
                                        state, params)
    torch.testing.assert_close(params["w"], target, atol=1e-2, rtol=0)
    cfg = AdamWConfig(lr=0.1, weight_decay=0.5, clip_norm=None)
    p = {"w": torch.tensor([4.0])}
    p2, _, _ = adamw_update(cfg, {"w": torch.tensor([0.0])},
                            adamw_init(cfg, p), p)
    assert float(p2["w"][0]) < 4.0
    clipped, norm = clip_by_global_norm({"a": torch.tensor([3.0, 4.0])}, 1.0)
    assert float(norm) == pytest.approx(5.0)
    assert float(global_norm(clipped)) == pytest.approx(1.0)
    fn = warmup_cosine(1.0, 10, 100)
    assert float(fn(5)) == pytest.approx(0.5)
    assert float(fn(10)) == pytest.approx(1.0)
    assert float(fn(100)) == pytest.approx(0.0, abs=1e-6)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_synthetic_batches_and_shards_bit_equal_to_reference():
    for shards in (1, 2, 4):
        for idx in range(shards):
            kw = dict(vocab_size=1000, seq_len=32, global_batch=8, seed=11)
            port = SyntheticStream(SyntheticConfig(**kw), shard_index=idx,
                                   shard_count=shards)
            ref = RefStream(RefSynthConfig(**kw), shard_index=idx,
                            shard_count=shards)
            for _ in range(3):
                a, b = port.next_batch()["tokens"], ref.next_batch()["tokens"]
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    cfg = SyntheticConfig(vocab_size=1000, seq_len=16, global_batch=8)
    full = SyntheticStream(cfg).next_batch()["tokens"]
    halves = [SyntheticStream(cfg, shard_index=i, shard_count=2
                              ).next_batch()["tokens"] for i in (0, 1)]
    np.testing.assert_array_equal(np.concatenate(halves), full)
    s2 = SyntheticStream(cfg)
    s2.load_state_dict({"step": 3})
    ref = SyntheticStream(cfg)
    for _ in range(3):
        ref.next_batch()
    np.testing.assert_array_equal(s2.next_batch()["tokens"],
                                  ref.next_batch()["tokens"])


@pytest.mark.parametrize("impl", ["port", "reference"])
def test_prefetcher_resumes(impl):
    Stream, Config, Pre = ((SyntheticStream, SyntheticConfig, Prefetcher)
                           if impl == "port" else
                           (RefStream, RefSynthConfig, RefPrefetcher))
    cfg = Config(vocab_size=100, seq_len=8, global_batch=2)
    p = Pre(Stream(cfg), depth=2).start()
    [p.next_batch() for _ in range(4)]
    state = p.state_dict()
    p.stop()
    p2 = Pre(Stream(cfg), depth=2)
    p2.load_state_dict(state)
    p2.start()
    nxt = p2.next_batch()
    p2.stop()
    ref = SyntheticStream(SyntheticConfig(vocab_size=100, seq_len=8,
                                          global_batch=2))
    ref.load_state_dict({"step": 4})
    np.testing.assert_array_equal(nxt["tokens"], ref.next_batch()["tokens"])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _ckpt_tree():
    rng = np.random.RandomState(2)
    return {"a": rng.randn(2, 3).astype(np.float32),
            "b": {"c": (rng.randn(4) * 3).astype(np.float32),
                  "d": rng.randint(0, 9, (5,)).astype(np.int32)}}


def _port_tree(np_tree):
    out = tree_map(torch.from_numpy, np_tree)
    out["b"]["c"] = out["b"]["c"].to(torch.bfloat16)
    return out


def _ref_tree(np_tree):
    out = jax.tree.map(jnp.asarray, np_tree)
    out["b"]["c"] = out["b"]["c"].astype(jnp.bfloat16)
    return out


def test_checkpoint_roundtrip_and_layout(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    tree = _port_tree(_ckpt_tree())
    mgr.save(7, tree, aux={"stream": {"step": 7}})
    d = tmp_path / "step_00000007"
    manifest = json.loads((d / "manifest.json").read_text())
    assert manifest["paths"] == ["['a']", "['b']['c']", "['b']['d']"]
    assert manifest["dtypes"] == ["float32", "bfloat16", "int32"]
    assert manifest["shapes"] == [[2, 3], [4], [5]]
    assert sorted(os.listdir(d)) == ["arr_0000.npy", "arr_0001.npy",
                                     "arr_0002.npy", "manifest.json"]
    assert np.load(d / "arr_0001.npy").dtype == np.uint16
    restored, aux, step = mgr.restore(tree, device="cpu")
    assert step == 7 and aux["stream"]["step"] == 7
    for x, y in zip(tree_leaves(tree), tree_leaves(restored)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_checkpoint_async_keep_k_and_no_partial(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    tree = _port_tree(_ckpt_tree())
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    mgr.wait()
    assert mgr.all_steps() == [3, 4]
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    assert [t["step"] for t in mgr.timings] == [1, 2, 3, 4]


def test_checkpoint_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    tree = _port_tree(_ckpt_tree())
    mgr.save(1, tree)
    bad = dict(tree, a=torch.zeros(3, 3))
    with pytest.raises(ValueError):
        mgr.restore(bad, device="cpu")
    with pytest.raises(KeyError):
        mgr.restore(dict(tree, e=torch.zeros(1)), device="cpu")


def test_checkpoint_restores_across_packages(tmp_path):
    np_tree = _ckpt_tree()
    # the reference writes, the port restores (a template of specs)
    RefManager(str(tmp_path / "r"), async_save=False).save(
        3, _ref_tree(np_tree), aux={"x": 1})
    template = tree_map(lambda t: ParamSpec(tuple(t.shape), t.dtype),
                        _port_tree(np_tree))
    got, aux, step = CheckpointManager(str(tmp_path / "r")).restore(
        template, device="cpu")
    assert (aux, step) == ({"x": 1}, 3)
    for x, y in zip(tree_leaves(_port_tree(np_tree)), tree_leaves(got)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    # the port writes, the reference restores
    CheckpointManager(str(tmp_path / "p"), async_save=False).save(
        5, _port_tree(np_tree), aux={"y": 2})
    rtemplate = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                             _ref_tree(np_tree))
    rgot, raux, rstep = RefManager(str(tmp_path / "p")).restore(rtemplate)
    assert (raux, rstep) == ({"y": 2}, 5)
    for x, y in zip(jax.tree.leaves(_ref_tree(np_tree)),
                    jax.tree.leaves(rgot)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x, np.float32),
                                      np.asarray(y, np.float32))


def test_checkpoint_save_then_an_in_place_step_writes_the_values_before_it(
        tmp_path, monkeypatch):
    """``save`` takes its host copy on the calling thread, a CPU leaf's
    too: an in-place AdamW step right after an async save (the write
    thread held until the step is done) leaves the checkpoint at the
    values from before the step."""
    import threading

    gate = threading.Event()
    real_write = CheckpointManager._write

    def held_write(self, *args):
        assert gate.wait(timeout=60)
        real_write(self, *args)

    monkeypatch.setattr(CheckpointManager, "_write", held_write)
    cfg = AdamWConfig(lr=1e-2)
    rng = np.random.RandomState(9)
    params = tree_map(torch.from_numpy, _opt_trees(rng)[0])
    state = adamw_init(cfg, params)
    tree = {"params": params, "mu": state["mu"], "nu": state["nu"]}
    before = tree_map(torch.clone, tree)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, tree)
    adamw_update_(cfg, tree_map(torch.ones_like, params), state, params)
    gate.set()
    mgr.wait()
    assert not torch.equal(params["a"], before["params"]["a"])
    restored, _, step = mgr.restore(before, device="cpu")
    assert step == 1
    for a, b in zip(tree_leaves(before), tree_leaves(restored)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the train step and the trainer
# ---------------------------------------------------------------------------

def test_three_train_steps_match_reference():
    """On the rescaled weights (see the module docstring: on the
    reference's init the gradient norm alone differs by 1.3e-3)."""
    jcfg, jmodel, _, cfg, model = _pair("llama3.2-1b")
    jparams, params = _fan_in_scaled("llama3.2-1b")
    rcfg = RefAdamWConfig(lr=ref_warmup_cosine(5e-3, 10, 10_000),
                          weight_decay=0.01)
    tcfg = AdamWConfig(lr=warmup_cosine(5e-3, 10, 10_000), weight_decay=0.01)
    rstep = jax.jit(ref_make_train_step(jmodel, rcfg, SH))
    tstep = make_train_step(model, tcfg)
    jp, tp = jparams, tree_map(torch.clone, params)   # stepped in place
    js, ts = ref_adamw_init(rcfg, jp), adamw_init(tcfg, tp)
    stream = SyntheticStream(SyntheticConfig(cfg.vocab_size, 32, 4, seed=3))
    for _ in range(3):
        batch = stream.next_batch()
        jp, js, jm = rstep(jp, js, {"tokens": jnp.asarray(batch["tokens"])})
        tp, ts, tm = tstep(tp, ts, batch)
        assert sorted(tm) == sorted(jm) == ["ce", "grad_norm", "loss", "lr",
                                            "router_aux"]
        for k in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, err_msg=k)
    _leafwise(tp, jp, 1e-4, "params after 3 steps")
    _leafwise(ts["mu"], js["mu"], 1e-4, "mu")
    _leafwise(ts["nu"], js["nu"], 1e-4, "nu")


def _three_bf16_moment_steps(arch: str, monkeypatch, head_dim=None,
                             n_experts=None) -> None:
    """Three steps of ``make_train_step`` on ``arch``'s smoke config (at
    ``head_dim`` and ``n_experts`` if given) with f32 parameters and bf16
    AdamW moments against the JAX package's train step with
    ``state_dtype`` bf16; the bounds are those of
    ``test_three_qwen3_moe_train_steps_with_bf16_moments_match_reference``.
    The experts' products run through ``_MoeGmm``, and with ``head_dim``
    attention through ``_FlashAttention`` (as in
    ``test_gemma2_gradient_through_the_flash_backward``): the Functions the
    card trains through, whose forward and backward wrappers take their
    plain versions on CPU tensors."""
    from repro_torch.kernels import ops

    monkeypatch.setattr(ops, "_wants_grad", lambda *t: torch.is_grad_enabled()
                        and any(a.requires_grad for a in t))
    calls, flash_calls = [], []
    real_backward = ops.moe_gmm_backward_kernel
    real_flash_backward = ops.flash_attention_backward_kernel

    def recording(*a, **kw):
        calls.append(1)
        return real_backward(*a, **kw)

    def function(q, k, v, *, q_chunk=None, **kw):
        return ops._FlashAttention.apply(q, k, v, 32, 64, kw)

    def flash_recording(*a, **kw):
        flash_calls.append(kw["softcap"])
        return real_flash_backward(*a, **kw)

    monkeypatch.setattr(ops, "moe_gmm_backward_kernel", recording)
    if head_dim is not None:
        monkeypatch.setattr(ops, "flash_attention_plain", function)
        monkeypatch.setattr(ops, "flash_attention_backward_kernel",
                            flash_recording)
    jcfg, jmodel, _, cfg, model = _pair(arch, head_dim=head_dim,
                                        n_experts=n_experts)
    jparams, params = _fan_in_scaled(arch, head_dim=head_dim,
                                     n_experts=n_experts)
    rcfg = RefAdamWConfig(lr=ref_warmup_cosine(5e-3, 10, 10_000),
                          weight_decay=0.01, state_dtype=jnp.bfloat16)
    tcfg = AdamWConfig(lr=warmup_cosine(5e-3, 10, 10_000), weight_decay=0.01,
                       state_dtype=torch.bfloat16)
    rstep = jax.jit(ref_make_train_step(jmodel, rcfg, SH))
    tstep = make_train_step(model, tcfg)
    jp, tp = jparams, tree_map(torch.clone, params)   # stepped in place
    js, ts = ref_adamw_init(rcfg, jp), adamw_init(tcfg, tp)
    stream = SyntheticStream(SyntheticConfig(cfg.vocab_size, 32, 4, seed=3))
    lr_sum = 0.0
    for _ in range(3):
        batch = stream.next_batch()
        jp, js, jm = rstep(jp, js, {"tokens": jnp.asarray(batch["tokens"])})
        tp, ts, tm = tstep(tp, ts, batch)
        for k in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, err_msg=k)
        lr_sum += float(jm["lr"])
    assert calls, "the steps ran no grouped-matmul backward"
    if head_dim is not None:
        assert flash_calls == [cfg.attn_softcap] * (3 * cfg.n_layers), \
            flash_calls
    ulp = 2.0 ** -7                                 # one bf16 ulp, relative
    for key in ("mu", "nu"):
        for _, leaf in tree_paths(ts[key]):
            assert leaf.dtype == torch.bfloat16
        _leafwise(ts[key], js[key], ulp, key)
    ref = {jax.tree_util.keystr(p): np.asarray(v, np.float32)
           for p, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    for path, leaf in tree_paths(tp):
        d = float(np.abs(_np(leaf) - ref[path]).max())
        assert d <= 1e-4 * float(np.abs(ref[path]).max()) + ulp * lr_sum, \
            (path, d)


def test_three_qwen3_moe_train_steps_with_bf16_moments_match_reference(
        monkeypatch):
    """qwen3-moe's smoke config, three steps of ``make_train_step`` with f32
    parameters and bf16 AdamW moments (the state qwen3-moe trains with on
    the card; f32 parameters, so no stochastic rounding enters) against the
    JAX package's train step with ``state_dtype`` bf16.  The experts'
    products run through ``_MoeGmm``, the Function the card trains through
    (its forward and backward wrappers take their plain versions on CPU
    tensors).  Held:

    * loss, ce, grad_norm and lr at each step within 1e-4 relative;
    * both moments within one bf16 ulp (2^-7) of the leaf's max |ref|.  Not
      element by element: once the two gradients differ in their last bits
      a moment's rounding may fall either side, and a later step whose
      gradient cancels the moment leaves that one-ulp step larger than one
      ulp of what remains;
    * the parameters within 1e-4 x max |ref| per leaf plus one bf16 ulp of
      each step's update (2^-7 x the sum of the three learning rates):
      Adam's update m / (sqrt(v) + eps) is near 1 in size and inherits the
      moments' rounding, so a leaf that is the sum of its updates (the
      zero-initialised norm scales) differs by that term and no less."""
    _three_bf16_moment_steps("qwen3-moe-235b-a22b", monkeypatch)


def test_three_grok1_train_steps_with_bf16_moments_match_reference(
        monkeypatch):
    """grok-1's smoke config with grok-1's 8 experts (top-2) at head dim 64
    (the smallest the flash kernels are built for), three steps of the
    in-place ``make_train_step`` with bf16 AdamW moments (grok-1 is in
    ``BF16_OPT_STATE``) against the JAX package's train step, within the
    qwen3-moe test's bounds: the softcapped attention (30) through
    ``_FlashAttention``, the final softcap (30) and the 8-expert top-2 MoE
    through ``_MoeGmm``, the path grok-1 trains on the card."""
    assert "grok-1-314b" in BF16_OPT_STATE
    _three_bf16_moment_steps("grok-1-314b", monkeypatch, head_dim=64,
                             n_experts=8)


def test_train_step_updates_params_and_state_in_place():
    """``make_train_step`` returns the very trees (and tensors) it was
    given, each updated in place, bit-equal to the functional step
    (``loss_and_grads`` then ``adamw_update``) on clones of them."""
    cfg = get_config("llama3.2-1b", smoke=True).replace(dtype=torch.float32)
    model = Model(cfg, device="cpu")
    params = model.init(0)
    opt_cfg = AdamWConfig(lr=warmup_cosine(5e-3, 2, 100))
    state = adamw_init(opt_cfg, params)
    fp, fs = tree_map(torch.clone, params), tree_map(torch.clone, state)
    step = make_train_step(model, opt_cfg)
    tensors = tree_leaves({"p": params, "s": state})
    stream = SyntheticStream(SyntheticConfig(cfg.vocab_size, 16, 2, seed=1))
    for _ in range(2):
        batch = stream.next_batch()
        out_p, out_s, m = step(params, state, batch)
        assert out_p is params and out_s is state
        assert all(a is b for a, b in zip(
            tree_leaves({"p": out_p, "s": out_s}), tensors))
        fm, grads = loss_and_grads(model, fp, batch)
        fp, fs, om = adamw_update(opt_cfg, grads, fs, fp)
        for k, v in {**fm, **om}.items():
            assert torch.equal(m[k], v), k
    for (path, a), (_, b) in zip(tree_paths({"p": fp, "s": fs}),
                                 tree_paths({"p": params, "s": state})):
        assert torch.equal(a, b), path


def test_train_step_profiles_the_optimizer_in_a_range_of_its_own():
    """The step's update runs inside the ``adamw_update`` profiler range,
    and every op of the update (and no op of the loss or its gradient)
    falls inside it: a trace of a step splits the optimizer from the rest
    by that range."""
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config("llama3.2-1b", smoke=True).replace(dtype=torch.float32)
    model = Model(cfg, device="cpu")
    params = model.init(0)
    opt_cfg = AdamWConfig(lr=1e-3)
    batch = SyntheticStream(SyntheticConfig(cfg.vocab_size, 16, 2,
                                            seed=1)).next_batch()
    step = make_train_step(model, opt_cfg)
    state = adamw_init(opt_cfg, params)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, state, batch)
    events = prof.events()
    ranges = [e for e in events if e.name == "adamw_update"]
    assert len(ranges) == 1
    opt = ranges[0]

    def under(ev):
        for c in ev.cpu_children:
            yield c
            yield from under(c)

    inside = {id(e) for e in under(opt)}
    assert inside, "the optimizer's range holds no op"
    # the loss's ops (the embedding, the gradient) run before the range
    outside = [e for e in events if id(e) not in inside and e is not opt
               and e.name.startswith("aten::")
               and e.time_range.start >= opt.time_range.start
               and e.time_range.end <= opt.time_range.end
               and e.thread == opt.thread]
    assert outside == []
    assert any(e.name == "aten::embedding" and
               e.time_range.end <= opt.time_range.start for e in events)


def _loop(tmp_path, **kw):
    cfg = get_config("llama3.2-1b", smoke=True)
    preset = ShapePreset("t", "train", 32, 4)
    return TrainLoop(cfg, preset, ckpt_dir=str(tmp_path), ckpt_every=2,
                     device="cpu", **kw)


def test_trainloop_crash_and_resume_bit_exact(tmp_path):
    a = _loop(tmp_path / "a")
    a.init_state()
    a.run(6, log_every=6)
    b = _loop(tmp_path / "b")
    b.init_state()
    with pytest.raises(RuntimeError, match="injected failure"):
        b.run(6, fail_at=5)
    b.manager.wait()
    b2 = _loop(tmp_path / "b")
    assert b2.restore_or_init() == 4
    b2.run(6, log_every=6)
    for x, y in zip(tree_leaves({"p": a.params, "o": a.opt_state}),
                    tree_leaves({"p": b2.params, "o": b2.opt_state})):
        assert torch.equal(x, y)


def test_trainloop_params_hook_and_mesh_refused(tmp_path):
    _, _, jparams, cfg, _ = _pair("llama3.2-1b")
    params = _params(jparams)
    preset = ShapePreset("t", "train", 16, 2)
    loop = TrainLoop(cfg, preset, device="cpu", params=params)
    loop.init_state()
    for x, y in zip(tree_leaves(loop.params), tree_leaves(params)):
        assert torch.equal(x, y) and x is not y
    hist = loop.run(2, log_every=1)
    assert [m["step"] for m in hist] == [1, 2]
    assert all(np.isfinite(m["loss"]) for m in hist)
    # a mesh trains data parallel; one the port cannot run
    # (a "model" axis of 2: tensor parallelism) is refused
    with pytest.raises(NotImplementedError, match="6.4"):
        TrainLoop(cfg, preset, mesh=AbstractMesh((1, 2), ("data", "model")),
                  device="cpu")


def test_trainloop_updates_its_own_trees_in_place(tmp_path):
    """The loop's parameter and moment tensors keep their storage across
    steps (the step updates them in place), and the ``params=`` given stay
    as they were (``init_state`` cloned them)."""
    _, _, jparams, cfg, _ = _pair("llama3.2-1b")
    params = _params(jparams)
    given = tree_map(torch.clone, params)
    loop = TrainLoop(cfg, ShapePreset("t", "train", 16, 2), device="cpu",
                     params=params)
    loop.init_state()
    tensors = tree_leaves({"p": loop.params, "s": loop.opt_state})
    start = [t.clone() for t in tensors]
    loop.run(2, log_every=1)
    now = tree_leaves({"p": loop.params, "s": loop.opt_state})
    assert all(a is b for a, b in zip(now, tensors))
    assert int(loop.opt_state["step"]) == 2
    assert not all(torch.equal(a, b) for a, b in zip(now, start))
    for a, b in zip(tree_leaves(params), tree_leaves(given)):
        assert torch.equal(a, b)


def test_bf16_opt_state_is_the_references():
    from repro.configs import BF16_OPT_STATE as REF_BF16_OPT_STATE
    assert BF16_OPT_STATE == REF_BF16_OPT_STATE
    assert BF16_OPT_STATE <= set(ARCH_IDS)


def test_train_cli_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "llama3.2-1b", "--smoke", "--device", "cpu", "--steps", "3",
         "--log-every", "1"],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("step")]
    assert len(lines) == 3


def test_train_lm_example_tiny_on_the_cpu():
    from repro_torch.examples import train_lm
    hist = train_lm.main(["--tiny", "--steps", "2", "--batch", "2", "--seq",
                          "16", "--device", "cpu"])
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
