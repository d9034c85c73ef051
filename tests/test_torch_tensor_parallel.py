"""Tensor and sequence parallelism over "model" and FSDP over "data" in the
port's train step, against the JAX package's one-device functions and the
port's one-process step, on the CPU.

One spawned gloo world of 4 ranks (``file://`` rendezvous in a tmp dir,
every rank's stderr in the failure, under ``WORLD_TIMEOUT_S``; the pattern
of ``tests/test_torch_distributed.py``) runs every case; no process group
is built in the pytest process.  f32 smoke configs of the four dense
attention decoders (llama3.2-1b, internlm2-1.8b, gemma2-2b, qwen3-14b),
weights from the JAX package's init with every stacked "scaled" leaf at
std 1 / sqrt(its fan-in) (as ``tests/test_torch_train.py`` compares train
steps: on the faulted init near one-hot attention makes f32 gradients
differ by ~1e-4 between any two summation orders).

* Layers on a (data 1, model 4) mesh: ``layers.attention``,
  ``layers.mlp`` and ``loss.chunked_cross_entropy`` on each rank's blocks
  against the JAX package's functions on the whole inputs: the output
  and the gradient of every parameter and of the input, gathered, within
  1e-5 x max |ref| (``LAYER_TOL``).  Cases: GQA 2 with the kv columns split
  mid-head (the smoke configs' 2 kv heads x 32 over 4 ranks), gemma2's
  softcap and window, qwen3's qk-norm, kv heads that "model" does not split
  (1 kv head of 6 columns: ``dropped``), a sequence that does not divide
  by "model" (the reference drops ``act_seq``; the residual replicated),
  the tied and softcapped head over a padded vocab (500 -> 512) and an
  untied ``lm_head``; ``transformer.unembed`` on the vocab shards.
* Three train steps (``make_train_step(model, opt, sharder)``, in place)
  of each architecture on (2, 2) with ``train_rules(fsdp=True)`` and on
  (1, 4) with ``build_sharder``'s rules, and of llama3.2-1b on (1, 4) at a
  sequence of 30 (no sequence parallelism), each rank on its rows of a
  global batch of 4, against the JAX package's one-device step and the
  port's one-process step on the whole batch: loss, ce and grad_norm
  within 1e-4 relative each step (``METRIC_TOL``); every gathered
  parameter within 1e-4 x max |ref| plus one bf16 ulp (2^-7) of each
  step's update (x the sum of the three learning rates: AdamW's m /
  sqrt(v) is near 1 in size, so a near-zero gradient's summation order
  moves an update by up to that), the bound of
  ``tests/test_torch_train.py``'s three-step tests; every leaf bit-equal
  on the ranks that replicate it.
* A checkpoint round trip through ``TrainLoop(mesh=)``: written on (2, 2)
  (FSDP), restored on (1, 4), stepped and written there, restored on
  (2, 2); each restore bit-equal to the state that was saved, gathered,
  and each checkpoint bit-equal to it when restored in one process.
"""

import functools
import os
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.distributed.sharding import Sharder as RefSharder
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import Model as RefModel
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.models.loss import chunked_cross_entropy as ref_chunked_ce
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import warmup_cosine as ref_warmup_cosine

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.launch import make_train_step
from repro_torch.models import Model, params_from_reference, spec_leaves
from repro_torch.models.module import ParamSpec, spec_tree_map
from repro_torch.optim import AdamWConfig, adamw_init, warmup_cosine
from repro_torch.tree import tree_map, tree_paths

SRC = __file__.rsplit("/tests/", 1)[0] + "/src"
REF_SH = RefSharder(mesh=None)
WORLD_TIMEOUT_S = 180
ARCHS = ("llama3.2-1b", "internlm2-1.8b", "gemma2-2b", "qwen3-14b")
B, S, S_NO_SP = 4, 32, 30          # global batch; 30 does not divide by 4
LAYER_B = 2
LAYER_TOL = 1e-5
METRIC_TOL = 1e-4
ULP = 2.0 ** -7                    # one bf16 ulp, relative
LR = dict(peak=5e-3, warmup=10, total=10_000)

# train-step cases: (arch, mesh shape, FSDP rules, sequence)
STEP_CASES = {f"{a}/{m}": (a, m, m == "2x2", S) for a in ARCHS
              for m in ("2x2", "1x4")}
STEP_CASES["llama3.2-1b/1x4/seq30"] = ("llama3.2-1b", "1x4", False, S_NO_SP)

# layer cases: (layer, arch, config overrides, sequence)
LAYER_CASES = {
    "attention/gqa_kv_split_mid_head": ("attention", "llama3.2-1b", {}, S),
    "attention/softcap_window": ("attention", "gemma2-2b", {}, S),
    "attention/qk_norm": ("attention", "qwen3-14b", {}, S),
    "attention/kv_dropped": ("attention", "llama3.2-1b",
                             {"n_kv_heads": 1, "head_dim": 6}, S),
    "attention/no_seq_split": ("attention", "llama3.2-1b", {}, S_NO_SP),
    "mlp/gelu": ("mlp", "gemma2-2b", {}, S),
    "mlp/no_seq_split": ("mlp", "llama3.2-1b", {}, S_NO_SP),
    "ce/tied_softcap_padded_vocab": ("ce", "gemma2-2b",
                                     {"vocab_size": 500}, S),
    "ce/untied_head": ("ce", "qwen3-14b", {}, S),
    "ce/no_seq_split": ("ce", "gemma2-2b", {"vocab_size": 500}, S_NO_SP),
}


def _cfgs(arch: str, **over):
    """(JAX smoke config, the port's), f32, with ``over`` applied."""
    jcfg = ref_get_config(arch, smoke=True).replace(
        dtype=jnp.float32, use_pallas=False, **over)
    cfg = get_config(arch, smoke=True).replace(dtype=torch.float32, **over)
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _weights(arch: str, **over):
    """The JAX init of the smoke config, every stacked "scaled" leaf at
    std 1 / sqrt(its fan-in): (numpy tree, JAX tree)."""
    jcfg, cfg = _cfgs(arch, **over)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        RefModel(jcfg).init(jax.random.PRNGKey(0)))
    for path, spec in spec_leaves(Model(cfg, device="cpu").specs()):
        if spec.init == "scaled" and spec.axes[:1] == ("layers",):
            *parents, leaf = path.split("/")
            node = functools.reduce(dict.__getitem__, parents, tree)
            node[leaf] = node[leaf] * np.float32(
                spec.shape[-2] ** -0.5 / spec.std())
    return tree, jax.tree.map(jnp.asarray, tree)


def _tokens(cfg, seq: int) -> np.ndarray:
    """Three global batches (3, B, seq + 1)."""
    return np.random.RandomState(11).randint(0, cfg.vocab_size,
                                             (3, B, seq + 1))


def _layer_inputs(case: str) -> dict:
    layer, arch, over, seq = LAYER_CASES[case]
    jcfg, cfg = _cfgs(arch, **over)
    rng = np.random.RandomState(sum(map(ord, case)))
    out = {"x": rng.randn(LAYER_B, seq, cfg.d_model).astype(np.float32)}
    if layer == "ce":
        out["labels"] = rng.randint(0, cfg.vocab_size, (LAYER_B, seq))
    else:
        out["cot"] = rng.randn(LAYER_B, seq, cfg.d_model).astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------

_WORKER = textwrap.dedent(r'''
    import datetime, sys, warnings
    import numpy as np, torch, torch.distributed as dist
    warnings.filterwarnings("ignore", category=FutureWarning)
    rank, world, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/rendezvous",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=90))
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapePreset
    from repro_torch.distributed import Sharder, train_rules
    from repro_torch.distributed.tensor_parallel import (
        TensorParallel, gather_full, local_tree, mesh_axis,
        same_on_replicas)
    from repro_torch.launch import build_sharder, make_train_step
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import TrainLoop
    from repro_torch.models import Model, layers as L, transformer as T
    from repro_torch.models.loss import chunked_cross_entropy
    from repro_torch.models.module import spec_tree_map
    from repro_torch.optim import AdamWConfig, adamw_init, warmup_cosine
    from repro_torch.tree import tree_leaves, tree_map, tree_paths
    cases = torch.load(f"{d}/cases.pt", weights_only=False)
    meshes = {"2x2": make_mesh((2, 2), ("data", "model"), "cpu"),
              "1x4": make_mesh((1, 4), ("data", "model"), "cpu")}
    out = {}

    def cfg_of(arch, over):
        return get_config(arch, smoke=True).replace(dtype=torch.float32,
                                                    **over)

    def whole(tree, shardings):
        return {p: gather_full(t.detach(), sh.spec, sh.mesh).clone().numpy()
                for (p, t), (_, sh) in zip(tree_paths(tree),
                                           tree_paths(shardings))}

    def layer(name, kind, arch, over, seq, params, inputs):
        cfg = cfg_of(arch, over)
        model = Model(cfg, device="cpu")
        sharder = Sharder(meshes["1x4"], train_rules(False))
        specs = model.specs()
        shardings = spec_tree_map(sharder.param_sharding, specs)
        tp = TensorParallel(sharder, shardings, LAYER_B, seq, cfg.d_model)
        model_ax = mesh_axis(sharder.mesh, "model")
        local = local_tree(params, shardings)
        for t in tree_leaves(local):
            t.requires_grad_(True)
        m = model_ax.size
        x = torch.from_numpy(inputs["x"])
        rows = x.shape[1] // m if tp.seq_split else x.shape[1]
        x = x[:, model_ax.index * rows:(model_ax.index + 1) * rows] \
            if tp.seq_split else x
        x = x.clone().requires_grad_(True)
        if kind == "ce":
            y = chunked_cross_entropy(cfg, local, x,
                                      torch.from_numpy(inputs["labels"]),
                                      tp=tp)
            loss = y
            with torch.no_grad():
                z = T.unembed(cfg, local, torch.from_numpy(inputs["x"]),
                              tp=tp)
            out["unembed/" + name] = gather_full(
                z, (None, None, "model"), sharder.mesh).numpy()
        else:
            p = tp.block(T._group(local["blocks"]["pos0"], 0), "pos0")
            h = L.attention(cfg, p, x, cfg.block_pattern[0], torch.arange(
                seq)[None].expand(LAYER_B, seq), tp=tp) \
                if kind == "attention" else L.mlp(cfg, p, x, tp=tp)
            cot = torch.from_numpy(inputs["cot"])
            if tp.seq_split:
                cot = cot[:, model_ax.index * rows:
                          (model_ax.index + 1) * rows]
                y = gather_full(h.detach(), (None, "model", None),
                                sharder.mesh)
            else:
                cot = cot / m        # each rank holds a share (see module)
                y = h.detach()
            loss = (h * cot).sum()
        loss.backward()
        res = {"y": y.detach().numpy()}
        if tp.seq_split:
            res["dx"] = gather_full(x.grad, (None, "model", None),
                                    sharder.mesh).numpy()
        else:
            g = x.grad.clone()
            dist.all_reduce(g, group=model_ax.group)
            res["dx"] = g.numpy()
        grads = {}
        for (path, t), (_, sh) in zip(tree_paths(local),
                                      tree_paths(shardings)):
            if t.grad is None:
                continue
            g = t.grad.clone()
            if "model" not in sh.spec and "model" not in [
                    a for e in sh.spec if isinstance(e, tuple) for a in e]:
                dist.all_reduce(g, group=model_ax.group)
            grads[path] = gather_full(g, sh.spec, sh.mesh).numpy()
        res["grads"] = grads
        out["layer/" + name] = res

    def step_case(name, arch, mesh_name, fsdp, seq, params, tokens):
        cfg = cfg_of(arch, {})
        model = Model(cfg, device="cpu")
        mesh = meshes[mesh_name]
        preset = ShapePreset("t", "train", seq, tokens.shape[1])
        sharder = (Sharder(mesh, train_rules(True)) if fsdp
                   else build_sharder(cfg, preset, mesh))
        opt = AdamWConfig(lr=warmup_cosine(**LR), weight_decay=0.01)
        step = make_train_step(model, opt, sharder)
        shardings = spec_tree_map(sharder.param_sharding, model.specs())
        p = local_tree(params, shardings)
        st = adamw_init(opt, p)
        n = tokens.shape[1] // sharder.dp_size()
        lo = sharder.dp_rank() * n
        metrics = []
        for b in tokens:
            p, st, m = step(p, st, {"tokens": b[lo:lo + n]})
            metrics.append({k: float(v) for k, v in m.items()})
        out[f"step/{name}"] = {
            "metrics": metrics, "params": whole(p, shardings),
            "replicas_equal": same_on_replicas(
                {"p": p, "mu": st["mu"], "nu": st["nu"]},
                {"p": shardings, "mu": shardings, "nu": shardings}),
            "seq_split": seq % mesh.size(1) == 0}

    def checkpoint_round_trip(params):
        cfg = cfg_of("llama3.2-1b", {})
        preset = ShapePreset("t", "train", S, 4)
        ck = f"{d}/ckpt"
        a = TrainLoop(cfg, preset, mesh=meshes["2x2"], device="cpu",
                      params=params, ckpt_dir=ck, ckpt_every=100,
                      rules=train_rules(True))
        a.restore_or_init()
        a.run(2, log_every=1)
        state = lambda l: {"params": l.params, "mu": l.opt_state["mu"],
                           "nu": l.opt_state["nu"]}
        sh = lambda l: {k: l.shardings for k in ("params", "mu", "nu")}
        out["ckpt/2"] = whole(state(a), sh(a))
        b = TrainLoop(cfg, preset, mesh=meshes["1x4"], device="cpu",
                      ckpt_dir=ck, ckpt_every=100)
        out["ckpt/restored_step_1x4"] = b.restore_or_init()
        out["ckpt/2_on_1x4"] = whole(state(b), sh(b))
        b.run(3, log_every=1)
        out["ckpt/3"] = whole(state(b), sh(b))
        c = TrainLoop(cfg, preset, mesh=meshes["2x2"], device="cpu",
                      ckpt_dir=ck, rules=train_rules(True))
        out["ckpt/restored_step_2x2"] = c.restore_or_init()
        out["ckpt/3_on_2x2"] = whole(state(c), sh(c))

    LAYER_B, S, LR = cases["LAYER_B"], cases["S"], cases["LR"]
    for name, (kind, arch, over, seq, params, inputs) in \
            cases["layers"].items():
        layer(name, kind, arch, over, seq, params, inputs)
    for name, (arch, mesh_name, fsdp, seq, params, tokens) in \
            cases["steps"].items():
        step_case(name, arch, mesh_name, fsdp, seq, params, tokens)
    checkpoint_round_trip(cases["ckpt_params"])
    if rank == 0:
        np.save(f"{d}/out.npy", out, allow_pickle=True)
    dist.barrier()
    dist.destroy_process_group()
''')


def _world(d, n: int = 4) -> dict:
    """Run ``_WORKER`` on n spawned gloo ranks under ``WORLD_TIMEOUT_S``;
    returns rank 0's results.  A rank that fails or a world that hangs
    fails the test with every rank's stderr."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(n), str(d)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)]
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    logs, hung = [], False
    for p in procs:
        try:
            logs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1)))
        except subprocess.TimeoutExpired:
            hung = True
            for q in procs:
                q.kill()
            logs.append(p.communicate())
    if hung or any(p.returncode for p in procs):
        pytest.fail(f"the {n}-rank world "
                    f"{'hung' if hung else 'failed'}:\n" + "\n".join(
                        f"--- rank {r} (rc {p.returncode}) ---\n{err}"
                        for r, (p, (_, err)) in enumerate(zip(procs, logs))))
    return np.load(d / "out.npy", allow_pickle=True).item()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_world")
    layers = {}
    for name, (kind, arch, over, seq) in LAYER_CASES.items():
        tree, _ = _weights(arch, **over)
        layers[name] = (kind, arch, over, seq,
                        params_from_reference(tree, device="cpu"),
                        _layer_inputs(name))
    steps = {}
    for name, (arch, mesh, fsdp, seq) in STEP_CASES.items():
        tree, _ = _weights(arch)
        steps[name] = (arch, mesh, fsdp, seq,
                       params_from_reference(tree, device="cpu"),
                       torch.from_numpy(_tokens(_cfgs(arch)[1], seq)))
    torch.save({"layers": layers, "steps": steps, "LAYER_B": LAYER_B,
                "S": S, "LR": LR,
                "ckpt_params": params_from_reference(
                    _weights("llama3.2-1b")[0], device="cpu")},
               d / "cases.pt")
    return {"out": _world(d), "dir": d}


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), (what, err)


# ---------------------------------------------------------------------------
# layers against the JAX package
# ---------------------------------------------------------------------------

def _ref_layer(case: str):
    """(output, {"dx": input gradient, keystr path: leaf gradient}) of the
    JAX package's layer on the whole inputs."""
    kind, arch, over, seq = LAYER_CASES[case]
    jcfg, _ = _cfgs(arch, **over)
    _, jtree = _weights(arch, **over)
    inputs = _layer_inputs(case)
    x = jnp.asarray(inputs["x"])
    if kind == "ce":
        params = {k: jtree[k] for k in ("embed", "lm_head") if k in jtree}
        labels = jnp.asarray(inputs["labels"])

        def f(x, params):
            return ref_chunked_ce(jcfg, params, x, labels, REF_SH)
        prefix = ""
    else:
        params = {"blocks": {"pos0": jtree["blocks"]["pos0"]}}
        desc = jcfg.block_pattern[0]
        positions = jnp.broadcast_to(jnp.arange(seq)[None], (LAYER_B, seq))
        cot = jnp.asarray(inputs["cot"])

        def f(x, params):
            p = jax.tree.map(lambda a: a[0], params["blocks"]["pos0"])
            y = RL.attention(jcfg, p, x, REF_SH, desc, positions) \
                if kind == "attention" else RL.mlp(jcfg, p, x, REF_SH)
            return jnp.sum(y * cot), y
        prefix = ""
    if kind == "ce":
        y, (dx, dp) = jax.value_and_grad(f, argnums=(0, 1))(x, params)
    else:
        (_, y), (dx, dp) = jax.value_and_grad(f, argnums=(0, 1),
                                              has_aux=True)(x, params)
    grads = {prefix + jax.tree_util.keystr(p): np.asarray(g)
             for p, g in jax.tree_util.tree_flatten_with_path(dp)[0]}
    return np.asarray(y), dict(grads, dx=np.asarray(dx))


@pytest.mark.parametrize("case", sorted(c for c in LAYER_CASES
                                         if c.startswith("ce/")))
def test_unembed_on_the_vocab_shards_matches_the_reference(world, case):
    """``transformer.unembed(tp=)``: each rank's logits over its vocab
    shard (softcap, padded columns at -1e30), gathered, against the JAX
    package's ``unembed`` of the whole head."""
    _, arch, over, _ = LAYER_CASES[case]
    jcfg, _ = _cfgs(arch, **over)
    _, jtree = _weights(arch, **over)
    want = np.asarray(RT.unembed(jcfg, jtree, jnp.asarray(
        _layer_inputs(case)["x"])))
    _close(world["out"]["unembed/" + case], want, LAYER_TOL, case)


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_on_four_ranks_matches_the_reference(world, case):
    got = world["out"]["layer/" + case]
    want_y, want = _ref_layer(case)
    _close(got["y"], want_y, LAYER_TOL, "output")
    _close(got["dx"], want["dx"], LAYER_TOL, "input gradient")
    for path, g in want.items():
        if path == "dx":
            continue
        if not np.any(g):
            continue                      # a leaf the layer does not use
        _close(got["grads"][path], g, LAYER_TOL, path)
    used = [p for p, g in want.items() if p != "dx" and np.any(g)]
    assert used and all(p in got["grads"] for p in used), case


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _one_device_steps(arch: str, seq: int):
    """Three steps of the JAX package's step and of the port's one-process
    step on the whole batches: ((JAX metrics, JAX params), (the port's
    metrics, the port's params))."""
    jcfg, cfg = _cfgs(arch)
    tree, jparams = _weights(arch)
    tokens = _tokens(cfg, seq)
    rcfg = RefAdamWConfig(lr=ref_warmup_cosine(**LR), weight_decay=0.01)
    rstep = jax.jit(ref_make_train_step(RefModel(jcfg), rcfg, REF_SH))
    jp, js = jparams, ref_adamw_init(rcfg, jparams)
    jm = []
    for b in tokens:
        jp, js, m = rstep(jp, js, {"tokens": jnp.asarray(b)})
        jm.append({k: float(v) for k, v in m.items()})
    opt = AdamWConfig(lr=warmup_cosine(**LR), weight_decay=0.01)
    tstep = make_train_step(Model(cfg, device="cpu"), opt)
    tp = params_from_reference(tree, device="cpu")
    ts = adamw_init(opt, tp)
    tm = []
    for b in tokens:
        tp, ts, m = tstep(tp, ts, {"tokens": torch.from_numpy(b)})
        tm.append({k: float(v) for k, v in m.items()})
    ref = {jax.tree_util.keystr(p): np.asarray(v, np.float32)
           for p, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    return (jm, ref), (tm, {p: t.numpy() for p, t in tree_paths(tp)})


@pytest.mark.parametrize("against", ["jax", "port"])
@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_three_train_steps_match_one_device(world, case, against):
    arch, _, _, seq = STEP_CASES[case]
    got = world["out"]["step/" + case]
    jax_run, port_run = _one_device_steps(arch, seq)
    metrics, params = jax_run if against == "jax" else port_run
    lr_sum = 0.0
    for step, (g, w) in enumerate(zip(got["metrics"], metrics)):
        for k in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=METRIC_TOL,
                                       err_msg=f"step {step + 1} {k}")
        lr_sum += w["lr"]
    assert sorted(got["params"]) == sorted(params)
    for path, want in params.items():
        err = float(np.abs(got["params"][path] - want).max())
        assert err <= METRIC_TOL * float(np.abs(want).max()) \
            + ULP * lr_sum, (path, err)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_replicated_leaves_are_bit_equal_on_their_ranks(world, case):
    got = world["out"]["step/" + case]
    assert got["replicas_equal"] is True, got["replicas_equal"]
    assert got["seq_split"] == (STEP_CASES[case][3] == S)


# ---------------------------------------------------------------------------
# checkpoints across meshes
# ---------------------------------------------------------------------------

def _equal(a: dict, b: dict, what: str):
    assert sorted(a) == sorted(b), what
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


def test_a_checkpoint_restores_bit_equal_on_another_mesh(world):
    out = world["out"]
    assert out["ckpt/restored_step_1x4"] == 2
    assert out["ckpt/restored_step_2x2"] == 3
    _equal(out["ckpt/2_on_1x4"], out["ckpt/2"], "(2, 2) -> (1, 4)")
    _equal(out["ckpt/3_on_2x2"], out["ckpt/3"], "(1, 4) -> (2, 2)")


@pytest.mark.parametrize("step", [2, 3])
def test_a_sharded_checkpoint_restores_bit_equal_in_one_process(world, step):
    _, cfg = _cfgs("llama3.2-1b")
    specs = Model(cfg, device="cpu").specs()
    template = {"params": specs,
                "mu": spec_tree_map(lambda s: ParamSpec(s.shape, torch.float32), specs),
                "nu": spec_tree_map(lambda s: ParamSpec(s.shape, torch.float32), specs)}
    tree, _, got = CheckpointManager(str(world["dir"] / "ckpt")).restore(
        template, step=step, device="cpu")
    assert got == step
    _equal({p: t.numpy() for p, t in tree_paths(tree)},
           world["out"][f"ckpt/{step}"], f"step {step}")
