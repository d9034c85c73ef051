"""The port's ``distributed/`` and data-parallel training against the JAX
package's, on the CPU.

* Sharding: the port's ``Sharder.pspec`` and ``dropped`` equal the JAX
  ``Sharder``'s leaf by leaf, over every full-width ``ParamSpec`` of the
  ten architectures, for both train rules, the three decode modes and
  ``build_sharder``, on meshes (2, 4), (16, 16) and (2, 16, 16); the JAX
  side runs on ``jax.sharding.AbstractMesh`` and the port's on its
  ``AbstractMesh`` (no devices, no processes).  Exact.
* The ``dp_size`` divergence: the reference raises ``KeyError`` on a mesh
  without a "pod" axis, the port counts the absent axis as 1.
* Two spawned gloo worlds (``file://`` rendezvous in ``tmp_path``, every
  rank's stderr in the failure, each world under a timeout):
  - 2 ranks: one data-parallel train step of the f32 smoke llama from
    converted JAX weights on each rank's half of a global batch, against
    the JAX package's one-device step on the whole batch (loss, ce,
    grad_norm 1e-4 relative; every parameter leaf 1e-4 x max |ref|, the
    bounds of ``tests/test_torch_train.py``'s train steps) and against the
    port's one-process step (1e-5); both ranks' trees bit-equal;
    ``TrainLoop(mesh=)`` for 3 steps with checkpoints (rank 0 writes) and
    a resume, against ``TrainLoop(mesh=None)`` (losses 1e-5; leaves 1e-4
    x max |leaf|, the three-step bound of ``tests/test_torch_train.py``:
    AdamW's m / sqrt(v) magnifies the summation-order differences of
    near-zero gradients, as in the norms'); the MoE refusal and
    ``make_production_mesh``'s in a real world.
  - 4 ranks: the collectives on a (2, 2) ("pod", "data") mesh with the
    reference test's numbers (the mean 3.5; the compressed mean within
    0.1), GPipe over 4 stages against the sequential product (the
    reference test's shapes, atol 1e-5), and the elastic restore from a
    (2, 2) mesh onto a (4, 1) mesh, and of a checkpoint the JAX package
    wrote (bit-equal).
* Every refusal, on ``AbstractMesh`` meshes, and ``examples/serve_lm.py``
  on the CPU.
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
from jax.sharding import AbstractMesh as RefAbstractMesh

from repro.checkpoint import CheckpointManager as RefManager
from repro.configs import get_config as ref_get_config
from repro.configs.base import ShapePreset as RefShapePreset
from repro.distributed.sharding import Sharder as RefSharder
from repro.distributed.sharding import decode_rules as ref_decode_rules
from repro.distributed.sharding import train_rules as ref_train_rules
from repro.launch.steps import build_sharder as ref_build_sharder
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import Model as RefModel
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import compress as ref_compress
from repro.optim import warmup_cosine as ref_warmup_cosine

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ShapePreset
from repro_torch.distributed import (Sharder, bubble_fraction,
                                     compressed_pmean, decode_rules,
                                     gpipe_forward, hierarchical_pmean,
                                     train_rules)
from repro_torch.distributed.sharding import TensorSharding
from repro_torch.examples import serve_lm
from repro_torch.launch import build_engine, build_sharder, make_train_step
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.launch.train import TrainLoop
from repro_torch.models import Model, params_from_reference, spec_leaves
from repro_torch.optim import (AdamWConfig, adamw_init, ef_compress_tree,
                               warmup_cosine)
from repro_torch.tree import tree_map, tree_paths

SRC = __file__.rsplit("/tests/", 1)[0] + "/src"
REF_SH = RefSharder(mesh=None)
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# a world's whole run: a hung collective fails the test here (the mesh's
# sub-groups keep torch's 30-minute timeout, whatever the world's)
WORLD_TIMEOUT_S = 180
B, S = 4, 16               # the data-parallel global batch


# ---------------------------------------------------------------------------
# sharding: the port's pspecs and drops against the JAX Sharder's
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _specs(arch: str):
    """(the port's full-width (path, spec) leaves, the JAX spec tree)."""
    return (spec_leaves(Model(get_config(arch), device="cpu").specs()),
            RefModel(ref_get_config(arch)).specs())


def _sharders(case: str, arch: str, mesh: str):
    shape, names = MESHES[mesh]
    port_mesh, ref_mesh = AbstractMesh(shape, names), \
        RefAbstractMesh(shape, names)
    if case.startswith("build_sharder"):
        kind, batch = {"build_sharder_train": ("train", 256),
                       "build_sharder_decode": ("decode", 128),
                       "build_sharder_long": ("decode", 1)}[case]
        return (build_sharder(get_config(arch),
                              ShapePreset("t", kind, 4096, batch), port_mesh),
                ref_build_sharder(ref_get_config(arch),
                                  RefShapePreset("t", kind, 4096, batch),
                                  ref_mesh))
    port_rules, ref_rules = {
        "train_fsdp": (train_rules(True), ref_train_rules(True)),
        "train": (train_rules(False), ref_train_rules(False)),
        "decode_heads": (decode_rules("heads"), ref_decode_rules("heads")),
        "decode_seq": (decode_rules("seq"), ref_decode_rules("seq")),
        "decode_long": (decode_rules("long"), ref_decode_rules("long")),
    }[case]
    return Sharder(port_mesh, port_rules), RefSharder(ref_mesh, ref_rules)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("case", [
    "train_fsdp", "train", "decode_heads", "decode_seq", "decode_long",
    "build_sharder_train", "build_sharder_decode", "build_sharder_long"])
def test_pspec_and_dropped_match_reference_on_every_arch(case, mesh):
    for arch in ARCH_IDS:
        leaves, ref_tree = _specs(arch)
        port, ref = _sharders(case, arch, mesh)
        assert port.rules == ref.rules, (arch, case)
        for path, spec in leaves:
            rspec = functools.reduce(dict.__getitem__, path.split("/"),
                                     ref_tree)
            assert tuple(rspec.shape) == spec.shape and \
                tuple(rspec.axes) == spec.axes, (arch, path)
            axes = spec.axes or (None,) * len(spec.shape)
            got = port.param_sharding(spec).spec
            want = tuple(ref.named(rspec.shape, axes).spec)
            assert got == want, (arch, case, mesh, path, got, want)
        assert port.dropped == ref.dropped, (arch, case, mesh)


def test_dp_size_counts_an_absent_pod_axis_where_the_reference_raises():
    ref = RefSharder(RefAbstractMesh((2, 4), ("data", "model")),
                     ref_train_rules())
    with pytest.raises(KeyError, match="pod"):
        ref.dp_size()
    port = Sharder(AbstractMesh((2, 4), ("data", "model")), train_rules())
    assert port.dp_size() == 2
    assert Sharder(AbstractMesh((2, 16, 16), ("pod", "data", "model")),
                   train_rules()).dp_size() == 32
    assert Sharder(None).dp_size() == 1


def test_placements_are_pod_major_shards():
    from torch.distributed.tensor import Replicate, Shard

    mesh = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    sh = TensorSharding(mesh, (("pod", "data"), None, "model"))
    assert sh.placements == (Shard(0), Shard(0), Shard(2))
    assert sh.sharded_over() == ("pod", "data", "model")
    assert TensorSharding(mesh, (None, None)).placements == \
        (Replicate(),) * 3
    with pytest.raises(ValueError, match="axis order"):
        TensorSharding(mesh, (("data", "pod"),)).placements


def test_bubble_fraction():
    assert bubble_fraction(4, 12) == pytest.approx(3 / 15)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def _smoke(arch="llama3.2-1b"):
    return get_config(arch, smoke=True).replace(dtype=torch.float32)


TP = AbstractMesh((1, 2), ("data", "model"))
PIPE = AbstractMesh((2, 2), ("data", "pipe"))


@pytest.mark.parametrize("case", [
    "moe", "mamba", "hybrid", "whisper", "internvl2", "pipe", "serving"])
def test_unported_meshes_are_refused(case):
    """What ROADMAP Queue A item 6.4 still has to port raises, naming its
    sub-item: a "model" mesh for MoE, Mamba-2, jamba's hybrid, whisper and
    internvl2 train steps, a "pipe" axis in a step, and serving on a
    "model" mesh (``build_engine(mesh=)``).  Every refusal comes before a
    collective (the meshes are abstract)."""
    arch, mesh, item = {
        "moe": ("qwen3-moe-235b-a22b", TP, "6.4.1"),
        "mamba": ("mamba2-130m", TP, "6.4.2"),
        "hybrid": ("jamba-1.5-large-398b", TP, "6.4.1"),
        "whisper": ("whisper-medium", TP, "6.4.3"),
        "internvl2": ("internvl2-76b", TP, "6.4.3"),
        "pipe": ("llama3.2-1b", PIPE, "6.4.6"),
        "serving": ("llama3.2-1b", TP, "6.4.4"),
    }[case]
    cfg = _smoke(arch)
    preset = ShapePreset("t", "train", S, B)
    if case == "serving":
        with pytest.raises(NotImplementedError, match=item):
            build_engine(cfg, 1, 8, mesh=mesh, device="cpu")
        return
    with pytest.raises(NotImplementedError, match=item):
        TrainLoop(cfg, preset, mesh=mesh, device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        make_train_step(Model(cfg, device="cpu"), AdamWConfig(),
                        build_sharder(cfg, preset, mesh))


def test_act_passes_batch_splits_through():
    """``Sharder.act`` checks a rank's block: the batch split over "data"
    and the sequence over "model" pass it through; a tensor of another
    local shape raises, naming item 6.4."""
    sh = Sharder(AbstractMesh((2, 4), ("data", "model")),
                 train_rules(fsdp=False))
    x = torch.zeros(2, 8, 64)
    axes = ("batch", "act_seq", "act_embed")
    assert sh.act(x, axes, (4, 32, 64)) is x
    assert sh.act(torch.zeros(2, 9, 64), axes, (4, 9, 64)) is not None
    for bad in ((4, 8, 64), (2, 32, 64), (2, 8, 16)):
        with pytest.raises(ValueError, match="6.4"):
            sh.act(torch.zeros(bad), axes, (4, 32, 64))
    with pytest.raises(ValueError, match="6.4"):
        sh.act(x, axes)                  # held whole, but split over both
    assert Sharder(None).act(x, ("batch", None, None)) is x
    assert not sh.dropped                # act records no drops


def test_a_parameter_sharded_over_data_is_refused():
    """FSDP: "embed" over "data" (the big archs' rule) runs for the dense
    attention decoders and is refused, naming item 6.4's part, for the
    models whose layers are not ported over a mesh."""
    mesh = AbstractMesh((2,), ("data",))
    make_train_step(Model(_smoke(), device="cpu"), AdamWConfig(),
                    Sharder(mesh, train_rules(fsdp=True)))
    for arch, item in (("mamba2-130m", "6.4.2"), ("whisper-medium", "6.4.3"),
                       ("qwen3-moe-235b-a22b", "6.4.1")):
        cfg = _smoke(arch)
        with pytest.raises(NotImplementedError, match=item):
            make_train_step(Model(cfg, device="cpu"), AdamWConfig(),
                            Sharder(mesh, train_rules(fsdp=True)))
    big = _smoke("mamba2-130m").replace(d_model=4096)  # build_sharder's FSDP
    with pytest.raises(NotImplementedError, match="6.4.2"):
        TrainLoop(big, ShapePreset("t", "train", S, B), mesh=mesh,
                  device="cpu")


def test_moe_under_data_parallelism_is_refused():
    cfg = _smoke("qwen3-moe-235b-a22b")
    sh = build_sharder(cfg, ShapePreset("t", "train", S, B),
                       AbstractMesh((2,), ("data",)))
    with pytest.raises(NotImplementedError, match="MoE"):
        make_train_step(Model(cfg, device="cpu"), AdamWConfig(), sh)


def test_gpipe_refuses_inputs_that_require_grad():
    w = torch.zeros(1, 4, 4, requires_grad=True)
    with pytest.raises(NotImplementedError, match="gradient"):
        gpipe_forward(lambda p, h: h @ p, w, torch.zeros(2, 1, 4), None)
    with pytest.raises(NotImplementedError, match="gradient"):
        gpipe_forward(lambda p, h: h @ p, w.detach(),
                      torch.zeros(2, 1, 4, requires_grad=True), None)


def test_global_batch_must_split_over_the_data_ranks():
    with pytest.raises(ValueError, match="split"):
        TrainLoop(_smoke(), ShapePreset("t", "train", S, 3),
                  mesh=AbstractMesh((2,), ("data",)), device="cpu")


def test_compressed_pmean_without_its_axes_is_the_reference_quantizer():
    """On a mesh with neither axis both stages are skipped: the mean is
    q * scale of the reference's ``compress``, and the residual folds into
    ``ef_compress_tree`` to the residual of the second round."""
    rng = np.random.RandomState(0)
    g = rng.randn(7, 33).astype(np.float32)
    q, scale = ref_compress(jnp.asarray(g))
    want = np.asarray(q, np.float32) * np.float32(scale)
    mesh = AbstractMesh((1,), ("x",))
    tree = {"g": torch.from_numpy(g.copy())}
    assert hierarchical_pmean(mesh, tree)["g"] is tree["g"]
    mean, res = compressed_pmean(mesh, {"g": torch.from_numpy(g.copy())})
    np.testing.assert_array_equal(mean["g"].numpy(), want)
    np.testing.assert_array_equal(res["g"].numpy(),
                                  g - mean["g"].numpy())
    assert float(np.abs(want - g).max()) <= float(scale) / 2
    _, _, err = ef_compress_tree({"g": torch.from_numpy(g)}, res)
    corrected = {"g": torch.from_numpy(g) + res["g"]}
    _, res2 = compressed_pmean(mesh, corrected)
    assert torch.equal(err["g"], res2["g"])


# ---------------------------------------------------------------------------
# the spawned gloo worlds
# ---------------------------------------------------------------------------

_WORKER = textwrap.dedent(r'''
    import datetime, json, os, sys
    import numpy as np, torch, torch.distributed as dist
    role, rank, world, d = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
        sys.argv[4]
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{d}/rendezvous",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=90))
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapePreset
    from repro_torch.distributed import *
    from repro_torch.launch import build_sharder, make_train_step
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    from repro_torch.launch.train import TrainLoop
    from repro_torch.models import Model, ParamSpec
    from repro_torch.optim import AdamWConfig, adamw_init, warmup_cosine
    from repro_torch.tree import tree_map, tree_paths
    out = {}

    def flat(tree, prefix):
        for p, t in tree_paths(tree):
            out[prefix + p] = t.detach().float().numpy()

    def dp():
        B, S = 4, 16
        cfg = get_config("llama3.2-1b", smoke=True).replace(
            dtype=torch.float32)
        preset = ShapePreset("t", "train", S, B)
        mesh = make_mesh((2,), ("data",), "cpu")
        params = torch.load(f"{d}/params.pt")
        tokens = np.load(f"{d}/tokens.npy")
        model = Model(cfg, device="cpu")
        opt = AdamWConfig(lr=warmup_cosine(5e-3, 10, 10_000),
                          weight_decay=0.01)
        step = make_train_step(model, opt, build_sharder(cfg, preset, mesh))
        p = tree_map(torch.clone, params)
        half = B // 2
        p, st, m = step(p, adamw_init(opt, p),
                        {"tokens": tokens[rank * half:(rank + 1) * half]})
        flat(p, "step/")
        out.update({f"metric/{k}": float(v) for k, v in m.items()})
        loop = TrainLoop(cfg, preset, mesh=mesh, device="cpu",
                         params=params, ckpt_dir=f"{d}/ckpt", ckpt_every=2)
        loop.restore_or_init()
        out["loop/losses"] = [h["loss"] for h in loop.run(3, log_every=1)]
        flat({"p": loop.params, **loop.opt_state}, "loop/")
        again = TrainLoop(cfg, preset, mesh=mesh, device="cpu",
                          ckpt_dir=f"{d}/ckpt")
        out["resume/step"] = again.restore_or_init()
        flat({"p": again.params, "mu": again.opt_state["mu"]}, "resume/")
        # whisper and a vlm on ("data" 2, "model" 1): every leaf
        # replicated, so the data-parallel step with their own layers
        mm = make_mesh((2, 1), ("data", "model"), "cpu")
        for arch in ("whisper-medium", "internvl2-76b"):
            c = get_config(arch, smoke=True).replace(dtype=torch.float32)
            m_ = Model(c, device="cpu")
            rng = np.random.RandomState(5)
            batch = {"tokens": rng.randint(0, c.vocab_size, (B, S + 1))}
            if c.arch_kind == "vlm":
                batch["patches"] = rng.randn(B, c.num_patches, c.d_model
                                             ).astype(np.float32)
            else:
                batch["frames"] = rng.randn(B, c.encoder_seq, c.d_model
                                            ).astype(np.float32)
            init = m_.init(0)
            for name, sh, rows in (
                    ("one", None, batch),
                    ("mesh", build_sharder(c, preset, mm),
                     {k: v[rank * half:(rank + 1) * half]
                      for k, v in batch.items()})):
                p = tree_map(torch.clone, init)
                p, _, m = make_train_step(m_, opt, sh)(
                    p, adamw_init(opt, p), rows)
                flat(p, f"mm/{arch}/{name}/")
                out.update({f"mm/{arch}/{name}/metric/{k}": float(v)
                            for k, v in m.items()})
        try:
            moe = get_config("qwen3-moe-235b-a22b", smoke=True)
            make_train_step(Model(moe, device="cpu"), opt,
                            build_sharder(moe, preset, mesh))
        except NotImplementedError as e:
            out["refused/moe"] = str(e)
        try:
            make_production_mesh(device="cpu")
        except ValueError as e:
            out["refused/production"] = str(e)

    def four():
        mesh = make_mesh((2, 2), ("pod", "data"), "cpu")
        x = torch.tensor([[2.0 * rank], [2.0 * rank + 1]]) * torch.ones(2, 16)
        out["pmean"] = hierarchical_pmean(mesh, {"g": x.clone()})["g"].numpy()
        mean, res = compressed_pmean(mesh, {"g": x.clone()})
        out["cmean"] = mean["g"].numpy()
        out["cres"] = res["g"].numpy()
        # GPipe: the reference test's shapes
        rng = np.random.RandomState(0)
        ws = torch.from_numpy((rng.randn(4, 16, 16) * 0.3).astype(np.float32))
        xs = torch.from_numpy(rng.randn(8, 2, 16).astype(np.float32))
        pipe = make_mesh((4,), ("pipe",), "cpu")
        calls = []

        def stage_fn(w, h):
            calls.append(1)
            return torch.tanh(h @ w)
        out["gpipe"] = gpipe_forward(stage_fn, ws, xs, pipe, "pipe").numpy()
        out["gpipe_calls"] = len(calls)
        # elastic: a (2, 2) layout saved, restored onto (4, 1)
        specs = {"w": ParamSpec((8, 16), torch.float32, ("embed", "heads"))}
        w = torch.from_numpy(np.arange(128, dtype=np.float32).reshape(8, 16))
        m1 = make_mesh((2, 2), ("data", "model"), "cpu")
        sh1 = Sharder(m1, train_rules())
        dw = shardings_for_specs(specs, sh1)["w"].distribute(w)
        out["e/local1"] = list(dw.to_local().shape)
        full = dw.full_tensor()
        mgr = CheckpointManager(f"{d}/elastic", async_save=False)
        if rank == 0:
            mgr.save(1, {"w": full})
        dist.barrier()
        m2 = make_mesh((4, 1), ("data", "model"), "cpu")
        got, _, step = elastic_restore(
            mgr, specs, Sharder(m2, train_rules()),
            {"w": ParamSpec((8, 16), torch.float32)})
        out["e/step"] = step
        out["e/local2"] = list(got["w"].to_local().shape)
        out["e/mesh2_data"] = got["w"].device_mesh.size(0)
        out["e/full"] = got["w"].full_tensor().numpy()
        # a checkpoint the JAX package wrote, onto (2, 2)
        rspecs = {"a": ParamSpec((8, 16), torch.float32, ("embed", "heads")),
                  "b": ParamSpec((4, 8), torch.bfloat16, ("heads", None))}
        jgot, aux, _ = elastic_restore(
            CheckpointManager(f"{d}/jax"), rspecs,
            Sharder(m1, train_rules()),
            {k: ParamSpec(s.shape, s.dtype) for k, s in rspecs.items()})
        out["j/aux"] = aux
        for k, t in jgot.items():
            out[f"j/{k}"] = t.full_tensor().float().numpy()
            out[f"j/{k}/local"] = list(t.to_local().shape)

    {"dp": dp, "four": four}[role]()
    np.save(f"{d}/out{rank}.npy", out, allow_pickle=True)
    dist.destroy_process_group()
''')


def _world(d, role: str, n: int) -> list[dict]:
    """Run ``role`` of ``_WORKER`` on n spawned gloo ranks under
    ``WORLD_TIMEOUT_S``; returns each rank's results.  A rank that fails
    or a world that hangs fails the test with every rank's stderr."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, role, str(r), str(n), str(d)],
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
        pytest.fail(f"the {n}-rank {role!r} world "
                    f"{'hung' if hung else 'failed'}:\n" + "\n".join(
                        f"--- rank {r} (rc {p.returncode}) ---\n{err}"
                        for r, (p, (_, err)) in enumerate(zip(procs, logs))))
    return [np.load(d / f"out{r}.npy", allow_pickle=True).item()
            for r in range(n)]


def _fan_in_scaled_llama():
    """The JAX smoke llama (f32) with every stacked "scaled" leaf rescaled
    to std 1 / sqrt(its fan-in), as ``tests/test_torch_train.py`` compares
    train steps."""
    jcfg = ref_get_config("llama3.2-1b", smoke=True).replace(
        dtype=jnp.float32, use_pallas=False)
    jmodel = RefModel(jcfg)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jmodel.init(jax.random.PRNGKey(0)))
    model = Model(_smoke(), device="cpu")
    for path, spec in spec_leaves(model.specs()):
        if spec.init == "scaled" and spec.axes[:1] == ("layers",):
            *parents, leaf = path.split("/")
            node = functools.reduce(dict.__getitem__, parents, tree)
            node[leaf] = node[leaf] * np.float32(
                spec.shape[-2] ** -0.5 / spec.std())
    return jmodel, jax.tree.map(jnp.asarray, tree), model, \
        params_from_reference(tree, device="cpu")


@pytest.fixture(scope="module")
def dp_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp_world")
    jmodel, jparams, model, params = _fan_in_scaled_llama()
    tokens = np.random.RandomState(3).randint(0, model.cfg.vocab_size,
                                              (B, S + 1))
    torch.save(params, d / "params.pt")
    np.save(d / "tokens.npy", tokens)
    outs = _world(d, "dp", 2)
    rcfg = RefAdamWConfig(lr=ref_warmup_cosine(5e-3, 10, 10_000),
                          weight_decay=0.01)
    jp, _, jm = jax.jit(ref_make_train_step(jmodel, rcfg, REF_SH))(
        jparams, ref_adamw_init(rcfg, jparams),
        {"tokens": jnp.asarray(tokens)})
    opt = AdamWConfig(lr=warmup_cosine(5e-3, 10, 10_000), weight_decay=0.01)
    tp = tree_map(torch.clone, params)
    tp, _, tm = make_train_step(model, opt)(tp, adamw_init(opt, tp),
                                            {"tokens": tokens})
    loop = TrainLoop(model.cfg, ShapePreset("t", "train", S, B),
                     device="cpu", params=params)
    loop.init_state()
    hist = loop.run(3, log_every=1)
    return {"outs": outs, "jax": (jp, jm), "port": (tp, tm),
            "loop": (loop, hist)}


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    d = float(np.abs(got - want).max())
    assert d <= tol * max(float(np.abs(want).max()), 1e-30), (what, d)


def test_data_parallel_step_matches_the_reference_one_device_step(dp_world):
    out = dp_world["outs"][0]
    jp, jm = dp_world["jax"]
    for k in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose(out[f"metric/{k}"], float(jm[k]),
                                   rtol=1e-4, err_msg=k)
    for p, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        _close(out["step/" + jax.tree_util.keystr(p)], leaf, 1e-4, p)


def test_data_parallel_step_matches_the_ports_one_process_step(dp_world):
    r0, r1 = dp_world["outs"]
    tp, tm = dp_world["port"]
    for k in ("loss", "ce", "router_aux", "grad_norm", "lr"):
        np.testing.assert_allclose(r0[f"metric/{k}"], float(tm[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    for path, leaf in tree_paths(tp):
        _close(r0["step/" + path], leaf.numpy(), 1e-5, path)
    for k, v in r0.items():                  # both ranks hold one model
        if k.startswith(("step/", "loop/", "metric/")):
            np.testing.assert_array_equal(v, r1[k], err_msg=k)


@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-76b"])
def test_prefix_models_train_data_parallel_on_a_model_axis_of_size_one(
        dp_world, arch):
    """On ("data" 2, "model" 1) whisper's encoder and internvl2's patches
    stay in the step: every leaf is replicated, the layers are the
    one-process ones, and the step is the one-process step on the global
    batch (loss, ce, grad_norm within 1e-5 relative, every parameter
    within 1e-5 x max |leaf|), the same on both ranks."""
    r0, r1 = dp_world["outs"]
    pre = f"mm/{arch}/"
    for k in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose(r0[f"{pre}mesh/metric/{k}"],
                                   r0[f"{pre}one/metric/{k}"], rtol=1e-5,
                                   err_msg=k)
    leaves = [k[len(pre + "one/"):] for k in r0
              if k.startswith(pre + "one/") and "/metric/" not in k]
    assert any(k.startswith("['encoder']") for k in leaves) \
        == (arch == "whisper-medium")
    for path in leaves:
        _close(r0[f"{pre}mesh/{path}"], r0[f"{pre}one/{path}"], 1e-5, path)
        np.testing.assert_array_equal(r0[f"{pre}mesh/{path}"],
                                      r1[f"{pre}mesh/{path}"], err_msg=path)


def test_train_loop_on_a_mesh_matches_the_one_process_loop(dp_world):
    r0 = dp_world["outs"][0]
    loop, hist = dp_world["loop"]
    np.testing.assert_allclose(r0["loop/losses"], [h["loss"] for h in hist],
                               rtol=1e-5)
    for path, leaf in tree_paths({"p": loop.params, **loop.opt_state}):
        _close(r0["loop/" + path], leaf.float().numpy(), 1e-4, path)


def test_train_loop_on_a_mesh_resumes_from_rank_zeros_checkpoint(dp_world):
    for out in dp_world["outs"]:
        assert out["resume/step"] == 3
        for k, v in out.items():
            if k.startswith("resume/"):
                if k == "resume/step":
                    continue
                np.testing.assert_array_equal(
                    v, out["loop/" + k[len("resume/"):]], err_msg=k)


def test_refusals_in_a_data_parallel_world(dp_world):
    for out in dp_world["outs"]:
        assert "MoE" in out["refused/moe"]
        assert "256 ranks" in out["refused/production"] and \
            "the world has 2" in out["refused/production"]


@pytest.fixture(scope="module")
def four_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("four_world")
    rng = np.random.RandomState(7)
    jtree = {"a": rng.randn(8, 16).astype(np.float32),
             "b": jnp.asarray(rng.randn(4, 8), jnp.bfloat16)}
    RefManager(str(d / "jax"), async_save=False).save(
        5, {"a": jnp.asarray(jtree["a"]), "b": jtree["b"]}, aux={"by": "jax"})
    return _world(d, "four", 4), jtree


def test_collectives_over_pod_and_data(four_world):
    """Rank r holds rows (2r, 2r + 1): the rows' means over the four ranks
    are 3 and 4, and their mean is the reference test's 3.5."""
    outs, _ = four_world
    want = np.array([[3.0], [4.0]]) * np.ones((2, 16))
    for out in outs:
        np.testing.assert_array_equal(out["pmean"], want)
        assert float(out["pmean"].mean()) == 3.5
        assert float(np.abs(out["cmean"] - want).max()) < 0.1
        assert abs(float(out["cmean"].mean()) - 3.5) < 0.1


def test_compressed_pmean_residual_is_g_minus_q_scale(four_world):
    """Each rank's residual is its data-mean minus q * scale, with
    scale = max |g| / 127 + 1e-30 (the data stage leaves the rows 4p + 1
    and 4p + 2 on pod p)."""
    outs, _ = four_world
    for r, out in enumerate(outs):
        pod = r // 2
        g = (np.array([[4.0 * pod + 1.0], [4.0 * pod + 2.0]])
             * np.ones((2, 16))).astype(np.float32)
        scale = np.float32(np.abs(g).max() / np.float32(127.0)
                           + np.float32(1e-30))
        q = np.clip(np.round(g / scale), -127, 127)
        np.testing.assert_array_equal(out["cres"], g - q * scale)


def test_gpipe_matches_the_sequential_product(four_world):
    outs, _ = four_world
    rng = np.random.RandomState(0)
    ws = jnp.asarray(rng.randn(4, 16, 16) * 0.3, jnp.float32)
    ref = jnp.asarray(rng.randn(8, 2, 16), jnp.float32)
    for s in range(4):
        ref = jnp.tanh(ref @ ws[s])
    for out in outs:
        np.testing.assert_allclose(out["gpipe"], np.asarray(ref), atol=1e-5)
        assert out["gpipe_calls"] == 8       # no invalid tick computes


def test_elastic_restore_onto_another_mesh_shape(four_world):
    outs, _ = four_world
    w = np.arange(128, dtype=np.float32).reshape(8, 16)
    for out in outs:
        assert out["e/local1"] == [4, 8]       # (2, 2): embed x heads
        assert out["e/step"] == 1
        assert out["e/mesh2_data"] == 4
        assert out["e/local2"] == [2, 16]      # (4, 1)
        np.testing.assert_array_equal(out["e/full"], w)


def test_elastic_restore_of_a_checkpoint_the_reference_wrote(four_world):
    outs, jtree = four_world
    for out in outs:
        assert out["j/aux"] == {"by": "jax"}
        np.testing.assert_array_equal(out["j/a"], jtree["a"])
        np.testing.assert_array_equal(out["j/b"],
                                      np.asarray(jtree["b"], np.float32))
        assert out["j/a/local"] == [4, 8] and out["j/b/local"] == [2, 8]


# ---------------------------------------------------------------------------
# examples/serve_lm.py
# ---------------------------------------------------------------------------

def test_serve_lm_example_sync_and_async(tmp_path, capsys):
    args = ["--device", "cpu", "--requests", "6", "--batch", "4",
            "--max-new", "4"]
    sync, _ = serve_lm.main(args)
    trace = tmp_path / "trace.json"
    done, engine = serve_lm.main(args + ["--async", "--trace", str(trace)])
    assert engine.compile_counts["decode_step"] == 1
    text = capsys.readouterr().out
    for finished in (sync, done):
        assert sorted(r.rid for r in finished) == list(range(6))
        assert all(len(r.output) == 4 for r in finished)
    greedy = {r.rid: r.output for r in sync if r.temperature == 0}
    assert greedy == {r.rid: r.output for r in done if r.temperature == 0}
    assert "tok/s on CPU" in text and "decode-step compile(s)" in text
    assert trace.stat().st_size > 0 and " spans -> " in text
