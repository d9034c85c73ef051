"""End-to-end trainer: data pipeline -> train step -> checkpoints.

The JAX package's ``launch/train.py``: the train step of
``launch/steps.py``, async atomic checkpoints with keep-k and resume
(``checkpoint/``), the deterministic resumable data stream (``data/``)
and the step watchdog (``distributed/fault_tolerance``).  It trains on the
card unless ``device="cpu"`` (``--device cpu``).  With ``mesh=`` (a
``DeviceMesh`` of ``launch.mesh.make_mesh``; NCCL on the card, gloo on the
CPU) it trains over the mesh: ``build_sharder`` gives the step's rules,
every rank draws the same global batch from the stream and keeps its rows
by its index over the batch axes alone (``global_batch % dp_size == 0``),
so every rank of one model group reads the same rows.  On a mesh with a
"model" axis or FSDP leaves the loop holds this rank's blocks of the
parameters and moments (``Model.init(shardings=)``: the blocks of the
one-process init) and the step runs tensor parallel (``launch.steps``).
Rank 0 writes the checkpoints, each sharded leaf gathered to its host one
leaf at a time (``CheckpointManager.save(shardings=)``; every rank waits at
a barrier after a blocking save), and every rank restores its blocks
through ``shardings=`` (``distributed.elastic``), from a checkpoint of any
mesh.  A mesh or model the port cannot run raises
``NotImplementedError``.  ``rules=`` replaces ``build_sharder``'s rules
(``distributed.train_rules(fsdp=True)`` forces FSDP on a small model).
``params=`` starts from given whole weights
instead of the seeded init (the tests start both packages' loops from the
same converted weights).  The loop's
own parameter and optimizer trees (``params``, ``opt_state``) are updated
in place by every step (``make_train_step``); ``init_state`` clones a given
``params=``, so the caller's tree is never the one updated.

    python -m repro_torch.launch.train --arch llama3.2-1b --smoke \\
        --device cpu --steps 30 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt
"""

from __future__ import annotations

import argparse
import time

import torch

from ..checkpoint import CheckpointManager
from ..configs import get_config
from ..configs.base import ShapePreset
from ..data import Prefetcher, SyntheticConfig, SyntheticStream
from ..distributed import Sharder, Watchdog, elastic_restore
from ..distributed.tensor_parallel import local_tree, sharded_step
from ..models.api import Model
from ..models.module import ParamSpec, spec_tree_map
from ..optim import AdamWConfig, adamw_init, warmup_cosine
from ..tree import tree_map
from .steps import build_sharder, make_train_step

__all__ = ["TrainLoop", "main"]


class TrainLoop:
    def __init__(self, cfg, preset: ShapePreset, mesh=None,
                 opt_cfg: AdamWConfig | None = None,
                 ckpt_dir: str | None = None, ckpt_every: int = 50,
                 keep: int = 3, seed: int = 0,
                 watchdog_timeout: float = 0.0,
                 device: str | torch.device = "cuda",
                 params: dict | None = None, rules: dict | None = None):
        self.sharder = None
        if mesh is not None:
            self.sharder = (Sharder(mesh, rules) if rules is not None
                            else build_sharder(cfg, preset, mesh))
        dp = self.sharder.dp_size() if mesh is not None else 1
        if preset.global_batch % dp:
            raise ValueError(f"global batch {preset.global_batch} does not "
                             f"split over {dp} data-parallel ranks")
        self.cfg = cfg
        self.preset = preset
        opt_cfg = opt_cfg or AdamWConfig(
            lr=warmup_cosine(5e-3, 10, 10_000), weight_decay=0.01)
        self.model = Model(cfg, device=device)
        self.opt_cfg = opt_cfg
        self.mesh = mesh
        self.step_fn = make_train_step(self.model, opt_cfg, self.sharder)
        if mesh is not None and mesh.device_type != self.model.device.type:
            raise ValueError(f"a {mesh.device_type} mesh cannot train a "
                             f"model on {self.model.device}")
        # this rank's blocks of every leaf (None: each rank holds them whole)
        self.shardings = None
        if sharded_step(self.sharder, self.model.specs(), cfg):
            self.shardings = spec_tree_map(self.sharder.param_sharding,
                                           self.model.specs())
        rank = self.sharder.dp_rank() if mesh is not None else 0
        self.rows = (rank * (preset.global_batch // dp),
                     preset.global_batch // dp)     # this rank's rows
        self.writer = mesh is None or torch.distributed.get_rank() == 0
        self.manager = (CheckpointManager(ckpt_dir, keep=keep)
                        if ckpt_dir else None)
        self.ckpt_every = ckpt_every
        self.seed = seed
        self.watchdog = (Watchdog(watchdog_timeout).start()
                         if watchdog_timeout > 0 else None)
        self.stream = SyntheticStream(SyntheticConfig(
            vocab_size=cfg.vocab_size, seq_len=preset.seq_len,
            global_batch=preset.global_batch, seed=seed))
        self.prefetch = Prefetcher(self.stream)
        self.initial_params = params
        self.params = None
        self.opt_state = None
        self.step = 0

    # -- state ----------------------------------------------------------------
    def init_state(self) -> None:
        """The seeded init (or a clone of the ``params=`` given: the steps
        update the loop's trees in place), fresh AdamW state."""
        if self.initial_params is not None:
            self.params = tree_map(
                lambda p: p.detach().to(self.model.device).clone(),
                self.initial_params)
            if self.shardings is not None:
                self.params = local_tree(self.params, self.shardings)
        else:
            self.params = self.model.init(self.seed, self.shardings)
        self.opt_state = adamw_init(self.opt_cfg, self.params)
        self.step = 0

    def _template(self) -> dict:
        specs = self.model.specs()

        def state(s):
            return ParamSpec(s.shape, self.opt_cfg.state_dtype)
        return {"params": specs, "mu": spec_tree_map(state, specs),
                "nu": spec_tree_map(state, specs)}

    def restore_or_init(self) -> int:
        if self.manager is not None and self.manager.latest_step() is not None:
            template = self._template()
            if self.sharder is not None:
                # each rank's block of every leaf
                specs = self.model.specs()
                tree, aux, step = elastic_restore(
                    self.manager, {k: specs for k in template},
                    self.sharder, template)
                tree = tree_map(lambda t: t.to_local().contiguous(), tree)
            else:
                tree, aux, step = self.manager.restore(
                    template, device=self.model.device)
            self.params = tree["params"]
            self.opt_state = {"mu": tree["mu"], "nu": tree["nu"],
                              "step": torch.tensor(step, dtype=torch.int32,
                                                   device=self.model.device)}
            self.step = step
            self.stream.load_state_dict(aux["stream"])
            self.prefetch.load_state_dict(aux["prefetch"])
        else:
            self.init_state()
        return self.step

    def save(self, block: bool = False) -> None:
        """Checkpoint the loop (on rank 0 of a mesh, every rank taking part
        in gathering the sharded leaves; after a blocking save every rank
        waits for it at a barrier)."""
        if self.manager is None:
            return
        tree = {"params": self.params, "mu": self.opt_state["mu"],
                "nu": self.opt_state["nu"]}
        aux = {"stream": self.stream.state_dict(),
               "prefetch": self.prefetch.state_dict()}
        if self.shardings is not None:
            self.manager.save(self.step, tree, aux=aux, block=block,
                              shardings={k: self.shardings for k in tree})
        elif self.writer:
            self.manager.save(self.step, tree, aux=aux, block=block)
        if block and self.mesh is not None:
            torch.distributed.barrier()

    def next_batch(self) -> dict:
        """This rank's rows of the stream's next batch as tensors on the
        model's device (a vlm's zero patches, an encdec's zero frames)."""
        cfg, dev = self.cfg, self.model.device
        lo, n = self.rows
        batch = {k: torch.as_tensor(v[lo:lo + n], device=dev)
                 for k, v in self.prefetch.next_batch().items()}
        B = batch["tokens"].shape[0]
        if cfg.arch_kind == "vlm":
            batch["patches"] = torch.zeros(
                (B, cfg.num_patches, cfg.d_model), dtype=cfg.dtype,
                device=dev)
        elif cfg.arch_kind == "encdec":
            batch["frames"] = torch.zeros(
                (B, cfg.encoder_seq, cfg.d_model), dtype=cfg.dtype,
                device=dev)
        return batch

    # -- loop -----------------------------------------------------------------
    def run(self, n_steps: int, log_every: int = 10,
            fail_at: int | None = None) -> list[dict]:
        """Run n_steps; ``fail_at`` injects a crash (fault-tolerance tests).
        A logged step's ``step_time_s`` runs from the call of the step to
        after its metrics are read (which waits for the card)."""
        history = []
        while self.step < n_steps:
            batch = self.next_batch()
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            self.step += 1
            if fail_at is not None and self.step == fail_at:
                raise RuntimeError("injected failure")
            if self.watchdog is not None:
                self.watchdog.beat()
            if self.step % log_every == 0 or self.step == n_steps:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = self.step
                m["step_time_s"] = time.perf_counter() - t0
                history.append(m)
            if self.manager is not None and self.step % self.ckpt_every == 0:
                self.save()
        if self.manager is not None:
            self.save(block=True)
            if self.writer:
                self.manager.wait()
        return history


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; the hand-written kernels) or "
                         "cpu (their plain versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    preset = ShapePreset("cli", "train", args.seq, args.batch)
    loop = TrainLoop(cfg, preset, mesh=None, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every, device=args.device)
    loop.restore_or_init()
    hist = loop.run(args.steps, log_every=args.log_every)
    for m in hist:
        print(f"step {m['step']:5d}  loss {m['loss']:.4f}  "
              f"grad_norm {m.get('grad_norm', 0.0):.3f}  "
              f"{m['step_time_s'] * 1e3:.0f} ms")


if __name__ == "__main__":
    main()
