"""Data-parallel training across the cards of one host, over NCCL::

    PYTHONPATH=src torchrun --nproc-per-node 4 \\
        src/repro_torch/benchmarks/dp_step.py [--arch A] [--steps N] \\
        [--json PATH]

Each process takes the card ``LOCAL_RANK`` and builds the mesh
``make_mesh((world,), ("data",))`` from torchrun's environment; rank 0
builds every kernel source first.  Every rank makes the same weights (the
seeded init, each stacked "scaled" leaf at std 1 / sqrt(fan-in)) and
trains ``--arch`` at full width with ``TrainLoop(mesh=)``, B 8 rows a rank
x S 256 (a global batch of 8 x world rows), for ``--steps`` steps.
Printed by rank 0:

- ms a step (the median of steps 2 on) and tokens/s over the world;
- one more step profiled on rank 0: its device time and its NCCL
  kernels' share;
- the weights before the steps and the parameters and moments after
  them equal on every rank, bit for bit (exact integer sums of each
  leaf's bits, gathered; gated);
- step 1's loss and grad norm against one process's loss and gradient
  norm on the whole global batch on rank 0's card, from the same weights
  (gated at 2e-2 relative, the bf16 kernels' tolerance: the rows' bf16
  roundings differ where a product's batch size does);
- ``TrainLoop(mesh=None)`` at B 8 x S 256 on rank 0 alone, ms a step: the
  same work a rank, without the all-reduces.

The last line is one JSON object.  Needs torchrun and one card a rank.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parents[2]
TRAIN_B, TRAIN_S = 8, 256
SEED = 0
REL_TOL = 2e-2


def _fan_in_scaled(model, params: dict) -> None:
    """Every stacked "scaled" leaf to std 1 / sqrt(its fan-in), in place
    (the reference's init takes the stack's depth as the fan-in)."""
    from repro_torch.models import spec_leaves
    for path, spec in spec_leaves(model.specs()):
        if spec.init == "scaled" and spec.axes[:1] == ("layers",):
            leaf = functools.reduce(dict.__getitem__, path.split("/"),
                                    params)
            leaf.mul_(spec.shape[-2] ** -0.5 / spec.std())


def _bit_sums(tree):
    """One int64 per leaf: the exact sum of its elements' bit patterns."""
    import torch
    from repro_torch.tree import tree_leaves
    return torch.stack([
        t.contiguous().view(torch.int16 if t.element_size() == 2
                            else torch.int32).long().sum()
        for t in tree_leaves(tree)])


def _same_on_every_rank(tree) -> bool:
    import torch
    import torch.distributed as dist
    mine = _bit_sums(tree)
    every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(every, mine)
    return all(torch.equal(mine, other) for other in every)


def _profile(fn) -> tuple[float, float]:
    """(device ms, of it the NCCL kernels' ms) of one call of fn."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = [ev for ev in prof.events()
              if str(ev.device_type).endswith("CUDA")
              and not getattr(ev, "is_user_annotation", False)
              and ev.name != "adamw_update"]

    def ms(evs):
        return sum(ev.time_range.end - ev.time_range.start
                   for ev in evs) / 1e3
    return ms(device), ms([ev for ev in device
                           if "nccl" in ev.name.lower()])


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--json", default=None, help="write rank 0's JSON here")
    args = ap.parse_args(argv)
    if "WORLD_SIZE" not in os.environ:
        raise SystemExit("run it under torchrun, one process a card")
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapePreset
    from repro_torch.data import SyntheticConfig, SyntheticStream
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.launch.train import TrainLoop
    from repro_torch.models import Model
    from repro_torch.optim import global_norm
    from repro_torch.tree import tree_map

    mesh = make_mesh((int(os.environ["WORLD_SIZE"]),), ("data",))
    rank, world = dist.get_rank(), dist.get_world_size()
    if rank == 0:
        t0 = time.perf_counter()
        _build.build_all()
        print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    dist.barrier()
    _build.build_all()                         # rank 0's libraries
    cfg = get_config(args.arch)
    model = Model(cfg)
    params = model.init(SEED)
    _fan_in_scaled(model, params)
    same_init = _same_on_every_rank(params)
    preset = ShapePreset("dp", "train", TRAIN_S, TRAIN_B * world)
    loop = TrainLoop(cfg, preset, mesh=mesh, seed=SEED, params=params)
    loop.init_state()
    torch.cuda.synchronize()
    hist = loop.run(args.steps, log_every=1)
    ms = float(np.median([h["step_time_s"] for h in hist[1:]])) * 1e3
    same_after = _same_on_every_rank({"p": loop.params, **loop.opt_state})
    batch = loop.next_batch()
    device_ms, nccl_ms = _profile(
        lambda: loop.step_fn(loop.params, loop.opt_state, batch))
    del loop
    out = None
    if rank == 0:
        tokens = torch.as_tensor(SyntheticStream(SyntheticConfig(
            cfg.vocab_size, TRAIN_S, TRAIN_B * world, seed=SEED)
        ).next_batch()["tokens"], device=model.device)
        metrics, grads = loss_and_grads(model, params, {"tokens": tokens})
        one = {"loss": float(metrics["loss"]),
               "grad_norm": float(global_norm(grads))}
        del grads
        rel = {k: abs(hist[0][k] - v) / abs(v) for k, v in one.items()}
        alone = TrainLoop(cfg, ShapePreset("one", "train", TRAIN_S, TRAIN_B),
                          seed=SEED, params=params)
        alone.init_state()
        alone_ms = float(np.median([h["step_time_s"] for h in alone.run(
            args.steps, log_every=1)[1:]])) * 1e3
        del alone
        card = torch.cuda.get_device_name(0)
        out = {"arch": args.arch, "world": world, "card": card,
               "batch_per_rank": TRAIN_B, "seq": TRAIN_S,
               "losses": [h["loss"] for h in hist],
               "grad_norms": [h["grad_norm"] for h in hist],
               "ms_per_step": ms,
               "tokens_per_s": TRAIN_B * world * TRAIN_S / ms * 1e3,
               "one_rank_ms_per_step": alone_ms,
               "profiled_device_ms": device_ms, "nccl_ms": nccl_ms,
               "same_weights_before": same_init,
               "same_state_after": same_after,
               "step1_one_process": one, "step1_rel_diff": rel}
        print(f"{args.arch} on {world} x {card}, B {TRAIN_B} a rank x S "
              f"{TRAIN_S}: losses " + ", ".join(f"{x:.5f}" for x in
                                              out["losses"])
              + f"; ms a step {ms:.2f} ({out['tokens_per_s']:.0f} tokens/s)"
              f", one rank alone at B {TRAIN_B} {alone_ms:.2f}; a profiled "
              f"step's device time {device_ms:.2f} ms, NCCL {nccl_ms:.2f} "
              f"ms; weights equal on every rank before {same_init}, state "
              f"after {same_after}; step 1 against one process on the "
              f"global batch: loss {hist[0]['loss']:.6f} / {one['loss']:.6f}"
              f", grad norm {hist[0]['grad_norm']:.6f} / "
              f"{one['grad_norm']:.6f} (rel {rel['loss']:.2e}, "
              f"{rel['grad_norm']:.2e})", flush=True)
        if args.json:
            with open(args.json, "w") as f:
                json.dump(out, f, indent=1)
        print(json.dumps(out), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    if not (same_init and same_after) or (
            out is not None and max(out["step1_rel_diff"].values())
            > REL_TOL):
        raise SystemExit(f"rank {rank}: the ranks' states differ or step 1 "
                         f"is not the global batch's")
    return out or {}


if __name__ == "__main__":
    main()
