"""Tensor, sequence and FSDP parallel training across the cards of one
host, over NCCL::

    PYTHONPATH=src torchrun --nproc-per-node 4 \\
        src/repro_torch/benchmarks/tp_step.py [--json PATH] \\
        [--qwen-layers N] [--device cpu --smoke]

Each process takes the card ``LOCAL_RANK``; rank 0 builds every kernel
source first.  Weights are the seeded init (each rank drawing its blocks of
the one-process init, ``Model.init(shardings=)``), every stacked "scaled"
leaf then at std 1 / sqrt(fan-in).  Four parts, each through
``TrainLoop``:

(i) llama3.2-1b at full width on (data 1, model 4) and on (data 2,
    model 2), ``build_sharder``'s rules, and on (2, 2) with
    ``train_rules(fsdp=True)`` (FSDP over "data" across ranks), B 8
    global x S 256, 3 steps.
    Gated: step 1's loss and grad norm within 2e-2 relative of one
    process on the global batch from the same whole weights, on rank 0's
    card (the bf16 kernels' tolerance), and every parameter and moment
    leaf bit-equal on the ranks that replicate it
    (``tensor_parallel.same_on_replicas``).
(ii) qwen3-14b at full width on (data 2, model 2) with FSDP over "data",
    tensor and sequence parallelism over "model" (``build_sharder``: its
    d_model is 5120), B 8 global x S 256, 5 steps, no checkpoint.
    Recorded: every step's loss (gated finite), ms a step (the median of
    steps 2 on) and tokens/s, each rank's peak allocated and reserved
    GiB, rank 0's flash forward and backward launches over the steps, and
    one more step profiled on rank 0: its device time and its NCCL
    kernels' (the waits of a collective included).
(iii) (ii) again at a tenth of the peak learning rate (``LR / 10``):
    every step's loss and grad norm (gated finite).
(iv) qwen3-14b cut to ``CUT_LAYERS`` layers on (2, 2) as in (ii), and
    the one-process loop of the same on rank 0's card, 5 steps each:
    every step's loss and grad norm side by side, step 1 gated within
    2e-2 relative.

Rank 0 prints the card's name and power limit (``nvidia-smi``) and, as its
last line, one JSON object.  Needs torchrun and one card a rank; with
``--device cpu --smoke`` it runs the same parts at smoke size on gloo (no
profile, no peak).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parents[2]
TRAIN_B, TRAIN_S = 8, 256
SEED = 0
REL_TOL = 2e-2
LLAMA_STEPS, QWEN_STEPS = 3, 5
LR = 5e-3               # TrainLoop's default peak learning rate
CUT_LAYERS = 4          # (iv): qwen3-14b's depth that fits one card


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def _loop(arch: str, shape: tuple | None, device: str, smoke: bool,
          steps: int, n_layers: int | None = None, rules: dict | None = None,
          lr: float | None = None):
    """A ``TrainLoop`` of ``arch`` on a ("data", "model") mesh of
    ``shape`` (None: one process, no mesh), seeded blocks at std 1 /
    sqrt(fan-in), run ``steps`` steps: (loop, history, model).  ``rules``
    replaces ``build_sharder``'s; ``lr`` the loop's peak learning rate."""
    import torch

    from repro_torch.benchmarks.dp_step import _fan_in_scaled
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapePreset
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import TrainLoop

    cfg = get_config(arch, smoke=smoke)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    if device == "cpu":
        cfg = cfg.replace(dtype=torch.float32)
    mesh = (make_mesh(shape, ("data", "model"), device)
            if shape is not None else None)
    opt = None
    if lr is not None:
        from repro_torch.optim import AdamWConfig, warmup_cosine
        opt = AdamWConfig(lr=warmup_cosine(lr, 10, 10_000),
                          weight_decay=0.01)
    loop = TrainLoop(cfg, ShapePreset("tp", "train", TRAIN_S, TRAIN_B),
                     mesh=mesh, seed=SEED, device=device, rules=rules,
                     opt_cfg=opt)
    loop.init_state()
    _fan_in_scaled(loop.model, loop.params)      # blockwise: per-leaf scale
    if device != "cpu":
        torch.cuda.synchronize()
    hist = loop.run(steps, log_every=1)
    return loop, hist, loop.model


def _one_process(model, seed: int) -> dict:
    """Step 1's loss and grad norm of one process on the global batch,
    from the whole seeded weights."""
    import torch

    from repro_torch.benchmarks.dp_step import _fan_in_scaled
    from repro_torch.data import SyntheticConfig, SyntheticStream
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models.api import Model
    from repro_torch.optim import global_norm

    whole = Model(model.cfg, device=model.device)
    params = whole.init(seed)
    _fan_in_scaled(whole, params)
    tokens = torch.as_tensor(SyntheticStream(SyntheticConfig(
        model.cfg.vocab_size, TRAIN_S, TRAIN_B, seed=seed)
    ).next_batch()["tokens"], device=model.device)
    metrics, grads = loss_and_grads(whole, params, {"tokens": tokens})
    return {"loss": float(metrics["loss"]),
            "grad_norm": float(global_norm(grads))}


def _peaks(device: str) -> list:
    """Every rank's (peak allocated, peak reserved) GiB, gathered."""
    import torch
    import torch.distributed as dist
    if device == "cpu":
        return []
    mine = torch.tensor([torch.cuda.max_memory_allocated(),
                         torch.cuda.max_memory_reserved()],
                        dtype=torch.float64, device="cuda") / 2 ** 30
    every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(every, mine)
    return [t.tolist() for t in every]


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None, help="write rank 0's JSON here")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke configs (with --device cpu on gloo)")
    ap.add_argument("--qwen-layers", type=int, default=None,
                    help="cut qwen3-14b's depth (default: all 40)")
    args = ap.parse_args(argv)
    if "WORLD_SIZE" not in os.environ:
        raise SystemExit("run it under torchrun, one process a card")
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.benchmarks.dp_step import _profile
    from repro_torch.distributed import train_rules
    from repro_torch.distributed.tensor_parallel import same_on_replicas
    from repro_torch.launch.mesh import make_mesh

    dev = args.device
    make_mesh((int(os.environ["WORLD_SIZE"]),), ("data",), dev)
    rank, world = dist.get_rank(), dist.get_world_size()
    if world != 4:
        raise SystemExit(f"tp_step runs on 4 ranks, not {world}")
    card = _card() if rank == 0 and dev != "cpu" else dev
    if dev != "cpu":
        from repro_torch.kernels import _build
        if rank == 0:
            t0 = time.perf_counter()
            _build.build_all()
            print(f"build {time.perf_counter() - t0:.1f} s; card {card}",
                  flush=True)
        dist.barrier()
        _build.build_all()                     # rank 0's libraries
    out = {"card": card, "world": world, "batch": TRAIN_B, "seq": TRAIN_S,
           "llama": {}}
    ok = True

    # -- (i) llama3.2-1b on (1, 4) and (2, 2), and (2, 2) with FSDP -----------
    one = None
    for shape, fsdp in (((1, 4), False), ((2, 2), False), ((2, 2), True)):
        loop, hist, model = _loop("llama3.2-1b", shape, dev, args.smoke,
                                  LLAMA_STEPS,
                                  rules=train_rules(fsdp=True) if fsdp
                                  else None)
        state = {"p": loop.params, "mu": loop.opt_state["mu"],
                 "nu": loop.opt_state["nu"]}
        same = same_on_replicas(state, {k: loop.shardings for k in state})
        ms = float(np.median([h["step_time_s"] for h in hist[1:]])) * 1e3
        del loop, state
        if dev != "cpu":
            torch.cuda.empty_cache()
        if rank == 0 and one is None:
            one = _one_process(model, SEED)
        rel = ({k: abs(hist[0][k] - v) / abs(v) for k, v in one.items()}
               if rank == 0 else {})
        key = "x".join(map(str, shape)) + ("_fsdp" if fsdp else "")
        out["llama"][key] = {
            "losses": [h["loss"] for h in hist],
            "grad_norms": [h["grad_norm"] for h in hist],
            "ms_per_step": ms,
            "tokens_per_s": TRAIN_B * TRAIN_S / ms * 1e3,
            "replicas_equal": same, "step1_one_process": one,
            "step1_rel_diff": rel}
        if rank == 0:
            print(f"(i) llama3.2-1b on (data {shape[0]}, model {shape[1]})"
                  f"{' with FSDP over data' if fsdp else ''}: "
                  f"losses " + ", ".join(f"{h['loss']:.5f}" for h in hist)
                  + f"; grad norms " + ", ".join(
                      f"{h['grad_norm']:.5f}" for h in hist)
                  + f"; ms a step {ms:.2f}; replicated leaves bit-equal "
                  f"{same}; step 1 against one process: loss "
                  f"{hist[0]['loss']:.6f} / {one['loss']:.6f}, grad norm "
                  f"{hist[0]['grad_norm']:.6f} / {one['grad_norm']:.6f} "
                  f"(rel {rel['loss']:.2e}, {rel['grad_norm']:.2e})",
                  flush=True)
            ok &= max(rel.values()) <= REL_TOL
        ok &= same is True

    # -- (ii) qwen3-14b on (2, 2) ---------------------------------------------
    if dev != "cpu":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    from repro_torch.kernels import flash_attention as flash
    counters = {"flash_attention": flash.LAUNCHES,
                "flash_attention_backward": flash.BACKWARD_LAUNCHES}
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    loop, hist, model = _loop("qwen3-14b", (2, 2), dev, args.smoke,
                              QWEN_STEPS, args.qwen_layers)
    wall = time.perf_counter() - t0
    launches = {k: c.count for k, c in counters.items()}
    losses = [h["loss"] for h in hist]
    finite = all(math.isfinite(x) for x in losses)
    ms = float(np.median([h["step_time_s"] for h in hist[1:]])) * 1e3
    peaks = _peaks(dev)
    device_ms = nccl_ms = None
    if dev != "cpu":
        batch = loop.next_batch()
        device_ms, nccl_ms = _profile(
            lambda: loop.step_fn(loop.params, loop.opt_state, batch))
    out["qwen3_14b"] = {
        "n_layers": model.cfg.n_layers, "params": model.param_count(),
        "losses": losses, "grad_norms": [h["grad_norm"] for h in hist],
        "finite": finite, "ms_per_step": ms,
        "tokens_per_s": TRAIN_B * TRAIN_S / ms * 1e3,
        "peak_gib_alloc_reserved_by_rank": peaks,
        "profiled_device_ms": device_ms, "nccl_ms": nccl_ms,
        "flash_launches_rank0": launches, "wall_s_init_and_steps": wall}
    if rank == 0:
        print(f"(ii) qwen3-14b ({model.cfg.n_layers} layers, "
              f"{model.param_count() / 1e9:.2f} B parameters) on (data 2, "
              f"model 2), FSDP + TP + SP: losses " + ", ".join(
                  f"{x:.5f}" for x in losses)
              + f" (finite {finite}); ms a step {ms:.2f} "
              f"({TRAIN_B * TRAIN_S / ms * 1e3:.0f} tokens/s); peak GiB a "
              f"rank (allocated, reserved) {peaks}; a profiled step's "
              f"device time {device_ms} ms, NCCL {nccl_ms} ms; flash "
              f"launches on rank 0 over the steps {launches}; init and "
              f"{QWEN_STEPS} steps {wall:.1f} s", flush=True)
    ok &= finite
    del loop
    if dev != "cpu":
        torch.cuda.empty_cache()

    # -- (iii) the same at a tenth of the peak learning rate -------------------
    _, hist, _ = _loop("qwen3-14b", (2, 2), dev, args.smoke, QWEN_STEPS,
                       args.qwen_layers, lr=LR / 10)
    out["qwen3_14b"]["losses_lr_tenth"] = [h["loss"] for h in hist]
    out["qwen3_14b"]["grad_norms_lr_tenth"] = [h["grad_norm"] for h in hist]
    if rank == 0:
        print(f"(iii) qwen3-14b as in (ii) at peak lr {LR / 10:g} (not "
              f"{LR:g}): losses " + ", ".join(f"{h['loss']:.5f}" for h in hist)
              + "; grad norms " + ", ".join(f"{h['grad_norm']:.5f}"
                                            for h in hist), flush=True)
    ok &= all(math.isfinite(h["loss"]) for h in hist)
    del hist
    if dev != "cpu":
        torch.cuda.empty_cache()

    # -- (iv) qwen3-14b cut to CUT_LAYERS against one process, every step -----
    loop, hist, model = _loop("qwen3-14b", (2, 2), dev, args.smoke,
                              QWEN_STEPS, CUT_LAYERS)
    del loop
    if dev != "cpu":
        torch.cuda.empty_cache()
    cut = {"n_layers": model.cfg.n_layers,
           "losses": [h["loss"] for h in hist],
           "grad_norms": [h["grad_norm"] for h in hist]}
    if rank == 0:
        # rank 0's card alone; the other ranks wait at the barrier below
        solo, shist, _ = _loop("qwen3-14b", None, dev, args.smoke,
                               QWEN_STEPS, CUT_LAYERS)
        del solo
        cut["one_process_losses"] = [h["loss"] for h in shist]
        cut["one_process_grad_norms"] = [h["grad_norm"] for h in shist]
        cut["rel_diff"] = {k: [abs(a[k] - b[k]) / abs(b[k])
                               for a, b in zip(hist, shist)]
                           for k in ("loss", "grad_norm")}
        print(f"(iv) qwen3-14b at {CUT_LAYERS} layers on (data 2, model 2), "
              f"FSDP + TP + SP, against one process: losses " + ", ".join(
                  f"{h['loss']:.5f}" for h in hist) + " / " + ", ".join(
                  f"{h['loss']:.5f}" for h in shist) + "; grad norms "
              + ", ".join(f"{h['grad_norm']:.5f}" for h in hist) + " / "
              + ", ".join(f"{h['grad_norm']:.5f}" for h in shist)
              + "; rel diff loss " + ", ".join(
                  f"{x:.2e}" for x in cut["rel_diff"]["loss"])
              + ", grad norm " + ", ".join(
                  f"{x:.2e}" for x in cut["rel_diff"]["grad_norm"]),
              flush=True)
        ok &= max(cut["rel_diff"][k][0] for k in cut["rel_diff"]) <= REL_TOL
        if dev != "cpu":
            torch.cuda.empty_cache()
    out["qwen3_14b_cut"] = cut
    dist.barrier()
    out["ok"] = bool(ok)
    if rank == 0:
        if args.json:
            with open(args.json, "w") as f:
                json.dump(out, f, indent=1, default=str)
        print(json.dumps(out, default=str), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    if not ok:
        raise SystemExit(f"rank {rank}: a gate failed (see rank 0's line)")
    return out


if __name__ == "__main__":
    main()
