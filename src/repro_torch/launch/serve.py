"""Serving launcher: build a continuous-batching engine for one config.

    from repro_torch.configs import get_config
    from repro_torch.launch import build_engine
    from repro_torch.serving import Request

    engine = build_engine(get_config("llama3.2-1b"), batch=4, max_seq=256)
    engine.submit(Request(rid=0, prompt=[5, 17, 42], max_new_tokens=16))
    done = engine.run()

The engine runs on the card unless the caller passes ``device="cpu"``.

From the command line (random weights from a seed):

    python -m repro_torch.launch.serve --arch llama3.2-1b --requests 8 \\
        --max-new 12 --auto-kernels

``--auto-kernels`` introspects the auto-specced kernels (the fused
layernorm + residual at the config's d_model and the blocked column sum),
tunes each against the card (``CudaEventTimer``; ``HopperModel`` only with
``--device cpu``) and prints one line per kernel before serving.  The JAX
launcher's ``--telemetry``, ``--plans``, ``--trace``, ``--ledger``,
``--dash``, ``--async`` and ``--buckets`` wait for their modules (ROADMAP
Queue A, 'Rest of the serving slice').
"""

from __future__ import annotations

import argparse
from typing import Sequence

import torch

from ..configs import get_config
from ..models import Model
from ..models.config import ModelConfig
from ..serving.engine import Request, ServingEngine

__all__ = ["build_auto_kernels", "build_engine", "main"]


def build_engine(cfg: ModelConfig, batch: int, max_seq: int,
                 params: dict | None = None, seed: int = 0,
                 eos_id: int = 1,
                 device: str | torch.device = "cuda") -> ServingEngine:
    """An engine over ``cfg`` with ``params`` (seeded random weights if
    None) on ``device``."""
    model = Model(cfg, device=device)
    if params is None:
        params = model.init(seed)
    return ServingEngine(model, params, batch=batch, max_seq=max_seq,
                         eos_id=eos_id, seed=seed)


# Configurations probed at each probe size of an auto kernel: all nine of the
# layernorm's row tiles (a sample of eight left one out at each size, at r
# 8192 the only probe of many small CTAs, br 8), twelve of the column sum's
# 36 tiles.
AUTO_PROBES_PER_SIZE = 12


def build_auto_kernels(d_model: int = 1024, tune_device=None,
                       device: str | torch.device = "cuda"):
    """Introspect the auto-specced kernels (layernorm fusion at ``d_model``,
    blocked column reduction) -- no hand-written spec code.

    Registers come from the compiled kernels on a CUDA ``device`` and from
    their ``__launch_bounds__`` caps with ``device="cpu"``.  With
    ``tune_device`` (a DeviceModel) each kernel that has no registered
    driver gets one built immediately (collect -> fit -> codegen); otherwise
    dispatch uses the kernels' defaults until one is built.
    """
    from ..introspect import auto_register
    from ..kernels.layernorm import LAYERNORM, layernorm_grid_spec
    from ..kernels.reduce import COLSUM, colsum_grid_spec

    kernels = [
        auto_register(LAYERNORM, layernorm_grid_spec(d_model),
                      device=device),
        auto_register(COLSUM, colsum_grid_spec(), device=device),
    ]
    if tune_device is not None:
        for ak in kernels:
            ak.ensure_driver(tune_device, repeats=2,
                             max_configs_per_size=AUTO_PROBES_PER_SIZE)
    return kernels


def main(argv: Sequence[str] | None = None) -> list[Request]:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Serve a few requests of one config with random weights.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--auto-kernels", action="store_true",
                    help="introspect + tune the auto-specced kernels "
                         "(layernorm fusion, blocked column reduction): "
                         "zero hand-written spec code")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.auto_kernels:
        from ..core.device_model import CudaEventTimer, HopperModel

        tune = (HopperModel() if torch.device(args.device).type == "cpu"
                else CudaEventTimer(device=args.device))
        for ak in build_auto_kernels(d_model=cfg.d_model, tune_device=tune,
                                     device=args.device):
            cap = ak.capture
            print(f"auto kernel {ak.name}: "
                  f"{len(ak.spec.operands)} operands, "
                  f"grid rank {len(ak.spec.grid)}, "
                  f"constraints {list(ak.spec.constraints)}, "
                  f"kernel hash {ak.spec.source_fingerprint}, "
                  f"registers {cap.num_regs} ({cap.attributes_source}; "
                  f"launch-bounds cap {cap.regs_cap})", flush=True)
    engine = build_engine(cfg, args.batch, args.max_seq, device=args.device)
    for i in range(args.requests):
        prompt = [2 + (i * 7 + j) % (cfg.vocab_size - 3)
                  for j in range(4 + i % 4)]
        engine.submit(Request(rid=i, prompt=prompt,
                              max_new_tokens=args.max_new))
    finished = engine.run()
    for r in sorted(finished, key=lambda r: r.rid):
        print(f"req {r.rid}: prompt={r.prompt} -> output={r.output}")
    return finished


if __name__ == "__main__":
    main()
