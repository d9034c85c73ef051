"""End-to-end training: data pipeline -> train step -> checkpoints.

The JAX package's ``examples/train_lm.py``: a ~100M-parameter llama-family
model on the synthetic stream by default, or with ``--tiny`` the fast
demonstration config (~10M parameters); the loop, the checkpointing and the
loss trend are the same machinery.  It trains on the card (the
hand-written kernels, the flash-attention backward among them) unless
``--device cpu``, where the kernels' plain versions run::

    python -m repro_torch.examples.train_lm --tiny --steps 120 [--device cpu]
"""

from __future__ import annotations

import argparse

from ..configs import get_config
from ..configs.base import ShapePreset
from ..launch.train import TrainLoop
from ..models.api import Model


def model_100m():
    return get_config("llama3.2-1b").replace(
        name="llama-100m", n_layers=8, d_model=768, n_heads=12,
        n_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32000,
        remat="none", logits_chunk=256)


def model_tiny():
    return get_config("llama3.2-1b", smoke=True).replace(
        name="llama-tiny", n_layers=4, d_model=256, n_heads=4, n_kv_heads=2,
        head_dim=64, d_ff=512, vocab_size=2048, logits_chunk=128)


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = model_tiny() if args.tiny else model_100m()
    print(f"arch={cfg.name} "
          f"params={Model(cfg, device='cpu').param_count() / 1e6:.1f}M "
          f"batch={args.batch} seq={args.seq} device={args.device}")

    preset = ShapePreset("train", "train", args.seq, args.batch)
    loop = TrainLoop(cfg, preset, mesh=None, ckpt_dir=args.ckpt_dir,
                     ckpt_every=100, device=args.device)
    loop.restore_or_init()
    hist = loop.run(args.steps, log_every=10)
    for m in hist:
        print(f"step {m['step']:5d}  loss {m['loss']:.4f}  "
              f"lr {m['lr']:.2e}  {m['step_time_s'] * 1e3:.0f} ms/step")
    first, last = hist[0]["loss"], hist[-1]["loss"]
    print(f"\nloss {first:.3f} -> {last:.3f} "
          f"({'DECREASED' if last < first else 'NOT DECREASED'})")
    return hist


if __name__ == "__main__":
    main()
