"""Serving launcher: build a continuous-batching engine for one config.

    from repro_torch.configs import get_config
    from repro_torch.launch import build_engine
    from repro_torch.serving import Request

    engine = build_engine(get_config("llama3.2-1b"), batch=4, max_seq=256)
    engine.submit(Request(rid=0, prompt=[5, 17, 42], max_new_tokens=16))
    done = engine.run()

The engine runs on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

from ..models import Model
from ..models.config import ModelConfig
from ..serving.engine import ServingEngine

__all__ = ["build_engine"]


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
