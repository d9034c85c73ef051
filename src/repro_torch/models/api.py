"""The model API: ``Model(cfg)`` for the decoder-only stacks.

The JAX package's ``models/api.py`` for ``arch_kind`` "lm" (attention,
with dense or MoE MLPs) and "ssm" (attention-free Mamba-2): parameters,
the decode cache, one decode step, and the sequential prefill through
decode steps.  The other kinds (vlm, encdec) raise and name their ROADMAP
item.  A ``Model`` lives on one device, the card unless the caller passes
``device="cpu"``; without a card it raises.
"""

from __future__ import annotations

import torch

from ..core.device_model import resolve_device
from . import transformer as T
from .config import ModelConfig
from .module import init_params, param_count

__all__ = ["Model", "resolve_device"]

_KINDS = ("lm", "ssm")
_KIND_TODO = {
    "vlm": "ROADMAP Queue A, 'Other architectures'",
    "encdec": "ROADMAP Queue A, 'Other architectures'",
}


class Model:
    def __init__(self, cfg: ModelConfig, device: str | torch.device = "cuda"):
        if cfg.arch_kind not in _KINDS:
            raise NotImplementedError(
                f"arch_kind {cfg.arch_kind!r} is not ported yet "
                f"({_KIND_TODO.get(cfg.arch_kind, 'ROADMAP Queue A')})")
        self.cfg = cfg
        self.device = resolve_device(device)

    # -- parameters -------------------------------------------------------------
    def specs(self) -> dict:
        return T.model_specs(self.cfg)

    def init(self, seed: int = 0) -> dict:
        """Random weights from a generator on the model's device."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        return init_params(self.specs(), gen)

    def param_count(self) -> int:
        return param_count(self.specs())

    # -- serving ----------------------------------------------------------------
    def cache_specs(self, batch: int, max_seq: int) -> dict:
        return T.init_cache_specs(self.cfg, batch, max_seq)

    def init_cache(self, batch: int, max_seq: int) -> dict:
        gen = torch.Generator(device=self.device)
        return init_params(self.cache_specs(batch, max_seq), gen)

    def decode_step(self, params: dict, token: torch.Tensor,
                    pos: torch.Tensor, cache: dict, logits: bool = True
                    ) -> tuple[torch.Tensor | None, dict]:
        return T.decode_step(self.cfg, params, token, pos, cache,
                             logits=logits)

    def prefill(self, params: dict, tokens: torch.Tensor, cache: dict
                ) -> tuple[torch.Tensor, dict]:
        """Sequential prefill through decode steps: tokens (B, S) -> (the
        last step's logits (B, V), cache)."""
        B, S = tokens.shape
        pos = torch.zeros((B,), dtype=torch.int32, device=tokens.device)
        logits = None
        for t in range(S):
            logits, cache = self.decode_step(params, tokens[:, t], pos + t,
                                             cache)
        return logits, cache
