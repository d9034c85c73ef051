"""The model API: ``Model(cfg)`` over every architecture family.

The JAX package's ``models/api.py``, dispatching on ``cfg.arch_kind``:

* "lm" / "ssm": the decoder-only stack (dense, MoE, hybrid, attention-free);
* "vlm": the decoder LM, whose prefill takes stub patch embeddings as a
  prefix (``launch.steps.make_prefill_step(patches=)``);
* "encdec": whisper: an encoder stack over stub frame embeddings
  (``encoder_cfg``, parameters under ``encoder/``) and the decoder stack
  with cross-attention, whose decode cache carries the static
  cross-attention k / v at the encoder's length.

Parameters, the decode cache, one decode step, and the sequential prefill
through decode steps.  Training (``train_loss``) waits with the rest of
training (ROADMAP Queue A item 6).  A ``Model`` lives on one device, the
card unless the caller passes ``device="cpu"``; without a card it raises.
"""

from __future__ import annotations

import torch

from ..core.device_model import resolve_device
from . import transformer as T
from .config import BlockDesc, ModelConfig
from .module import ParamSpec, init_params, param_count

__all__ = ["Model", "resolve_device"]

_KINDS = ("lm", "ssm", "vlm", "encdec")


class Model:
    def __init__(self, cfg: ModelConfig, device: str | torch.device = "cuda"):
        if cfg.arch_kind not in _KINDS:
            raise ValueError(f"unknown arch_kind {cfg.arch_kind!r}; "
                             f"known: {_KINDS}")
        self.cfg = cfg
        self.device = resolve_device(device)

    # -- config helpers ---------------------------------------------------------
    def encoder_cfg(self) -> ModelConfig:
        """Whisper's encoder: bidirectional attention, gelu, one attention
        block per layer, no cross-attention and no MoE."""
        c = self.cfg
        return c.replace(n_layers=c.encoder_layers, causal=False, act="gelu",
                         block_pattern=(BlockDesc(kind="attn"),),
                         n_experts=0)

    # -- parameters -------------------------------------------------------------
    def specs(self) -> dict:
        specs = T.model_specs(self.cfg)
        if self.cfg.arch_kind == "encdec":
            enc = self.encoder_cfg()
            specs["encoder"] = {
                "blocks": T.stack_specs(enc),
                "final_norm": ParamSpec((enc.d_model,), torch.float32,
                                        (None,), "zeros"),
            }
        return specs

    def init(self, seed: int = 0) -> dict:
        """Random weights from a generator on the model's device."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        return init_params(self.specs(), gen)

    def param_count(self) -> int:
        return param_count(self.specs())

    # -- serving ----------------------------------------------------------------
    def cache_specs(self, batch: int, max_seq: int) -> dict:
        cross = self.cfg.encoder_seq if self.cfg.arch_kind == "encdec" else 0
        return T.init_cache_specs(self.cfg, batch, max_seq, cross_seq=cross)

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
