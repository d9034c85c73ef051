"""The model API: ``Model(cfg)`` over every architecture family.

The JAX package's ``models/api.py``, dispatching on ``cfg.arch_kind``:

* "lm" / "ssm": the decoder-only stack (dense, MoE, hybrid, attention-free);
* "vlm": the decoder LM, whose prefill takes stub patch embeddings as a
  prefix (``launch.steps.make_prefill_step(patches=)``);
* "encdec": whisper: an encoder stack over stub frame embeddings
  (``encoder_cfg``, parameters under ``encoder/``) and the decoder stack
  with cross-attention, whose decode cache carries the static
  cross-attention k / v at the encoder's length.

Parameters, the training loss, the decode cache, one decode step, and the
sequential prefill through decode steps.  A ``Model`` lives on one device,
the card unless the caller passes ``device="cpu"``; without a card it
raises.

Training batches: {"tokens": (B, S + 1) int} for lm / ssm, with "patches"
(B, P, d_model) for a vlm and "frames" (B, encoder_seq, d_model) for an
encdec, as in the JAX package.
"""

from __future__ import annotations

import math

import torch

from ..core.device_model import resolve_device
from . import transformer as T
from .config import BlockDesc, ModelConfig
from .layers import AttnOp, GmmOp, SsdOp
from .loss import lm_loss
from .module import ParamSpec, init_params, param_count

__all__ = ["Model", "resolve_device"]

_KINDS = ("lm", "ssm", "vlm", "encdec")

f32 = torch.float32


def _sinusoid(seq: int, d: int, device) -> torch.Tensor:
    """Whisper's sinusoidal positions (seq, d): sin of the first half of the
    frequencies, cos of the second."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=f32, device=device) / half)
    ang = torch.arange(seq, dtype=f32, device=device)[:, None] \
        * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


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

    # -- training ---------------------------------------------------------------
    def train_loss(self, params: dict, batch: dict,
                   attn_op: AttnOp | None = None,
                   ssd_op: SsdOp | None = None,
                   gmm_op: GmmOp | None = None
                   ) -> tuple[torch.Tensor, dict]:
        """(loss, {"loss", "ce", "router_aux"}) of one batch: next-token
        cross-entropy over the tokens' positions plus the MoE aux loss
        times ``cfg.router_aux_coef``.  A vlm's patch embeddings go first
        and their positions are sliced off before the loss; an encdec's
        frames get the sinusoidal positions and go through the encoder
        stack, non-causal (the prefill step adds no positions to them).
        ``attn_op``, ``ssd_op`` and ``gmm_op`` replace
        ``ops.flash_attention``, ``ops.ssd_scan`` and ``ops.moe_gmm`` as in
        ``transformer.forward``."""
        ops = dict(attn_op=attn_op, ssd_op=ssd_op, gmm_op=gmm_op)
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        x = T.embed_tokens(cfg, params, inputs)
        if cfg.arch_kind == "vlm":
            patches = torch.as_tensor(batch["patches"],
                                      device=self.device).to(x.dtype)
            x = torch.cat([patches, x], dim=1)
            hidden, aux = T.forward(cfg, params, x, **ops)
            hidden = hidden[:, patches.shape[1]:]
        elif cfg.arch_kind == "encdec":
            frames = torch.as_tensor(batch["frames"],
                                     device=self.device).to(x.dtype)
            pos = _sinusoid(frames.shape[1], cfg.d_model,
                            frames.device).to(x.dtype)
            enc_out, _ = T.forward(self.encoder_cfg(), params["encoder"],
                                   frames + pos[None], causal=False,
                                   **ops)
            hidden, aux = T.forward(cfg, params, x, enc_out=enc_out, **ops)
        else:
            hidden, aux = T.forward(cfg, params, x, **ops)
        return lm_loss(cfg, params, hidden, labels, aux)

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
