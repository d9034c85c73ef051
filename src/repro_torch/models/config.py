"""Model configuration: the JAX package's ``ModelConfig``, field for field.

``BlockDesc`` describes one layer position inside the repeating pattern
(period); the stack repeats it ``n_layers // period`` times.  ``dtype`` is a
torch dtype.  The JAX config's ``use_pallas`` has no counterpart: a tensor on
a CUDA device goes to the port's kernels and a tensor on the CPU to their
plain versions.  ``remat`` and ``scan_layers`` shape the JAX package's traced
program; the port runs eagerly and keeps them only so that a config reads
the same in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import torch

__all__ = ["BlockDesc", "ModelConfig"]


@dataclass(frozen=True)
class BlockDesc:
    kind: str = "attn"              # "attn" | "mamba"
    window: int | None = None       # sliding-window width for local attention
    moe: bool = False               # MoE MLP instead of dense MLP
    mlp: bool = True                # has an MLP sub-layer at all
    cross_attn: bool = False        # whisper decoder blocks


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    arch_kind: str = "lm"           # lm | encdec | vlm | ssm
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 2
    head_dim: int = 64
    d_ff: int = 1024
    vocab_size: int = 1024

    # repeating block pattern; len(block_pattern) == period
    block_pattern: tuple[BlockDesc, ...] = (BlockDesc(),)

    # attention details
    rope_theta: float = 10000.0
    qk_norm: bool = False
    attn_softcap: float | None = None
    final_softcap: float | None = None
    rms_eps: float = 1e-6
    act: str = "silu"               # silu | gelu
    causal: bool = True
    tie_embeddings: bool = False
    scale_embed: bool = False       # gemma-style sqrt(d_model) embed scaling

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_group: int = 1024

    # Mamba-2 (SSD)
    ssm_state: int = 0
    mamba_head_dim: int = 64
    mamba_expand: int = 2
    conv_kernel: int = 4

    # encoder-decoder / frontend stubs
    encoder_layers: int = 0
    encoder_seq: int = 0
    num_patches: int = 0

    # numerics / execution
    dtype: Any = torch.bfloat16
    remat: str = "full"             # JAX-side only (see module docstring)
    logits_chunk: int = 1024
    attn_chunk: int | None = 1024   # query chunk of the plain (CPU) attention
    scan_layers: bool = True        # JAX-side only (see module docstring)
    vocab_pad_multiple: int = 256

    # -- derived -------------------------------------------------------------
    @property
    def period(self) -> int:
        return len(self.block_pattern)

    @property
    def n_groups(self) -> int:
        if self.n_layers % self.period:
            raise ValueError(f"{self.n_layers} layers not divisible by "
                             f"period {self.period}")
        return self.n_layers // self.period

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def mamba_heads(self) -> int:
        return self.mamba_d_inner // self.mamba_head_dim

    @property
    def mamba_conv_dim(self) -> int:
        return self.mamba_d_inner + 2 * self.ssm_state

    def replace(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    def has_block(self, kind: str) -> bool:
        return any(b.kind == kind for b in self.block_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True if decode cost is sub-quadratic in context (ssm / hybrid)."""
        return self.has_block("mamba")
