"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2, Mamba+attention 1:7 interleave.
[arXiv:2403.19887; hf]

Pattern period 8: one attention layer per 8 (position 0), seven Mamba
layers; MoE MLP on alternating (odd) positions, dense MLP on even ones.
One period at full width holds about 90 GB of bf16 weights (four MoE layers
of 16 x 3 x 8192 x 24576 alone are 77.3 GB), more than one 80 GB card, and
``n_layers`` must be a multiple of the period: this configuration runs on
the CPU at its smoke size; on the card it waits for experts sharded over
four cards.
"""

from ..models.config import BlockDesc, ModelConfig

ARCH_ID = "jamba-1.5-large-398b"


def _pattern() -> tuple[BlockDesc, ...]:
    return tuple(BlockDesc(kind="attn" if i == 0 else "mamba",
                           moe=(i % 2 == 1)) for i in range(8))


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_kind="lm",
        n_layers=72,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab_size=65536,
        block_pattern=_pattern(),
        n_experts=16,
        top_k=2,
        moe_d_ff=24576,
        ssm_state=128,
        mamba_head_dim=64,
        mamba_expand=2,
        rope_theta=1000000.0,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=8, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, moe_d_ff=256, n_experts=4, top_k=2, vocab_size=512,
        ssm_state=32, mamba_head_dim=32, logits_chunk=64, remat="none",
    )
