"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2.  [hf:xai-org/grok-1; unverified]

Attention logits are soft-capped at 30 (the flash kernel's capped path) and
so are the final logits; the head is untied.  Every block's MLP is the MoE
layer, whose expert FFN runs the tuned grouped matmul.
"""

from ..models.config import BlockDesc, ModelConfig

ARCH_ID = "grok-1-314b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_kind="lm",
        n_layers=64,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=32768,
        vocab_size=131072,
        block_pattern=(BlockDesc(kind="attn", moe=True),),
        n_experts=8,
        top_k=2,
        moe_d_ff=32768,
        attn_softcap=30.0,
        final_softcap=30.0,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, moe_d_ff=256, n_experts=4, top_k=2, vocab_size=512,
        logits_chunk=64, remat="none",
    )
