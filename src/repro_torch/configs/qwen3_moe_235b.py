"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) vocab=151936,
MoE 128 experts top-8, expert d_ff=1536, qk-norm.  [hf:Qwen/Qwen3-30B-A3B; hf]

Every block's MLP is the MoE layer (``layers.moe``), whose expert FFN runs
the tuned grouped matmul (``ops.moe_gmm``) on the card.
"""

from ..models.config import BlockDesc, ModelConfig

ARCH_ID = "qwen3-moe-235b-a22b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_kind="lm",
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        head_dim=128,
        d_ff=1536,
        vocab_size=151936,
        block_pattern=(BlockDesc(kind="attn", moe=True),),
        n_experts=128,
        top_k=8,
        moe_d_ff=1536,
        qk_norm=True,
        rope_theta=1000000.0,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=128, moe_d_ff=128, n_experts=8, top_k=2, vocab_size=512,
        logits_chunk=64, remat="none",
    )
