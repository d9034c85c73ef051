"""qwen3-14b [dense]: 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936, qk-norm.  [hf:Qwen/Qwen3-8B; hf]"""

from ..models.config import BlockDesc, ModelConfig

ARCH_ID = "qwen3-14b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_kind="lm",
        n_layers=40,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=17408,
        vocab_size=151936,
        block_pattern=(BlockDesc(kind="attn"),),
        qk_norm=True,
        rope_theta=1000000.0,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512, logits_chunk=64, remat="none",
    )
