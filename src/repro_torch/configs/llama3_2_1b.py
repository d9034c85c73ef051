"""llama3.2-1b [dense]: 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256.  [hf:meta-llama/Llama-3.2-1B; unverified]"""

from ..models.config import BlockDesc, ModelConfig

ARCH_ID = "llama3.2-1b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_kind="lm",
        n_layers=16,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        head_dim=64,
        d_ff=8192,
        vocab_size=128256,
        block_pattern=(BlockDesc(kind="attn"),),
        rope_theta=500000.0,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512, logits_chunk=64, remat="none",
    )
