"""internlm2-1.8b [dense]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544.  [arXiv:2403.17297; hf]"""

from ..models.config import BlockDesc, ModelConfig

ARCH_ID = "internlm2-1.8b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_kind="lm",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=92544,
        block_pattern=(BlockDesc(kind="attn"),),
        rope_theta=1000000.0,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512, logits_chunk=64, remat="none",
    )
