"""internvl2-76b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256.  The InternViT frontend is a stub: the prefill step takes
precomputed patch embeddings (256 per image) and prepends them to the
embedded tokens.  [arXiv:2404.16821; unverified]
"""

from ..models.config import BlockDesc, ModelConfig

ARCH_ID = "internvl2-76b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_kind="vlm",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab_size=128256,
        num_patches=256,
        block_pattern=(BlockDesc(kind="attn"),),
        rope_theta=500000.0,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512, num_patches=8, logits_chunk=64,
        remat="none",
    )
