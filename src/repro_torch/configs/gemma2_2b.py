"""gemma2-2b [dense]: 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.

Local (4096-window) and global attention alternate, attention and final
logit softcaps, tied embeddings scaled by sqrt(d_model).  Head dim 256: in
bf16 its attention runs the flash kernel's wgmma body at bkv 64.
[arXiv:2408.00118; hf]
"""

from ..models.config import BlockDesc, ModelConfig

ARCH_ID = "gemma2-2b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_kind="lm",
        n_layers=26,
        d_model=2304,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        vocab_size=256000,
        block_pattern=(BlockDesc(kind="attn", window=4096),
                       BlockDesc(kind="attn")),
        attn_softcap=50.0,
        final_softcap=30.0,
        tie_embeddings=True,
        scale_embed=True,
        act="gelu",
        rope_theta=10000.0,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512, logits_chunk=64, remat="none",
        block_pattern=(BlockDesc(kind="attn", window=16),
                       BlockDesc(kind="attn")),
    )
