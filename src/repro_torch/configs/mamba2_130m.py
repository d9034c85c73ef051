"""mamba2-130m [ssm]: 24L d_model=768 (attention-free) vocab=50280,
ssm_state=128 -- SSD (state-space duality).  [arXiv:2405.21060; unverified]

Attention-free: the KLARAPTOR launch parameter here is the SSD chunk length
of the ``ssd_scan`` kernel, which takes the place of attention's tiles.
"""

from ..models.config import BlockDesc, ModelConfig

ARCH_ID = "mamba2-130m"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_kind="ssm",
        n_layers=24,
        d_model=768,
        n_heads=1,            # unused (attention-free)
        n_kv_heads=1,
        head_dim=64,
        d_ff=0,
        vocab_size=50280,
        block_pattern=(BlockDesc(kind="mamba", mlp=False),),
        ssm_state=128,
        mamba_head_dim=64,
        mamba_expand=2,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=128, vocab_size=512, ssm_state=32,
        mamba_head_dim=32, logits_chunk=64, remat="none",
    )
