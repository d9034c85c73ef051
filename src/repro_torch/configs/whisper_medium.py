"""whisper-medium [audio]: enc-dec, 24L d_model=1024 16H (kv=16) d_ff=4096
vocab=51865.  The conv frontend is a stub: the prefill step takes
precomputed frame embeddings (1500 frames).  [arXiv:2212.04356; unverified]

As in the JAX package, decoder self-attention uses RoPE instead of
whisper's learned absolute positions.  The encoder (``Model.encoder_cfg``)
is bidirectional; each decoder block cross-attends to the encoder's output
in prefill, and to the decode cache's static ``xk`` / ``xv`` in decode.
"""

from ..models.config import BlockDesc, ModelConfig

ARCH_ID = "whisper-medium"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_kind="encdec",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        vocab_size=51865,
        encoder_layers=24,
        encoder_seq=1500,
        block_pattern=(BlockDesc(kind="attn", cross_attn=True),),
        act="gelu",
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, encoder_layers=2, encoder_seq=24, d_model=128,
        n_heads=4, n_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512,
        logits_chunk=64, remat="none",
    )
