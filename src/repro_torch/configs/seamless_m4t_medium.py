"""seamless-m4t-medium [audio]: encoder-decoder, multimodal.

12L d_model=1024 16H (MHA kv=16) d_ff=4096 vocab=256206 [arXiv:2308.11596].
The speech frontend is a STUB: input_specs() provides precomputed frame
embeddings (batch, encoder_len, d_model); the 12-layer bidirectional encoder
and the 12-layer causal decoder (with cross-attention) are real.
"""
from repro_torch.configs.base import GLOBAL_ATTN, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium",
        family="audio",
        num_layers=12,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        vocab_size=256_206,
        superblock=(GLOBAL_ATTN,),
        sb_repeat=12,
        encoder_layers=12,
        encoder_len=1536,       # ~30 s of speech frames after downsampling (stub)
        act="gelu",
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="seamless-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        sb_repeat=2,
        encoder_layers=2,
        encoder_len=24,
    )
