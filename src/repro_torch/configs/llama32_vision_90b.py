"""llama-3.2-vision-90b [vlm]: cross-attn image layers.

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256
[hf:meta-llama/Llama-3.2-11B-Vision scaled family].
Pattern: every 5th layer cross-attends to vision-patch embeddings; the
vision tower is a STUB (input_specs() provides precomputed patch embeddings).
"""
from repro_torch.configs.base import CROSS_ATTN, GLOBAL_ATTN, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b",
        family="vlm",
        num_layers=100,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab_size=128_256,
        superblock=(GLOBAL_ATTN,) * 4 + (CROSS_ATTN,),
        sb_repeat=20,
        context_tokens=1601,    # stubbed vision tokens (1600 patches + CLS)
        rope_theta=500_000.0,
        act="silu",
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="llama-vision-smoke",
        num_layers=5,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        sb_repeat=1,
        context_tokens=17,
    )
