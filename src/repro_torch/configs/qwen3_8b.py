"""qwen3-8b [dense]: qk_norm, GQA.

36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936 [hf:Qwen/Qwen3-8B].
"""
from repro_torch.configs.base import GLOBAL_ATTN, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b",
        family="dense",
        num_layers=36,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=12288,
        vocab_size=151_936,
        superblock=(GLOBAL_ATTN,),
        sb_repeat=36,
        qk_norm=True,
        rope_theta=1_000_000.0,
        act="silu",
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="qwen3-smoke",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        sb_repeat=3,
    )
