"""mixtral-8x7b [moe]: 8 experts top-2, sliding-window attention.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000 [arXiv:2401.04088].
8 experts do not divide the 16-way model axis, so expert weights are
tensor-parallel over d_ff (moe_strategy="tp"); see DESIGN.md SS5.
"""
from repro_torch.configs.base import LOCAL_ATTN, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=32_000,
        superblock=(LOCAL_ATTN,),     # SWA on every layer
        sb_repeat=32,
        local_window=4096,
        num_experts=8,
        experts_per_token=2,
        rope_theta=1_000_000.0,
        act="silu",
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="mixtral-smoke",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        sb_repeat=3,
        local_window=32,
        num_experts=4,
        experts_per_token=2,
    )
