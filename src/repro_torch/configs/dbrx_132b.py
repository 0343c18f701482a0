"""dbrx-132b [moe]: 16 experts top-4, fine-grained MoE.

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352 [hf:databricks/dbrx-base].
16 experts exactly match the 16-way model axis -> expert parallelism (EP=16).
"""
from repro_torch.configs.base import GLOBAL_ATTN, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b",
        family="moe",
        num_layers=40,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=10752,
        vocab_size=100_352,
        superblock=(GLOBAL_ATTN,),
        sb_repeat=40,
        num_experts=16,
        experts_per_token=4,
        rope_theta=500_000.0,
        act="silu",
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="dbrx-smoke",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        sb_repeat=3,
        num_experts=4,
        experts_per_token=2,
    )
