"""granite-3-8b [dense]: GQA.

40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155 [hf:ibm-granite family].
"""
from repro_torch.configs.base import GLOBAL_ATTN, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b",
        family="dense",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=12800,
        vocab_size=49_155,
        superblock=(GLOBAL_ATTN,),
        sb_repeat=40,
        rope_theta=10_000.0,
        act="silu",
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="granite-smoke",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        sb_repeat=3,
    )
