"""gemma3-4b [dense]: 5:1 local:global attention, 128k context.

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144 [hf:google/gemma-3 family].
Pattern: (5 local + 1 global) x5 + 4 local remainder (34 layers).
"""
from repro_torch.configs.base import GLOBAL_ATTN, LOCAL_ATTN, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b",
        family="dense",
        num_layers=34,
        d_model=2560,
        num_heads=8,
        num_kv_heads=4,
        head_dim=256,
        d_ff=10240,
        vocab_size=262_144,
        superblock=(LOCAL_ATTN,) * 5 + (GLOBAL_ATTN,),
        sb_repeat=5,
        remainder=(LOCAL_ATTN,) * 4,
        local_window=1024,
        rope_theta=10_000.0,
        rope_theta_global=1_000_000.0,
        qk_norm=True,
        act="gelu",
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="gemma3-4b-smoke",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        superblock=(LOCAL_ATTN, LOCAL_ATTN, GLOBAL_ATTN),
        sb_repeat=1,
        remainder=(LOCAL_ATTN,),
        local_window=32,
    )
