"""gemma3-12b [dense]: 5:1 local:global attention, 128k context.

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144 [hf:google/gemma-3 family].
Pattern: (5 local + 1 global) x8 (48 layers).
"""
from repro_torch.configs.base import GLOBAL_ATTN, LOCAL_ATTN, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b",
        family="dense",
        num_layers=48,
        d_model=3840,
        num_heads=16,
        num_kv_heads=8,
        head_dim=256,
        d_ff=15360,
        vocab_size=262_144,
        superblock=(LOCAL_ATTN,) * 5 + (GLOBAL_ATTN,),
        sb_repeat=8,
        local_window=1024,
        rope_theta=10_000.0,
        rope_theta_global=1_000_000.0,
        qk_norm=True,
        act="gelu",
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="gemma3-12b-smoke",
        num_layers=6,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        superblock=(LOCAL_ATTN, LOCAL_ATTN, GLOBAL_ATTN),
        sb_repeat=2,
        remainder=(),
        local_window=32,
    )
