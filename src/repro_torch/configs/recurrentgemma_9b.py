"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, 1:2 attn:recurrent.

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000 [arXiv:2402.19427].
Pattern: (RG-LRU, RG-LRU, local-attn) x12 + 2 RG-LRU remainder.
"""
from repro_torch.configs.base import LOCAL_ATTN, RGLRU, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        num_layers=38,
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256_000,
        superblock=(RGLRU, RGLRU, LOCAL_ATTN),
        sb_repeat=12,
        remainder=(RGLRU, RGLRU),
        local_window=2048,
        rnn_width=4096,
        act="gelu",
        logits_soft_cap=30.0,
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="recurrentgemma-smoke",
        num_layers=5,
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        sb_repeat=1,
        remainder=(RGLRU, RGLRU),
        local_window=32,
        rnn_width=64,
    )
