"""mamba2-780m [ssm]: SSD (state-space duality), attention-free.

48L d_model=1536 d_ff=0 vocab=50280 ssm_state=128 [arXiv:2405.21060].
Pure Mamba2 blocks (in_proj -> conv -> SSD scan -> gated out_proj); no MLP.
"""
from repro_torch.configs.base import SSD, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m",
        family="ssm",
        num_layers=48,
        d_model=1536,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=50_280,
        superblock=(SSD,),
        sb_repeat=48,
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        conv_width=4,
        ssm_chunk=256,
        act="silu",
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="mamba2-smoke",
        num_layers=3,
        d_model=64,
        vocab_size=512,
        sb_repeat=3,
        ssm_state=16,
        ssm_head_dim=16,
        ssm_chunk=32,
    )
