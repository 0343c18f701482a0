"""Model and parallel configuration schema (the port's copy of
``repro/configs/base.py``).

``ModelConfig``, the layer-kind constants and ``ParallelConfig`` so far; the
shape and system configs come with the slices that use them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

# Layer kinds used in ``layer_pattern``. A model is a stack of "superblocks";
# each superblock is a tuple of layer kinds that repeats ``sb_repeat`` times,
# optionally followed by a remainder pattern.
GLOBAL_ATTN = "global"      # full causal attention
LOCAL_ATTN = "local"        # sliding-window causal attention
CROSS_ATTN = "cross"        # cross-attention to encoder/vision memory
RGLRU = "rglru"             # RG-LRU recurrent block (recurrentgemma)
SSD = "ssd"                 # Mamba2 state-space duality block
ENC_ATTN = "enc"            # bidirectional encoder self-attention

ATTENTION_KINDS = (GLOBAL_ATTN, LOCAL_ATTN, CROSS_ATTN, ENC_ATTN)
RECURRENT_KINDS = (RGLRU, SSD)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int                  # decoder/backbone layers
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # Layer pattern: ``superblock`` repeated ``sb_repeat`` times then
    # ``remainder``. len(superblock)*sb_repeat + len(remainder) == num_layers.
    superblock: tuple = (GLOBAL_ATTN,)
    sb_repeat: int = 0
    remainder: tuple = ()

    # attention details
    local_window: int = 0            # sliding window size for LOCAL_ATTN
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rope_theta_global: float = 0.0   # gemma3 uses a different theta for global layers
    logits_soft_cap: float = 0.0

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    ssm_chunk: int = 256

    # RG-LRU (recurrentgemma)
    rnn_width: int = 0               # recurrence width (d_rnn); 0 -> d_model
    rglru_conv_width: int = 4

    # encoder-decoder (seamless) -- encoder is its own uniform stack
    encoder_layers: int = 0
    encoder_len: int = 0             # stubbed audio-frame count

    # vlm -- cross-attention context from the (stubbed) vision frontend
    context_tokens: int = 0          # image tokens per sample

    act: str = "silu"                # mlp activation: silu (SwiGLU) | gelu (GeGLU)
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    def __post_init__(self):
        got = len(self.superblock) * self.sb_repeat + len(self.remainder)
        if got != self.num_layers:
            raise ValueError(
                f"{self.name}: layer pattern covers {got} layers, "
                f"config says num_layers={self.num_layers}")

    @property
    def layer_kinds(self) -> tuple:
        return tuple(self.superblock) * self.sb_repeat + tuple(self.remainder)

    @property
    def d_inner(self) -> int:        # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def d_rnn(self) -> int:
        return self.rnn_width or self.d_model

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch is not *pure* full attention."""
        return bool(set(self.layer_kinds) & {LOCAL_ATTN, RGLRU, SSD})

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model flops + sanity checks)."""
        d, h, kv, hd, ff, v = (self.d_model, self.num_heads, self.num_kv_heads,
                               self.head_dim, self.d_ff, self.vocab_size)
        n = v * d                                     # embeddings
        if not self.tie_embeddings:
            n += v * d
        glu = 3 if self.act in ("silu", "gelu") else 2

        def attn_params():
            return d * h * hd + 2 * d * kv * hd + h * hd * d

        def mlp_params(e=1):
            return e * glu * d * ff

        for kind in self.layer_kinds:
            n += 2 * d                                # pre-norms (attn + mlp)
            if kind in (GLOBAL_ATTN, LOCAL_ATTN, ENC_ATTN):
                n += attn_params()
                n += mlp_params(self.num_experts or 1)
                if self.num_experts:
                    n += d * self.num_experts         # router
            elif kind == CROSS_ATTN:
                n += attn_params() + mlp_params()
            elif kind == RGLRU:
                dr = self.d_rnn
                n += 2 * d * dr + dr * d              # in(x2)/out proj
                n += self.rglru_conv_width * dr       # temporal conv
                n += 2 * dr                           # gates (a, input)
                n += mlp_params()
            elif kind == SSD:
                di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
                n += d * (2 * di + 2 * ns + nh)       # in_proj (x,z,B,C,dt)
                n += self.conv_width * (di + 2 * ns)  # conv
                n += 2 * nh                           # A_log, D
                n += di * d                           # out_proj
        n += self.encoder_layers * (attn_params() + mlp_params() + 2 * self.d_model)
        n += self.d_model                              # final norm
        return n

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# what each ParallelConfig value that needs a mesh waits for
_NEEDS_MESH = "a device mesh (ROADMAP queue 1, item 5)"


@dataclass(frozen=True)
class ParallelConfig:
    """Software-system knobs (sharding strategy etc.): the JAX package's
    fields and defaults. On one device the trainer reads ``remat``,
    ``microbatches`` and ``grad_compression``. Under a mesh
    (``parallel/sharding.py``) the serving, eval and train steps read the
    sharding knobs fsdp, model_axis, seq_shard and seq_shard_cache through
    the rules; moe_strategy and scan_layers change nothing in the port.
    Values that need what the port has not yet raise: int8 gradient
    compression, pipeline stages, and any attention implementation but the
    default (the port has one per device: K1 on CUDA, its plain version on
    the CPU)."""
    fsdp: bool = True                # shard big params over the data axis too
    model_axis: str = "tp"           # tp | zero3 (what the model axis does)
    seq_shard: bool = True           # sequence-parallel activation constraints
    remat: str = "dots"              # none | dots | full
    microbatches: int = 1            # gradient-accumulation microbatches
    grad_compression: bool = False   # int8 all-reduce with error feedback
    attn_impl: str = "xla"           # xla | pallas | interpret
    moe_strategy: str = "auto"       # auto | ep | tp
    pipeline_stages: int = 1         # >1: GPipe over the "pod" axis
    scan_layers: bool = True
    # decode-time
    seq_shard_cache: bool = False    # shard KV cache over data axis (long ctx)

    def __post_init__(self):
        if self.grad_compression:
            raise NotImplementedError(f"grad_compression needs {_NEEDS_MESH}")
        if self.pipeline_stages > 1:
            raise NotImplementedError(f"pipeline_stages > 1 needs {_NEEDS_MESH}")
        if self.attn_impl != "xla":
            raise NotImplementedError(
                f"attn_impl={self.attn_impl!r}: the port has one attention "
                f"implementation per device; others need {_NEEDS_MESH}")
        if self.remat not in ("none", "dots", "full"):
            raise ValueError(f"remat must be none, dots or full; got {self.remat!r}")
        if self.microbatches < 1:
            raise ValueError(f"microbatches must be >= 1; got {self.microbatches}")

    def replace(self, **kw) -> "ParallelConfig":
        return dataclasses.replace(self, **kw)
