"""Model-layout entry points of the kernels (the ops.py contract).

They adapt the model's layouts to the kernels' and dispatch on the device of
the tensors: a CUDA tensor launches the Hopper kernel, a CPU tensor takes the
kernel's plain version in ``ref.py``. Counterpart of ``src/repro/kernels/ops.py``.
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_fwd


def flash_attention(q, k, v, *, causal=True, window=0, scale=None):
    """Model layout q (B,S,KV,G,hd); k/v (B,Sk,KV,hd) -> (B,S,KV,G,hd)."""
    B, S, KV, G, hd = q.shape
    Sk = k.shape[1]
    qf = q.movedim(1, 3).reshape(B * KV * G, S, hd).contiguous()
    kf = k.movedim(1, 2).reshape(B * KV, Sk, hd).contiguous()
    vf = v.movedim(1, 2).reshape(B * KV, Sk, hd).contiguous()
    if q.device.type == "cuda":
        fn = flash_attention_fwd
    elif q.device.type == "cpu":
        fn = ref.flash_attention_oracle
    else:
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    o = fn(qf, kf, vf, scale=scale, causal=causal, window=window)
    return o.reshape(B, KV, G, S, hd).movedim(3, 1)
