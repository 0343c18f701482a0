"""Model-layout entry points of the kernels (the ops.py contract).

They adapt the model's layouts to the kernels' and dispatch on the device of
the tensors: a CUDA tensor launches the Hopper kernel, a CPU tensor takes the
kernel's plain version in ``ref.py``. Counterpart of ``src/repro/kernels/ops.py``.
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.rglru import rglru_scan_fwd
from repro_torch.kernels.ssd import ssd_fwd


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


def rglru_scan(a, b):
    """(B,S,C) recurrence coefficients -> h (B,S,C) float32.

    Both go to contiguous float32 first, as the TPU kernel does; its block
    sizes shape only the TPU grid and have no counterpart here."""
    a, b = a.float().contiguous(), b.float().contiguous()
    if a.device.type == "cuda":
        return rglru_scan_fwd(a, b)
    if a.device.type == "cpu":
        return ref.rglru_scan_oracle(a, b)
    raise ValueError(f"rglru_scan: no kernel for device {a.device}")


def ssd(x, dt, A, B, C, *, chunk=256):
    """Mamba2 SSD: x (b,s,h,p); dt (b,s,h); A (h,); B,C (b,s,n) -> (y, S_final).

    Everything goes to float32 first, as the TPU kernel does; ``chunk``
    only shapes the CUDA kernel's work (the plain version is sequential)."""
    x, dt, A, B, C = (t.float().contiguous() for t in (x, dt, A, B, C))
    if x.device.type == "cuda":
        return ssd_fwd(x, dt, A, B, C, chunk=chunk)
    if x.device.type == "cpu":
        return ref.ssd_oracle(x, dt, A, B, C)
    raise ValueError(f"ssd: no kernel for device {x.device}")
