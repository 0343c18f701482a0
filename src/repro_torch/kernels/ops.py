"""Model-layout entry points of the kernels (the ops.py contract).

They adapt the model's layouts to the kernels' and dispatch on the device of
the tensors: a CUDA tensor launches the Hopper kernel, a CPU tensor takes the
kernel's plain version in ``ref.py``. Counterpart of ``src/repro/kernels/ops.py``.

``flash_attention``, ``ssd`` and ``rglru_scan`` are differentiable: when
autograd needs their gradient they run as ``FlashAttention``, ``SSD`` and
``RGLRU``, whose forwards also keep what the backward reads (the rows'
logsumexp; the per-chunk states, cum and C B^T; the scan's a and h) and
whose backwards are K1's, K2's and K3's backward kernels (the plain
backwards on the CPU).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                 flash_attention_fwd)
from repro_torch.kernels.rglru import rglru_scan_bwd, rglru_scan_fwd
from repro_torch.kernels.ssd import ssd_bwd, ssd_fwd


def _needs_grad(*tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class FlashAttention(torch.autograd.Function):
    """K1 in the kernels' layout, q (BH,Sq,hd), k/v (BKV,Sk,hd): the forward
    saves q, k, v, o and the f32 lse; the backward returns dq, dk, dv."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        if q.device.type == "cuda":
            o, lse = flash_attention_fwd(q, k, v, scale=scale, causal=causal,
                                         window=window, return_lse=True)
        else:
            o, lse = ref.flash_attention_oracle(q, k, v, scale=scale, causal=causal,
                                                window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, window, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, scale = ctx.args
        fn = flash_attention_bwd if q.device.type == "cuda" else ref.flash_attention_bwd_oracle
        dq, dk, dv = fn(q, k, v, o, lse, do.contiguous(), scale=scale, causal=causal,
                        window=window)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal=True, window=0, scale=None):
    """Model layout q (B,S,KV,G,hd); k/v (B,Sk,KV,hd) -> (B,S,KV,G,hd).

    Under autograd the kernels' layout is reached by differentiable reshapes,
    so dq, dk and dv come back in the model layout."""
    B, S, KV, G, hd = q.shape
    Sk = k.shape[1]
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    qf = q.movedim(1, 3).reshape(B * KV * G, S, hd).contiguous()
    kf = k.movedim(1, 2).reshape(B * KV, Sk, hd).contiguous()
    vf = v.movedim(1, 2).reshape(B * KV, Sk, hd).contiguous()
    if _needs_grad(q, k, v):
        o = FlashAttention.apply(qf, kf, vf, causal, window, scale)
    else:
        fn = flash_attention_fwd if q.device.type == "cuda" else ref.flash_attention_oracle
        o = fn(qf, kf, vf, scale=scale, causal=causal, window=window)
    return o.reshape(B, KV, G, S, hd).movedim(3, 1)


class RGLRU(torch.autograd.Function):
    """K3, a and b (B,S,C) float32: the forward saves a and its output h; the
    backward returns da and db."""

    @staticmethod
    def forward(ctx, a, b):
        h = rglru_scan_fwd(a, b) if a.device.type == "cuda" else ref.rglru_scan_oracle(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        fn = rglru_scan_bwd if a.device.type == "cuda" else ref.rglru_scan_bwd_oracle
        return fn(a, h, dh.contiguous())


def rglru_scan(a, b):
    """(B,S,C) recurrence coefficients -> h (B,S,C) float32.

    Both go to contiguous float32 first, as the TPU kernel does; its block
    sizes shape only the TPU grid and have no counterpart here. Under
    autograd the call runs as ``RGLRU``."""
    if a.device.type not in ("cuda", "cpu"):
        raise ValueError(f"rglru_scan: no kernel for device {a.device}")
    a, b = a.float().contiguous(), b.float().contiguous()
    if _needs_grad(a, b):
        return RGLRU.apply(a, b)
    if a.device.type == "cuda":
        return rglru_scan_fwd(a, b)
    return ref.rglru_scan_oracle(a, b)


class SSD(torch.autograd.Function):
    """K2 in its own layout, x (b,s,h,p), dt (b,s,h), A (h,), B/C (b,s,n):
    the forward returns (y, S_final) and saves the inputs (and on the card
    the forward's per-chunk states, cum and C B^T); the backward returns dx,
    ddt, dA, dB, dC. A gradient that no one asked for stays None (S_final's,
    in training): the kernel takes it as a null pointer, not as zeros."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        ctx.set_materialize_grads(False)
        if x.device.type == "cuda":
            y, s_final, *saved = ssd_fwd(x, dt, A, B, C, chunk=chunk, return_saved=True)
        else:
            (y, s_final), saved = ref.ssd_oracle(x, dt, A, B, C), []
        ctx.save_for_backward(x, dt, A, B, C, *saved)
        ctx.chunk = chunk
        return y, s_final

    @staticmethod
    def backward(ctx, dy, ds_final):
        x, dt, A, B, C, *saved = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        ds_final = None if ds_final is None else ds_final.contiguous()
        if x.device.type == "cuda":
            grads = ssd_bwd(x, dt, A, B, C, dy, ds_final, *saved, chunk=ctx.chunk)
        else:
            grads = ref.ssd_bwd_oracle(x, dt, A, B, C, dy, ds_final, chunk=ctx.chunk)
        return (*grads, None)


def ssd(x, dt, A, B, C, *, chunk=256):
    """Mamba2 SSD: x (b,s,h,p); dt (b,s,h); A (h,); B,C (b,s,n) -> (y, S_final).

    Everything goes to float32 first, as the TPU kernel does; ``chunk``
    only shapes the CUDA kernels' work (the plain forward is sequential, the
    plain backward chunked). Under autograd the call runs as ``SSD``."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"ssd: no kernel for device {x.device}")
    x, dt, A, B, C = (t.float().contiguous() for t in (x, dt, A, B, C))
    if _needs_grad(x, dt, A, B, C):
        return SSD.apply(x, dt, A, B, C, chunk)
    if x.device.type == "cuda":
        return ssd_fwd(x, dt, A, B, C, chunk=chunk)
    return ref.ssd_oracle(x, dt, A, B, C)
