"""Model-layout entry points of the kernels (the ops.py contract).

They adapt the model's layouts to the kernels' and call each kernel as an
operator of its own (``torch.ops.repro_torch.*``, registered beside each
wrapper), which dispatches on the device of the tensors: a CUDA tensor
launches the Hopper kernel, a CPU tensor takes the kernel's plain version in
``ref.py``, and a fake tensor gives only the outputs' shapes, so that a
trace (``core/capture.py``) holds one node per kernel call. Counterpart of
``src/repro/kernels/ops.py``.

``flash_attention``, ``ssd`` and ``rglru_scan`` are differentiable: when
autograd needs their gradient they run as ``FlashAttention``, ``SSD`` and
``RGLRU``, whose forwards also keep what the backward reads (the rows'
logsumexp; the per-chunk states, cum and C B^T; the scan's a and h) and
whose backwards are K1's, K2's and K3's backward kernels (the plain
backwards on the CPU).
"""
from __future__ import annotations

import torch

# the modules register the operators of torch.ops.repro_torch
from repro_torch.kernels import flash_attention, rglru, ssd  # noqa: F401

_ops = torch.ops.repro_torch


def _needs_grad(*tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class FlashAttention(torch.autograd.Function):
    """K1 in the kernels' layout, q (BH,Sq,hd), k/v (BKV,Sk,hd): the forward
    saves q, k, v, o and the f32 lse; the backward returns dq, dk, dv."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        o, lse = _ops.flash_attention_fwd_lse(q, k, v, scale, causal, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, window, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, scale = ctx.args
        dq, dk, dv = _ops.flash_attention_bwd(q, k, v, o, lse, do.contiguous(), scale,
                                              causal, window)
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
        o = _ops.flash_attention_fwd(qf, kf, vf, scale, causal, window)
    return o.reshape(B, KV, G, S, hd).movedim(3, 1)


class RGLRU(torch.autograd.Function):
    """K3, a and b (B,S,C) float32: the forward saves a and its output h; the
    backward returns da and db."""

    @staticmethod
    def forward(ctx, a, b):
        h = _ops.rglru_scan_fwd(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        return _ops.rglru_scan_bwd(a, h, dh.contiguous())


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
    return _ops.rglru_scan_fwd(a, b)


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
            y, s_final, *saved = _ops.ssd_fwd_saved(x, dt, A, B, C, chunk)
        else:
            (y, s_final), saved = _ops.ssd_fwd(x, dt, A, B, C, chunk), []
        ctx.save_for_backward(x, dt, A, B, C, *saved)
        ctx.chunk = chunk
        return y, s_final

    @staticmethod
    def backward(ctx, dy, ds_final):
        x, dt, A, B, C, *saved = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        ds_final = None if ds_final is None else ds_final.contiguous()
        states, cum, cb = saved or (None, None, None)
        grads = _ops.ssd_bwd(x, dt, A, B, C, dy, ds_final, states, cum, cb, ctx.chunk)
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
    return _ops.ssd_fwd(x, dt, A, B, C, chunk)
