"""Plain PyTorch versions of the port's kernels (the ref.py contract).

They define correctness: the CPU path runs them, and ``chip_smoke.py`` holds
each CUDA kernel against them on the card. Counterpart of
``src/repro/kernels/ref.py``.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -2.0e38


def flash_attention_oracle(q, k, v, *, scale=None, causal=True, window=0):
    """q (BH, Sq, hd); k/v (BKV, Sk, hd), BH = BKV*G.  Materialized softmax."""
    BH, Sq, hd = q.shape
    BKV, Sk, _ = k.shape
    G = BH // BKV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kx = k.repeat_interleave(G, dim=0)
    vx = v.repeat_interleave(G, dim=0)
    s = torch.einsum("bqh,bsh->bqs", q, kx).float() * scale
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= (qpos - kpos) < window
    s = s.masked_fill(~mask, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bqs,bsh->bqh", w.to(vx.dtype), vx)


def rglru_scan_oracle(a, b):
    """Sequential linear recurrence h_t = a_t h_{t-1} + b_t, h_0 = 0.
    (B,S,C) -> h (B,S,C), in float32."""
    a, b = a.float(), b.float()
    h = a.new_zeros(a.shape[0], a.shape[2])
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1) if hs else torch.zeros_like(a)


def ssd_oracle(x, dt, A, B, C):
    """Fully sequential SSD recurrence (the definition), in float32.

    x (b,s,h,p); dt (b,s,h); A (h,); B,C (b,s,n).
    Returns (y (b,s,h,p), S_final (b,h,n,p))."""
    x, dt, A, B, C = (t.float() for t in (x, dt, A, B, C))
    b, s, h, p = x.shape
    n = B.shape[-1]
    S = torch.zeros(b, h, n, p, dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * A[None, :])                        # (b,h)
        dBx = torch.einsum("bn,bhp->bhnp", B[:, t], x[:, t]) * dt[:, t, :, None, None]
        S = S * decay[:, :, None, None] + dBx
        ys.append(torch.einsum("bn,bhnp->bhp", C[:, t], S))
    y = torch.stack(ys, dim=1) if ys else x.new_zeros(b, 0, h, p)
    return y, S
