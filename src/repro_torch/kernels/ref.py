"""Plain PyTorch versions of the port's kernels (the ref.py contract).

They define correctness: the CPU path runs them, and ``chip_smoke.py`` holds
each CUDA kernel against them on the card. Counterpart of
``src/repro/kernels/ref.py``.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -2.0e38


def _scores(q, k, *, scale, causal, window):
    """Scaled, masked scores (BH, Sq, Sk) in at least f32, k repeated over
    the G query heads of each kv head, and the mask (Sq, Sk)."""
    BH, Sq, hd = q.shape
    BKV, Sk, _ = k.shape
    kx = k.repeat_interleave(BH // BKV, dim=0)
    ct = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bqh,bsh->bqs", q, kx).to(ct) * scale
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= (qpos - kpos) < window
    return s.masked_fill(~mask, NEG_INF), mask


def flash_attention_oracle(q, k, v, *, scale=None, causal=True, window=0,
                           return_lse=False):
    """q (BH, Sq, hd); k/v (BKV, Sk, hd), BH = BKV*G.  Materialized softmax.

    With ``return_lse`` also the rows' logsumexp of the scaled, masked
    scores, m + log(l) from the softmax's own max and sum, in at least f32."""
    BH, Sq, hd = q.shape
    BKV = k.shape[0]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    vx = v.repeat_interleave(BH // BKV, dim=0)
    s, _ = _scores(q, k, scale=scale, causal=causal, window=window)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bqs,bsh->bqh", w.to(vx.dtype), vx)
    if not return_lse:
        return o
    m = s.amax(dim=-1)
    return o, m + torch.log(torch.exp(s - m[..., None]).sum(dim=-1))


def flash_attention_bwd_oracle(q, k, v, o, lse, do, *, scale=None, causal=True,
                               window=0):
    """Gradient of ``flash_attention_oracle``, step by step with a
    materialized softmax (the formula of ``csrc/flash_attention_bwd.cu``):
    P = exp(S - lse) on the kept pairs, dV = P^T dO (P rounded to v's dtype
    first, as the forward rounds it), dP = dO V^T, D = rowsum(dO o),
    dS = P (dP - D), dQ = scale dS K, dK = scale dS^T Q; dK and dV summed
    over each kv head's G query heads. Math in at least f32; returns
    (dq, dk, dv) in the inputs' dtypes."""
    BH, Sq, hd = q.shape
    BKV, Sk, _ = k.shape
    G = BH // BKV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    ct = torch.promote_types(q.dtype, torch.float32)
    s, mask = _scores(q, k, scale=scale, causal=causal, window=window)
    p = torch.where(mask, torch.exp(s - lse.to(ct)[..., None]), 0.0)
    qc, kc, vc, oc, dc = (x.to(ct) for x in (q, k, v, o, do))
    kx, vx = kc.repeat_interleave(G, dim=0), vc.repeat_interleave(G, dim=0)
    dv = torch.einsum("bqs,bqh->bsh", p.to(v.dtype).to(ct), dc)
    dp = torch.einsum("bqh,bsh->bqs", dc, vx)
    delta = (dc * oc).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = scale * torch.einsum("bqs,bsh->bqh", ds, kx)
    dk = scale * torch.einsum("bqs,bqh->bsh", ds, qc)
    fold = lambda x: x.reshape(BKV, G, Sk, hd).sum(dim=1)  # noqa: E731
    return dq.to(q.dtype), fold(dk).to(k.dtype), fold(dv).to(v.dtype)


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
