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
    (B,S,C) -> h (B,S,C), in at least float32 (float64 inputs stay float64)."""
    ct = torch.promote_types(a.dtype, torch.float32)
    a, b = a.to(ct), b.to(ct)
    h = a.new_zeros(a.shape[0], a.shape[2])
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1) if hs else torch.zeros_like(a)


def rglru_scan_bwd_oracle(a, h, dh):
    """Gradient of ``rglru_scan_oracle`` given its output h and dh: the
    reverse scan g_t = dh_t + a_{t+1} g_{t+1} (g past the end is 0), then
    db_t = g_t and da_t = g_t h_{t-1} (h_{-1} = 0, so da_0 = 0). Each step
    rounds a_{t+1} g_{t+1}, then adds dh_t, as ``csrc/rglru_bwd.cu`` does.
    (B,S,C) -> (da, db), in at least float32 (float64 inputs stay float64)."""
    ct = torch.promote_types(a.dtype, torch.float32)
    a, h, dh = a.to(ct), h.to(ct), dh.to(ct)
    S = a.shape[1]
    gs = [None] * S
    for t in reversed(range(S)):
        gs[t] = dh[:, t] if t == S - 1 else dh[:, t] + a[:, t + 1] * gs[t + 1]
    if not gs:
        return torch.zeros_like(a), torch.zeros_like(a)
    g = torch.stack(gs, dim=1)
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    return g * h_prev, g


def ssd_oracle(x, dt, A, B, C):
    """Fully sequential SSD recurrence (the definition), in at least float32
    (float64 inputs stay float64).

    x (b,s,h,p); dt (b,s,h); A (h,); B,C (b,s,n).
    Returns (y (b,s,h,p), S_final (b,h,n,p))."""
    ct = torch.promote_types(x.dtype, torch.float32)
    x, dt, A, B, C = (t.to(ct) for t in (x, dt, A, B, C))
    b, s, h, p = x.shape
    n = B.shape[-1]
    S = torch.zeros(b, h, n, p, dtype=ct, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * A[None, :])                        # (b,h)
        dBx = torch.einsum("bn,bhp->bhnp", B[:, t], x[:, t]) * dt[:, t, :, None, None]
        S = S * decay[:, :, None, None] + dBx
        ys.append(torch.einsum("bn,bhnp->bhp", C[:, t], S))
    y = torch.stack(ys, dim=1) if ys else x.new_zeros(b, 0, h, p)
    return y, S


def ssd_bwd_oracle(x, dt, A, B, C, dy, dS_final=None, *, chunk, matmul=torch.einsum):
    """Gradient of ``ssd_oracle``'s (y, S_final) given dy and dS_final (None
    is zero), step by step in the chunked form of ``csrc/ssd_bwd.cu``.

    Chunks of Q = min(chunk, s) rows (the last one padded with zeros); within
    a chunk cum = cumsum(dt A), w = dt, M_ij = (C_i . B_j) exp(cum_i - cum_j)
    for j <= i (selected, never multiplied), G_ij = dy_i . x_j, and S_prev,
    dS_out the state entering the chunk and the gradient of the one leaving
    it (a reverse pass over the chunks: dS_prev = exp(cum_Q) dS_out +
    sum_i exp(cum_i) C_i^T dy_i). Then
      dx_j  = w_j [sum_i M_ij dy_i + exp(cum_Q - cum_j) B_j dS_out],
      dC_i  = sum_j (sum_h P)_ij B_j + sum_h exp(cum_i) dy_i S_prev^T,
      dB_j  = sum_i (sum_h P)_ij C_i + sum_h exp(cum_Q - cum_j) w_j x_j dS_out^T,
            P_ij = G_ij w_j L_ij summed over the heads before it meets B and C
            (the same for every head), as the kernel multiplies them,
      dw_j  = sum_i M_ij G_ij + exp(cum_Q - cum_j) (B_j dS_out) . x_j,
      dcum  = rows of T minus columns of T (T_ij = M_ij w_j G_ij)
              + exp(cum_i) C_i . (dy_i S_prev^T) - u_j, the last row also
              + sum_j u_j + exp(cum_Q) <dS_out, S_prev>, where
              u_j = exp(cum_Q - cum_j) w_j (B_j dS_out) . x_j,
    da = the in-chunk reverse cumsum of dcum, ddt = dw + A da, dA = sum dt da.
    ``matmul`` computes each product the kernel puts on its tensor cores
    (einsum; the tests pass an emulation of the kernel's 3xTF32). Math in at
    least float32; returns (dx, ddt, dA, dB, dC)."""
    ct = torch.promote_types(x.dtype, torch.float32)
    x, dt, A, B, C, dy = (t.to(ct) for t in (x, dt, A, B, C, dy))
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s == 0:
        return (torch.zeros_like(x), torch.zeros_like(dt), torch.zeros_like(A),
                torch.zeros_like(B), torch.zeros_like(C))
    Q = min(chunk, s)
    nc = -(-s // Q)
    pad = nc * Q - s
    F = torch.nn.functional
    xc, dyc = (F.pad(t, (0, 0, 0, 0, 0, pad)).reshape(b, nc, Q, h, p) for t in (x, dy))
    w = F.pad(dt, (0, 0, 0, pad)).reshape(b, nc, Q, h)
    Bc, Cc = (F.pad(t, (0, 0, 0, pad)).reshape(b, nc, Q, n) for t in (B, C))

    cum = torch.cumsum(w * A, dim=2)                                  # (b,nc,Q,h)
    cum_q = cum[:, :, -1]                                              # (b,nc,h)
    e_i = torch.exp(cum)                                               # exp(cum_i)
    e_j = torch.exp(cum_q[:, :, None] - cum)                           # exp(cum_Q - cum_j)
    causal = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    L = torch.where(causal[None, None, :, :, None],
                    torch.exp(cum[:, :, :, None] - cum[:, :, None, :]), 0.0)  # (b,nc,Q,Q,h)
    cb = matmul("bcin,bcjn->bcij", Cc, Bc)

    # the forward's states: S_prev entering each chunk
    s_own = matmul("bcjn,bcjhp->bchnp", Bc, xc * (w * e_j)[..., None])
    decay = torch.exp(cum_q)
    run, s_prev = x.new_zeros(b, h, n, p), []
    for c in range(nc):
        s_prev.append(run)
        run = decay[:, c, :, None, None] * run + s_own[:, c]
    s_prev = torch.stack(s_prev, dim=1)                                # (b,nc,h,n,p)

    # the reverse pass: dS_out leaving each chunk
    ds_own = matmul("bcin,bcihp->bchnp", Cc, dyc * e_i[..., None])
    run = x.new_zeros(b, h, n, p) if dS_final is None else dS_final.to(ct)
    ds_out = [None] * nc
    for c in reversed(range(nc)):
        ds_out[c] = run
        run = decay[:, c, :, None, None] * run + ds_own[:, c]
    ds_out = torch.stack(ds_out, dim=1)                                # (b,nc,h,n,p)

    M = cb[..., None] * L                                              # (b,nc,Q,Q,h)
    G = matmul("bcihp,bcjhp->bcijh", dyc, xc)
    P = G * w[:, :, None] * L                                          # G_ij w_j L_ij
    bds = matmul("bcjn,bchnp->bcjhp", Bc, ds_out)                      # B_j dS_out
    dys = matmul("bcihp,bchnp->bcihn", dyc, s_prev)                    # dy_i S_prev^T
    xds = matmul("bcjhp,bchnp->bcjhn", xc, ds_out)                     # x_j dS_out^T
    dx = w[..., None] * (matmul("bcijh,bcihp->bcjhp", M, dyc) + e_j[..., None] * bds)
    Ps = P.sum(-1)                                # sum_h P: B and C are the same for every head
    dC = matmul("bcij,bcjn->bcin", Ps, Bc) + (e_i[..., None] * dys).sum(3)
    dB = matmul("bcij,bcin->bcjn", Ps, Cc) + ((e_j * w)[..., None] * xds).sum(3)
    state = e_j * (bds * xc).sum(-1)                                   # (b,nc,Q,h)
    dw = (M * G).sum(2) + state
    u = w * state
    T = M * G * w[:, :, None]
    dcum = T.sum(3) - T.sum(2) + e_i * (Cc[:, :, :, None, :] * dys).sum(-1) - u
    dcum[:, :, -1] += u.sum(2) + decay * (ds_out * s_prev).sum((-2, -1))
    da = dcum.flip(2).cumsum(2).flip(2)
    ddt = dw + A * da
    dA = (w * da).sum((0, 1, 2))
    return (dx.reshape(b, nc * Q, h, p)[:, :s], ddt.reshape(b, nc * Q, h)[:, :s], dA,
            dB.reshape(b, nc * Q, n)[:, :s], dC.reshape(b, nc * Q, n)[:, :s])
