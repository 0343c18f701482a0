"""Mamba2 block: in_proj -> causal conv -> SSD (state-space duality) -> gated out.

Counterpart of ``repro/models/ssm.py``. The full-sequence SSD scan goes
through ``kernels.ops.ssd`` (the Hopper kernel on a CUDA tensor, its plain
version on a CPU tensor); ``ssd_chunked`` is the JAX model's default XLA
path, kept as a plain function and held against its JAX original and the
oracle in the tests. Single-token decode is plain PyTorch, as in the JAX
package. Every cast sits where the JAX code has it, so bf16 rounds at the
same places.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import ParamSpec

CACHE_CONV_DTYPE = torch.bfloat16    # the conv history is bf16 whatever the params


def ssd_specs(cfg):
    """in_proj is split (x/z/B/C/dt), as in the JAX package."""
    d, di, n, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * n
    return {
        "in_x": ParamSpec((d, di), ("embed", "inner")),
        "in_z": ParamSpec((d, di), ("embed", "inner")),
        "in_B": ParamSpec((d, n), ("embed", None)),
        "in_C": ParamSpec((d, n), ("embed", None)),
        "in_dt": ParamSpec((d, nh), ("embed", "heads")),
        "conv_w": ParamSpec((cfg.conv_width, conv_dim), (None, "inner")),
        "conv_b": ParamSpec((conv_dim,), ("inner",), init="zeros"),
        "dt_bias": ParamSpec((nh,), (None,), init="zeros", dtype=torch.float32),
        "A_log": ParamSpec((nh,), (None,), init="ones", dtype=torch.float32),
        "D": ParamSpec((nh,), (None,), init="ones", dtype=torch.float32),
        "out_proj": ParamSpec((di, d), ("inner", "embed")),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv via shifted adds.  x (B,S,C); w (W,C)."""
    W, S = w.shape[0], x.shape[1]
    out = x * w[-1]
    for i in range(1, W):
        shifted = F.pad(x, (0, 0, i, 0))[:, :S]
        out = out + shifted * w[W - 1 - i]
    return out + b


def ssd_chunked(x, dt, A, B, C, chunk):
    """SSD scan.  x (b,s,h,p); dt (b,s,h); A (h,); B,C (b,s,n) (one group).

    Returns (y (b,s,h,p), S_final (b,h,n,p)).  Everything in f32.
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    S = s + pad
    nc = S // chunk
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, n)
    Cc = C.reshape(b, nc, chunk, n)

    a = dtc * A[None, None, None, :]                      # (b,nc,Q,h) log-decay
    cum = torch.cumsum(a, dim=2)                          # inclusive
    # intra-chunk: scores[i,j] = (C_i . B_j) * exp(cum_i - cum_j) * dt_j
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (b,nc,Q,Q,h)
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=x.device))
    L = torch.where(causal[None, None, :, :, None], torch.exp(seg), 0.0)
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)          # (b,nc,Q,Q)
    scores = cb[..., None] * L * dtc[:, :, None, :, :]    # (b,nc,Q,Q,h)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores, xc)

    # chunk states: S_c = sum_j exp(cum_last - cum_j) dt_j B_j (x) x_j
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)        # (b,nc,Q,h)
    wB = Bc[:, :, :, None, :] * (dtc * decay_end)[..., None]   # (b,nc,Q,h,n)
    S_c = torch.einsum("bcjhn,bcjhp->bchnp", wB, xc)      # (b,nc,h,n,p)

    # inter-chunk recurrence: S_c passed on with decay exp(sum a over chunk)
    chunk_decay = torch.exp(cum[:, :, -1, :])             # (b,nc,h)
    S_run = torch.zeros(b, h, n, p, dtype=torch.float32, device=x.device)
    S_prevs = []
    for c in range(nc):
        S_prevs.append(S_run)                             # state entering chunk c
        S_run = S_run * chunk_decay[:, c, :, None, None] + S_c[:, c]
    S_prevs = torch.stack(S_prevs, dim=1)                 # (b,nc,h,n,p)

    # inter-chunk contribution: y_i += C_i . (exp(cum_i) * S_prev)
    y_inter = torch.einsum("bcin,bchnp->bcihp", Cc, S_prevs) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(b, S, h, p)[:, :s]
    return y, S_run


def ssd_block_apply(p, x, cfg, ctx, collect_cache=False):
    """Full mamba2 mixer.  x (B,S,D) -> (out (B,S,D), cache|None)."""
    B_, S_, _ = x.shape
    di, n, nh, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z = torch.einsum("bsd,de->bse", x, p["in_z"])
    xBC_raw = torch.cat([
        torch.einsum("bsd,de->bse", x, p["in_x"]),
        torch.einsum("bsd,dn->bsn", x, p["in_B"]),
        torch.einsum("bsd,dn->bsn", x, p["in_C"])], dim=-1)
    dt = torch.einsum("bsd,dh->bsh", x, p["in_dt"])
    xBC = F.silu(_causal_conv(xBC_raw, p["conv_w"], p["conv_b"]))
    xs, Bs, Cs = torch.split(xBC, [di, n, n], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(B_, S_, nh, hp).float()
    y, S_final = ops.ssd(xh, dt, A, Bs.float(), Cs.float(), chunk=cfg.ssm_chunk)
    cache = None
    if collect_cache:
        cw = cfg.conv_width
        conv_buf = xBC_raw[:, -(cw - 1):]
        if S_ < cw - 1:
            conv_buf = F.pad(xBC_raw, (0, 0, cw - 1 - S_, 0))
        # a copy, so the cache keeps no view of the (B,S,conv_dim) buffer
        cache = {"state": S_final,
                 "conv": conv_buf.to(CACHE_CONV_DTYPE, copy=True)}
    y = y + p["D"][None, None, :, None] * xh
    y = y.reshape(B_, S_, di).to(x.dtype)
    y = y * F.silu(z)
    return torch.einsum("bse,ed->bsd", y, p["out_proj"]), cache


# ---------------------------------------------------------------------------
# decode (single-token recurrence)
# ---------------------------------------------------------------------------

def init_ssd_cache(cfg, batch):
    """ParamSpec tree of one layer's decode cache: f32 state, bf16 conv history."""
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "state": ParamSpec((batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
                           ("batch", "heads", None, None), dtype=torch.float32,
                           init="zeros"),
        "conv": ParamSpec((batch, cfg.conv_width - 1, conv_dim), ("batch", None, "inner"),
                          dtype=CACHE_CONV_DTYPE, init="zeros"),
    }


def ssd_block_decode(p, x, cache, cfg, ctx):
    """x (B,1,D); single-step SSM recurrence.

    Updates the cache in place: the f32 state becomes state * a + dB x and
    the conv history shifts by one token (the same values the JAX package
    returns as a new cache). Returns (out (B,1,D), cache)."""
    B_ = x.shape[0]
    di, n, nh, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    x1 = x[:, 0]
    z = torch.einsum("bd,de->be", x1, p["in_z"])
    xBC = torch.cat([
        torch.einsum("bd,de->be", x1, p["in_x"]),
        torch.einsum("bd,dn->bn", x1, p["in_B"]),
        torch.einsum("bd,dn->bn", x1, p["in_C"])], dim=-1)
    dt = torch.einsum("bd,dh->bh", x1, p["in_dt"])
    # conv over buffer + current
    hist = torch.cat([cache["conv"].to(xBC.dtype), xBC[:, None, :]], dim=1)
    conv_out = torch.einsum("bwc,wc->bc", hist, p["conv_w"]) + p["conv_b"]
    xBC = F.silu(conv_out)
    cache["conv"].copy_(hist[:, 1:])
    xs, Bs, Cs = torch.split(xBC, [di, n, n], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])                        # (B,nh)
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt * A)                                             # (B,nh)
    xh = xs.reshape(B_, nh, hp).float()
    dBx = torch.einsum("bn,bhp->bhnp", Bs.float(), xh) * dt[:, :, None, None]
    state = cache["state"].mul_(a[:, :, None, None]).add_(dBx)
    y = torch.einsum("bn,bhnp->bhp", Cs.float(), state)
    y = y + p["D"][None, :, None] * xh
    y = y.reshape(B_, di).to(x.dtype) * F.silu(z)
    out = torch.einsum("be,ed->bd", y, p["out_proj"])[:, None, :]
    return out, cache
