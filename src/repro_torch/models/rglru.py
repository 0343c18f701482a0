"""Griffin / RecurrentGemma recurrent block with RG-LRU.

Counterpart of ``repro/models/rglru.py``.
Block: x -> [gelu gate branch | conv1d -> RG-LRU branch] -> multiply -> out.
RG-LRU (diagonal gated linear recurrence):
    r_t = sigmoid(w_a * u_t + b_a)
    i_t = sigmoid(w_i * u_t + b_i)
    log a_t = -c * r_t * softplus(Lambda)        (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The full-sequence scan goes through ``kernels.ops.rglru_scan`` (the Hopper
kernel on a CUDA tensor, its plain version on a CPU tensor);
``rglru_scan_ref`` is the JAX model's default XLA path, kept as a plain
function and held against its JAX original and the oracle in the tests.
Single-token decode is plain PyTorch, as in the JAX package. Every cast sits
where the JAX code has it, so bf16 rounds at the same places.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import ParamSpec
from repro_torch.models.ssm import _causal_conv

RGLRU_C = 8.0
CACHE_CONV_DTYPE = torch.bfloat16    # the conv history is bf16 whatever the params


def rglru_specs(cfg):
    d, dr = cfg.d_model, cfg.d_rnn
    return {
        "w_x": ParamSpec((d, dr), ("embed", "inner")),
        "w_y": ParamSpec((d, dr), ("embed", "inner")),
        "conv_w": ParamSpec((cfg.rglru_conv_width, dr), (None, "inner")),
        "conv_b": ParamSpec((dr,), ("inner",), init="zeros"),
        "w_a": ParamSpec((dr,), ("inner",), dtype=torch.float32),
        "b_a": ParamSpec((dr,), ("inner",), init="zeros", dtype=torch.float32),
        "w_i": ParamSpec((dr,), ("inner",), dtype=torch.float32),
        "b_i": ParamSpec((dr,), ("inner",), init="zeros", dtype=torch.float32),
        "lam": ParamSpec((dr,), ("inner",), init="rglru_a", dtype=torch.float32),
        "w_o": ParamSpec((dr, d), ("inner", "embed")),
    }


def rglru_gates(u, p):
    """u (..., dr) -> (a, b) recurrence coefficients, in float32."""
    u = u.float()
    r = torch.sigmoid(u * p["w_a"] + p["b_a"])
    i = torch.sigmoid(u * p["w_i"] + p["b_i"])
    log_a = -RGLRU_C * r * F.softplus(p["lam"])
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * u)
    return a, b


def rglru_scan_ref(a, b, h0=None):
    """Linear recurrence h_t = a_t h_{t-1} + b_t as a log-depth doubling scan.

    a, b: (B, S, dr) f32.  h0 (B, dr) optional initial state, folded into
    b[:, 0]. Step d combines each position with the one d before it by
    (a1, b1) o (a2, b2) = (a1 a2, b1 a2 + b2)."""
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    S, d = a.shape[1], 1
    while d < S:
        b = torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


def rglru_block_apply(p, x, cfg, ctx, collect_cache=False):
    """x (B,S,D) -> (out (B,S,D), cache|None)."""
    y = F.gelu(torch.einsum("bsd,de->bse", x, p["w_y"]), approximate="tanh")
    u_raw = torch.einsum("bsd,de->bse", x, p["w_x"])
    u = _causal_conv(u_raw, p["conv_w"], p["conv_b"])
    a, b = rglru_gates(u, p)
    h = ops.rglru_scan(a, b)
    cache = None
    if collect_cache:
        cw, S = cfg.rglru_conv_width, u_raw.shape[1]
        conv_buf = u_raw[:, -(cw - 1):]
        if S < cw - 1:
            conv_buf = F.pad(u_raw, (0, 0, cw - 1 - S, 0))
        # copies, so the cache keeps no view of the (B,S,dr) buffers
        cache = {"h": h[:, -1].to(torch.float32, copy=True),
                 "conv": conv_buf.to(CACHE_CONV_DTYPE, copy=True)}
    h = h.to(x.dtype) * y
    return torch.einsum("bse,ed->bsd", h, p["w_o"]), cache


# ---------------------------------------------------------------------------
# decode (single-token recurrence)
# ---------------------------------------------------------------------------

def init_rglru_cache(cfg, batch):
    """ParamSpec tree of one layer's decode cache: f32 h, bf16 conv history."""
    dr = cfg.d_rnn
    return {
        "h": ParamSpec((batch, dr), ("batch", "inner"), dtype=torch.float32, init="zeros"),
        "conv": ParamSpec((batch, cfg.rglru_conv_width - 1, dr), ("batch", None, "inner"),
                          dtype=CACHE_CONV_DTYPE, init="zeros"),
    }


def rglru_block_decode(p, x, cache, cfg, ctx):
    """x (B,1,D); single-step RG-LRU. Its conv is an einsum over the history
    (the prefill's is shifted adds), as in the JAX package.

    Updates the cache in place: h becomes a * h + b and the conv history
    shifts by one token (the same values the JAX package returns as a new
    cache). Returns (out (B,1,D), cache)."""
    y = F.gelu(torch.einsum("bsd,de->bse", x, p["w_y"])[:, 0], approximate="tanh")
    u = torch.einsum("bsd,de->bse", x, p["w_x"])[:, 0]
    hist = torch.cat([cache["conv"].to(u.dtype), u[:, None]], dim=1)
    u = torch.einsum("bwc,wc->bc", hist, p["conv_w"]) + p["conv_b"]
    cache["conv"].copy_(hist[:, 1:])
    a, b = rglru_gates(u, p)
    h = cache["h"].mul_(a).add_(b)
    out = torch.einsum("be,ed->bd", h.to(x.dtype) * y, p["w_o"])[:, None]
    return out, cache
