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

Under a mesh x is a DTensor and the block runs as GSPMD runs the reference
under its one constraint, h at ("batch", "seq", "inner"), where "inner"
claims the model axis before "seq" does: the w_x and w_y products gather the
sequence-parallel residual over its sequence and leave u split by batch and
channels, the conv, the gates and K3 run on each rank's local (B/dp, S,
dr/m) channels over the whole sequence, with no collective, and w_o leaves
a partial sum over the channels that the residual's constraint reduces.
Decode updates each rank's shards of h and of the conv history in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels import ops
from repro_torch.models.layers import ParamSpec, grad_placements, local_product
from repro_torch.models.ssm import _causal_conv

RGLRU_C = 8.0
CACHE_CONV_DTYPE = torch.bfloat16    # the conv history is bf16 whatever the params
_CHANNEL_PARAMS = ("conv_w", "conv_b", "w_a", "b_a", "w_i", "b_i", "lam")


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
    if isinstance(x, DTensor):
        return _sharded_block_apply(p, x, cfg, ctx, collect_cache)
    y = F.gelu(torch.einsum("bsd,de->bse", x, p["w_y"]), approximate="tanh")
    u_raw = torch.einsum("bsd,de->bse", x, p["w_x"])
    u = _causal_conv(u_raw, p["conv_w"], p["conv_b"])
    a, b = rglru_gates(u, p)
    h = ops.rglru_scan(a, b)
    cache = None
    if collect_cache:
        cache = {"h": h[:, -1].to(torch.float32, copy=True),
                 "conv": _conv_history(u_raw, cfg)}
    h = h.to(x.dtype) * y
    return torch.einsum("bse,ed->bsd", h, p["w_o"]), cache


def _conv_history(u_raw, cfg):
    """The last conv_width - 1 inputs of the conv (zero-padded in front of a
    short prompt), a copy in the cache's dtype, so the cache keeps no view
    of the (B,S,dr) buffers."""
    cw, S = cfg.rglru_conv_width, u_raw.shape[1]
    buf = u_raw[:, -(cw - 1):] if S >= cw - 1 else F.pad(u_raw, (0, 0, cw - 1 - S, 0))
    return buf.to(CACHE_CONV_DTYPE, copy=True)


def _channel_shards(p, t):
    """{name: the rank's local shard} of the per-channel params, each cut to
    the channels of ``t``, a DTensor whose channels are its last dim: split
    over the mesh dims that split those channels, gathered over the others
    (a zero3 param split over every axis; a param against the batch rows).
    Their gradients are partial sums over the dims that split t elsewhere."""
    ch = t.ndim - 1
    out = {}
    for name in _CHANNEL_PARAMS:
        w = p[name]
        w = w.redistribute(w.device_mesh, [Shard(w.ndim - 1) if q == Shard(ch) else Replicate()
                                           for q in t.placements])
        out[name] = w.to_local(grad_placements=grad_placements(w, t))
    return out


def _local_scan(a, b):
    """K3 on each rank's local shards of a and b (B,S,dr), DTensors placed
    alike and whole over the sequence; h back as a DTensor placed as them.
    Each rank scans its own rows and channels: no collective, and in the
    backward the gradients of the local a and b are whole for their shards."""
    mesh, pl = a.device_mesh, a.placements
    h = ops.rglru_scan(a.to_local(grad_placements=pl), b.to_local(grad_placements=pl))
    return DTensor.from_local(h, mesh, pl, run_check=False)


def _sharded_block_apply(p, x, cfg, ctx, collect_cache):
    """``rglru_block_apply`` of x, a DTensor (module docstring). The w_x and
    w_y products leave y and u split by batch and channels and whole over
    the sequence: the channels take the model axis before the sequence
    does."""
    y, u_raw = (local_product("bsd,de->bse", x, p[w], ctx, ("batch", "seq", None),
                              (None, "inner")) for w in ("w_y", "w_x"))
    mesh, pl = u_raw.device_mesh, u_raw.placements
    w = _channel_shards(p, u_raw)
    u_loc = u_raw.to_local(grad_placements=pl)
    a, b = rglru_gates(_causal_conv(u_loc, w["conv_w"], w["conv_b"]), w)
    a, b = (DTensor.from_local(t, mesh, pl, run_check=False) for t in (a, b))
    h = _local_scan(a, b)
    cache = None
    if collect_cache:
        hl = h.to_local()
        # placed by init_rglru_cache's axes (the JAX cache specs')
        last = DTensor.from_local(hl[:, -1].to(torch.float32, copy=True), mesh,
                                  [Shard(1) if q == Shard(2) else q for q in pl],
                                  run_check=False)
        hist = DTensor.from_local(_conv_history(u_loc, cfg), mesh, pl, run_check=False)
        cache = {"h": ctx.shard(last, "batch", "inner"),
                 "conv": ctx.shard(hist, "batch", None, "inner")}
    y = F.gelu(y.to_local(grad_placements=pl), approximate="tanh")
    h = DTensor.from_local(h.to_local(grad_placements=pl).to(x.dtype) * y, mesh, pl,
                           run_check=False)
    h = ctx.shard(h, "batch", "seq", "inner")
    return local_product("bse,ed->bsd", h, p["w_o"], ctx, ("batch", "seq", "inner"),
                         ("inner", None)), cache


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
    if isinstance(x, DTensor):
        return _sharded_block_decode(p, x, cache, cfg, ctx)
    y = F.gelu(torch.einsum("bsd,de->bse", x, p["w_y"])[:, 0], approximate="tanh")
    u = torch.einsum("bsd,de->bse", x, p["w_x"])[:, 0]
    h = _decode_update(u, cache["h"], cache["conv"], p)
    out = torch.einsum("be,ed->bd", h.to(x.dtype) * y, p["w_o"])[:, None]
    return out, cache


def _decode_update(u, h, conv, p):
    """One token's conv and recurrence of u (B,dr) against the cache's h
    (B,dr) and conv history (B,W-1,dr), both updated in place; returns h."""
    hist = torch.cat([conv.to(u.dtype), u[:, None]], dim=1)
    u = torch.einsum("bwc,wc->bc", hist, p["conv_w"]) + p["conv_b"]
    conv.copy_(hist[:, 1:])
    a, b = rglru_gates(u, p)
    return h.mul_(a).add_(b)


def _sharded_block_decode(p, x, cache, cfg, ctx):
    """``rglru_block_decode`` of x, a DTensor: h and the conv history placed
    by the cache's axes (a no-op after the first step), and each rank's
    shards of both updated in place, with no gather of either."""
    cache["h"] = ctx.shard(cache["h"], "batch", "inner")
    cache["conv"] = ctx.shard(cache["conv"], "batch", None, "inner")
    mesh, hpl = cache["h"].device_mesh, cache["h"].placements
    pl = [Shard(2) if q == Shard(1) else q for q in hpl]          # as (B, 1, dr)
    y, u = (local_product("bsd,de->bse", x, p[w], ctx, ("batch", "seq", None),
                          (None, "inner")).redistribute(mesh, pl) for w in ("w_y", "w_x"))
    y = F.gelu(y.to_local(), approximate="tanh")
    h = _decode_update(u.to_local()[:, 0], cache["h"].to_local(), cache["conv"].to_local(),
                       _channel_shards(p, cache["h"]))
    h = DTensor.from_local((h.to(x.dtype) * y[:, 0])[:, None], mesh, pl, run_check=False)
    return local_product("bse,ed->bsd", h, p["w_o"], ctx, ("batch", "seq", "inner"),
                         ("inner", None)), cache
