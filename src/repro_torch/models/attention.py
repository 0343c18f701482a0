"""Attention: global (causal), local (sliding window), cross (to a memory)
and enc (bidirectional); prefill + decode.

Counterpart of ``repro/models/attention.py``. Full-sequence attention goes
through ``kernels.ops.flash_attention`` (the Hopper kernel on a CUDA tensor,
its plain version on a CPU tensor): causal for global and local, unmasked
for cross and enc, as the reference's Pallas path runs them. Single-token
decode attention and all projections are plain einsum code, as in the JAX
package.

Layouts: q (B, S, H, hd); k/v (B, S, KV, hd). GQA groups q as
(B, S, KV, G, hd) so that k/v broadcast over G without repeated heads.
A cross layer takes its keys and values from ``memory`` (B, M, D), gets no
rope, and scales its output by tanh of an f32 scalar ``gate`` (zero at
init, so the layer adds nothing until the gate moves).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import CROSS_ATTN, ENC_ATTN, GLOBAL_ATTN, LOCAL_ATTN
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.layers import ParamSpec, rms_norm, rms_norm_specs, rope

CACHE_DTYPE = torch.bfloat16      # the decode cache is bf16 whatever the params


def attention_specs(cfg, cross: bool = False):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = {
        "wq": ParamSpec((d, h, hd)),
        "wk": ParamSpec((d, kv, hd)),
        "wv": ParamSpec((d, kv, hd)),
        "wo": ParamSpec((h, hd, d)),
    }
    if cfg.qk_norm:
        s["qnorm"] = rms_norm_specs(hd)
        s["knorm"] = rms_norm_specs(hd)
    if cross:
        # the tanh gate of a cross layer: f32 whatever the params' dtype
        s["gate"] = ParamSpec((), dtype=torch.float32, init="zeros")
    return s


def _theta(cfg, kind):
    if kind == GLOBAL_ATTN and cfg.rope_theta_global:
        return cfg.rope_theta_global
    return cfg.rope_theta


def _group(q, kv_heads):
    """(B, S, H, hd) -> (B, S, KV, G, hd)."""
    b, s, h, hd = q.shape
    return q.reshape(b, s, kv_heads, h // kv_heads, hd)


def _ungroup(o):
    b, s, kvh, g, hd = o.shape
    return o.reshape(b, s, kvh * g, hd)


def _einsum(eq, a, b):
    """einsum with JAX's type promotion (torch refuses mixed dtypes)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def _project_qkv(p, x, memory, cfg, rope_theta, positions, kind):
    """q from x; k and v from ``memory`` for a cross layer, else from x.
    Every kind but cross is roped. The memory's products promote its dtype
    with the weights' (a bf16 memory meets f32 weights as f32), as in JAX."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    src = x if memory is None else memory
    k = _einsum("bsd,dhk->bshk", src, p["wk"])
    v = _einsum("bsd,dhk->bshk", src, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["qnorm"]["scale"], cfg.norm_eps)
        k = rms_norm(k, p["knorm"]["scale"], cfg.norm_eps)
    if kind != CROSS_ATTN and rope_theta:
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)
    return q, k, v


def _out_proj(p, o, gated=False):
    out = _einsum("bshk,hkd->bsd", o, p["wo"])
    if gated:
        out = out * torch.tanh(p["gate"]).to(out.dtype)
    return out


# ---------------------------------------------------------------------------
# full-sequence layer entry (prefill / forward)
# ---------------------------------------------------------------------------

def attention_apply(p, x, cfg, ctx, kind, memory=None, positions=None):
    """x (B,S,D).  kind in {global, local, cross, enc}; a cross layer
    attends to ``memory`` (B,M,D), which it needs.

    Returns (out (B,S,D), (k, v)) — roped keys/values (the memory's, unroped,
    for cross) so callers can build a decode cache from a prefill pass.
    """
    if kind == CROSS_ATTN and memory is None:
        raise ValueError("a cross-attention layer needs the memory (B, M, D)")
    B, S, D = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, memory if kind == CROSS_ATTN else None, cfg,
                           _theta(cfg, kind), positions, kind)
    window = cfg.local_window if kind == LOCAL_ATTN else 0
    o = ops.flash_attention(_group(q, cfg.num_kv_heads), k, v,
                            causal=kind in (GLOBAL_ATTN, LOCAL_ATTN), window=window,
                            scale=1.0 / math.sqrt(cfg.head_dim))
    return _out_proj(p, _ungroup(o), gated=kind == CROSS_ATTN), (k, v)


def _pad_seq(x, n):
    """Zero-pad (B, S, KV, hd) along S by n."""
    return F.pad(x, (0, 0, 0, 0, 0, n))


def pack_prefill_cache(k, v, kind, cfg, cache_len):
    """Arrange full-sequence roped (k, v) (B,S,KV,hd) into the decode cache
    layout of attn_cache_specs (ring order for local windows; a cross
    layer's cache is the memory's k/v, its length the memory's)."""
    S = k.shape[1]
    if kind == LOCAL_ATTN:
        W = min(cfg.local_window, cache_len)
        if S >= W:
            # position p lands at slot p % W; first kept position is S-W
            shift = S % W
            k_c = torch.roll(k[:, S - W:], shift, dims=1)
            v_c = torch.roll(v[:, S - W:], shift, dims=1)
        else:
            k_c, v_c = _pad_seq(k, W - S), _pad_seq(v, W - S)
        return {"k": k_c.to(CACHE_DTYPE), "v": v_c.to(CACHE_DTYPE)}
    L = S if kind == CROSS_ATTN else cache_len
    if S < L:
        k, v = _pad_seq(k, L - S), _pad_seq(v, L - S)
    else:
        k, v = k[:, :L], v[:, :L]
    return {"k": k.to(CACHE_DTYPE), "v": v.to(CACHE_DTYPE)}


# ---------------------------------------------------------------------------
# decode (single token, cached)
# ---------------------------------------------------------------------------

def attn_cache_specs(cfg, kind, batch, cache_len):
    """A local layer keeps a ring of min(window, cache_len) slots; a cross
    layer the memory's k/v, of the stub frontend's length."""
    if kind == LOCAL_ATTN:
        L = min(cfg.local_window, cache_len)
    elif kind == CROSS_ATTN:
        L = cfg.context_tokens or cfg.encoder_len
    else:
        L = cache_len
    spec = ParamSpec((batch, L, cfg.num_kv_heads, cfg.head_dim),
                     dtype=CACHE_DTYPE, init="zeros")
    return {"k": spec, "v": spec}


def attention_decode(p, x, cache, pos: int, cfg, ctx, kind):
    """x (B,1,D); cache {"k","v"} (B,L,KV,hd); pos (tokens so far).

    Writes the new key/value into the cache in place (slot pos % L for a
    local ring, pos for a global cache) and returns (out (B,1,D), cache).
    A cross layer reads its static memory k/v unmasked and writes nothing.
    """
    scale = 1.0 / math.sqrt(cfg.head_dim)
    if kind == CROSS_ATTN:
        q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
        if cfg.qk_norm:
            q = rms_norm(q, p["qnorm"]["scale"], cfg.norm_eps)
        o = _decode_attention(_group(q, cfg.num_kv_heads), cache["k"], cache["v"],
                              None, scale)
        return _out_proj(p, _ungroup(o), gated=True), cache
    if kind == ENC_ATTN:
        raise ValueError("an encoder layer has no decode step")
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, None, cfg, _theta(cfg, kind), positions, kind)
    qg = _group(q, cfg.num_kv_heads)                    # (B,1,KV,G,hd)

    k_cache, v_cache = cache["k"], cache["v"]
    L = k_cache.shape[1]
    slot = pos % L if kind == LOCAL_ATTN else pos
    k_cache[:, slot] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, slot] = v_new[:, 0].to(v_cache.dtype)

    slots = torch.arange(L, device=x.device)
    if kind == LOCAL_ATTN:
        # slot s holds absolute position pos - ((pos - s) mod L); valid if >= 0
        p_slot = pos - ((pos - slots) % L)
        valid = (p_slot >= 0) & (p_slot <= pos) & (pos - p_slot < cfg.local_window)
    else:
        valid = slots <= pos
    o = _decode_attention(qg, k_cache, v_cache, valid, scale)
    return _out_proj(p, _ungroup(o)), cache


def _decode_attention(qg, k_cache, v_cache, valid, scale):
    """One query token over a cache: f32 scores (masked where ``valid`` is
    False, unmasked for None), softmax weights rounded to the cache dtype
    before P.V, as the JAX package's decode does."""
    s = _einsum("bqkgh,bskh->bkgqs", qg, k_cache).float() * scale
    if valid is not None:
        s = s.masked_fill(~valid, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqs,bskh->bqkgh", w.to(v_cache.dtype), v_cache)
