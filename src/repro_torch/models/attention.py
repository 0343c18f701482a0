"""Attention: global (causal) and local (sliding window); prefill + decode.

Counterpart of ``repro/models/attention.py``. Full-sequence attention goes
through ``kernels.ops.flash_attention`` (the Hopper kernel on a CUDA tensor,
its plain version on a CPU tensor); single-token decode attention and all
projections are plain einsum code, as in the JAX package.

Layouts: q (B, S, H, hd); k/v (B, S, KV, hd). GQA groups q as
(B, S, KV, G, hd) so that k/v broadcast over G without repeated heads.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import CROSS_ATTN, GLOBAL_ATTN, LOCAL_ATTN
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.layers import ParamSpec, rms_norm, rms_norm_specs, rope

CACHE_DTYPE = torch.bfloat16      # the decode cache is bf16 whatever the params


def _not_ported(kind):
    return NotImplementedError(
        f"attention kind {kind!r} is not ported yet (ROADMAP queue 1, "
        "cross-attention families)")


def attention_specs(cfg, cross: bool = False):
    if cross:
        raise _not_ported(CROSS_ATTN)
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


def _project_qkv(p, x, cfg, rope_theta, positions):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["qnorm"]["scale"], cfg.norm_eps)
        k = rms_norm(k, p["knorm"]["scale"], cfg.norm_eps)
    if rope_theta:
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)
    return q, k, v


def _out_proj(p, o):
    return _einsum("bshk,hkd->bsd", o, p["wo"])


# ---------------------------------------------------------------------------
# full-sequence layer entry (prefill / forward)
# ---------------------------------------------------------------------------

def attention_apply(p, x, cfg, ctx, kind, positions=None):
    """x (B,S,D).  kind in {global, local}.

    Returns (out (B,S,D), (k, v)) — roped keys/values so callers can build a
    decode cache from a prefill pass.
    """
    if kind not in (GLOBAL_ATTN, LOCAL_ATTN):
        raise _not_ported(kind)
    B, S, D = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, _theta(cfg, kind), positions)
    window = cfg.local_window if kind == LOCAL_ATTN else 0
    o = ops.flash_attention(_group(q, cfg.num_kv_heads), k, v, causal=True,
                            window=window, scale=1.0 / math.sqrt(cfg.head_dim))
    return _out_proj(p, _ungroup(o)), (k, v)


def _pad_seq(x, n):
    """Zero-pad (B, S, KV, hd) along S by n."""
    return F.pad(x, (0, 0, 0, 0, 0, n))


def pack_prefill_cache(k, v, kind, cfg, cache_len):
    """Arrange full-sequence roped (k, v) (B,S,KV,hd) into the decode cache
    layout of attn_cache_specs (ring order for local windows)."""
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
    if kind != GLOBAL_ATTN:
        raise _not_ported(kind)
    L = cache_len
    if S < L:
        k, v = _pad_seq(k, L - S), _pad_seq(v, L - S)
    else:
        k, v = k[:, :L], v[:, :L]
    return {"k": k.to(CACHE_DTYPE), "v": v.to(CACHE_DTYPE)}


# ---------------------------------------------------------------------------
# decode (single token, cached)
# ---------------------------------------------------------------------------

def attn_cache_specs(cfg, kind, batch, cache_len):
    """A local layer keeps a ring of min(window, cache_len) slots."""
    if kind not in (GLOBAL_ATTN, LOCAL_ATTN):
        raise _not_ported(kind)
    L = min(cfg.local_window, cache_len) if kind == LOCAL_ATTN else cache_len
    spec = ParamSpec((batch, L, cfg.num_kv_heads, cfg.head_dim),
                     dtype=CACHE_DTYPE, init="zeros")
    return {"k": spec, "v": spec}


def attention_decode(p, x, cache, pos: int, cfg, ctx, kind):
    """x (B,1,D); cache {"k","v"} (B,L,KV,hd); pos (tokens so far).

    Writes the new key/value into the cache in place (slot pos % L for a
    local ring, pos for a global cache) and returns (out (B,1,D), cache).
    """
    if kind not in (GLOBAL_ATTN, LOCAL_ATTN):
        raise _not_ported(kind)
    B = x.shape[0]
    theta = _theta(cfg, kind)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, theta, positions)
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
    scale = 1.0 / math.sqrt(cfg.head_dim)
    s = _einsum("bqkgh,bskh->bkgqs", qg, k_cache).float() * scale
    s = s.masked_fill(~valid, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", w.to(v_cache.dtype), v_cache)
    return _out_proj(p, _ungroup(o)), cache
