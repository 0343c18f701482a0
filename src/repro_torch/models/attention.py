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

Under a mesh q, k and v are DTensors constrained to (batch, heads) at the
JAX package's call sites, and K1 runs on each rank's local heads, as
``shard_map`` would run it (``_local_attention``): never on the DTensors,
whose (KV, G) views would make every rank gather and compute all heads.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard

from repro_torch.configs.base import CROSS_ATTN, ENC_ATTN, GLOBAL_ATTN, LOCAL_ATTN
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.layers import (ParamSpec, local_product, rms_norm, rms_norm_specs,
                                       rope)

CACHE_DTYPE = torch.bfloat16      # the decode cache is bf16 whatever the params


def attention_specs(cfg, cross: bool = False):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        s["qnorm"] = rms_norm_specs(hd)
        s["knorm"] = rms_norm_specs(hd)
    if cross:
        # the tanh gate of a cross layer: f32 whatever the params' dtype
        s["gate"] = ParamSpec((), (), dtype=torch.float32, init="zeros")
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


def _project_qkv(p, x, memory, cfg, ctx, rope_theta, positions, kind):
    """q from x; k and v from ``memory`` for a cross layer, else from x.
    Every kind but cross is roped. The memory's products promote its dtype
    with the weights' (a bf16 memory meets f32 weights as f32), as in JAX."""
    src = x if memory is None else memory
    if isinstance(x, DTensor):
        q, k, v = (local_product("bsd,dhk->bshk", a, p[w], ctx, ("batch", "seq", None),
                                 (None, heads, None)) for a, w, heads in
                   ((x, "wq", "heads"), (src, "wk", "kv_heads"), (src, "wv", "kv_heads")))
    else:
        q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
        k = _einsum("bsd,dhk->bshk", src, p["wk"])
        v = _einsum("bsd,dhk->bshk", src, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["qnorm"]["scale"], cfg.norm_eps)
        k = rms_norm(k, p["knorm"]["scale"], cfg.norm_eps)
    if kind != CROSS_ATTN and rope_theta:
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)
    return q, k, v


def _out_proj(p, o, ctx, gated=False):
    if isinstance(o, DTensor):
        out = local_product("bshk,hkd->bsd", o, p["wo"], ctx, ("batch", None, "heads", None),
                            ("heads", None, None))
    else:
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
    q, k, v = _project_qkv(p, x, memory if kind == CROSS_ATTN else None, cfg, ctx,
                           _theta(cfg, kind), positions, kind)
    # seq stays unsharded here (None, not "seq"): sequence parallelism
    # applies to the residual stream only
    q = ctx.shard(q, "batch", None, "heads", None)
    k = ctx.shard(k, "batch", None, "kv_heads", None)
    v = ctx.shard(v, "batch", None, "kv_heads", None)
    window = cfg.local_window if kind == LOCAL_ATTN else 0

    def attend(qg, k, v):
        return ops.flash_attention(qg, k, v, causal=kind in (GLOBAL_ATTN, LOCAL_ATTN),
                                   window=window, scale=1.0 / math.sqrt(cfg.head_dim))

    if isinstance(q, DTensor):
        o = _local_attention(attend, q, k, v, cfg.num_kv_heads)
    else:
        o = _ungroup(attend(_group(q, cfg.num_kv_heads), k, v))
    o = ctx.shard(o, "batch", None, "heads", None)
    return _out_proj(p, o, ctx, gated=kind == CROSS_ATTN), (k, v)


def _local_attention(attend, q, k, v, kv_heads):
    """``attend`` (K1) on each rank's local shards of q (B,S,H,hd) and k/v
    (B,S,KV,hd), DTensors; o back as a DTensor placed as q.

    A rank holds q heads [r*Hl, (r+1)*Hl), Hl = H/m over the m shards of the
    heads dim, and q head i attends to kv head i // G (G = H/KV). Where m
    divides KV too, its local kv heads are those its q heads need. Where it
    does not, k and v are whole on every rank (the GQA trap: qwen3-8b's KV 8
    on a 16-wide model axis), so each kv head is repeated G/Gl times, Gl =
    gcd(G, Hl), before taking the rank's shard: then the rank's Hl/Gl kv
    heads serve its q heads in groups of Gl, each its own.

    In the backward each rank's gradients of its local q, k and v are whole
    for its shards, so they keep q's placements (passed as
    ``grad_placements``, not left to a default). For k and v repeated in
    the GQA trap, those are shards of the repeated heads: the backward of
    the redistribute gathers them, and that of the repeat sums each kv
    head's G/Gl copies, the gradients of every rank that used it."""
    mesh, pl = q.device_mesh, q.placements
    H = q.shape[2]
    m = math.prod(mesh.size(i) for i, p in enumerate(pl) if p == Shard(2))
    hl, g = H // m, H // kv_heads
    gl = math.gcd(g, hl)
    if g // gl > 1:
        b, s, kvh, hd = k.shape
        k, v = (t[:, :, :, None].expand(b, s, kvh, g // gl, hd).reshape(b, s, H // gl, hd)
                for t in (k, v))
    k, v = (t.redistribute(mesh, pl).to_local(grad_placements=pl) for t in (k, v))
    ql = q.to_local(grad_placements=pl)
    b, s, _, hd = ql.shape
    o = attend(ql.reshape(b, s, hl // gl, gl, hd), k, v)
    return DTensor.from_local(o.reshape(b, s, hl, hd), mesh, pl, run_check=False)


def _pad_seq(x, n):
    """Zero-pad (B, S, KV, hd) along S by n."""
    return F.pad(x, (0, 0, 0, 0, 0, n))


def pack_prefill_cache(k, v, kind, cfg, cache_len):
    """Arrange full-sequence roped (k, v) (B,S,KV,hd) into the decode cache
    layout of attn_cache_specs (ring order for local windows; a cross
    layer's cache is the memory's k/v, its length the memory's). DTensors,
    whose seq dim is never sharded, are packed shard by shard."""
    if isinstance(k, DTensor):
        mesh, pl = k.device_mesh, k.placements
        c = pack_prefill_cache(k.to_local(), v.to_local(), kind, cfg, cache_len)
        return {n: DTensor.from_local(t, mesh, pl, run_check=False) for n, t in c.items()}
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
                     ("batch", "cache", "kv_heads", None), dtype=CACHE_DTYPE, init="zeros")
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
        return _out_proj(p, _ungroup(o), ctx, gated=True), cache
    if kind == ENC_ATTN:
        raise ValueError("an encoder layer has no decode step")
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, None, cfg, ctx, _theta(cfg, kind), positions, kind)
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
    return _out_proj(p, _ungroup(o), ctx), cache


def _decode_attention(qg, k_cache, v_cache, valid, scale):
    """One query token over a cache: f32 scores (masked where ``valid`` is
    False, unmasked for None), softmax weights rounded to the cache dtype
    before P.V, as the JAX package's decode does."""
    s = _einsum("bqkgh,bskh->bkgqs", qg, k_cache).float() * scale
    if valid is not None:
        s = s.masked_fill(~valid, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqs,bskh->bqkgh", w.to(v_cache.dtype), v_cache)
