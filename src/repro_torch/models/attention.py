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
from torch.distributed import _functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import CROSS_ATTN, ENC_ATTN, GLOBAL_ATTN, LOCAL_ATTN
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.layers import (ParamSpec, first_index, local_product, rms_norm,
                                       rms_norm_specs, rope)

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
    if isinstance(q, DTensor):
        o = _sharded_decode(q, k_new, v_new, cache, pos, kind, cfg, ctx, scale)
        return _out_proj(p, o, ctx), cache
    qg = _group(q, cfg.num_kv_heads)                    # (B,1,KV,G,hd)

    k_cache, v_cache = cache["k"], cache["v"]
    L = k_cache.shape[1]
    slot = pos % L if kind == LOCAL_ATTN else pos
    k_cache[:, slot] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, slot] = v_new[:, 0].to(v_cache.dtype)

    valid = _valid_slots(torch.arange(L, device=x.device), pos, L, kind, cfg)
    o = _decode_attention(qg, k_cache, v_cache, valid, scale)
    return _out_proj(p, _ungroup(o), ctx), cache


def _valid_slots(slots, pos, L, kind, cfg):
    """Which of the cache's ``slots`` (global indices) hold a position the
    token at ``pos`` attends to."""
    if kind == LOCAL_ATTN:
        # slot s holds absolute position pos - ((pos - s) mod L); valid if >= 0
        p_slot = pos - ((pos - slots) % L)
        return (p_slot >= 0) & (p_slot <= pos) & (pos - p_slot < cfg.local_window)
    return slots <= pos


def _decode_attention(qg, k_cache, v_cache, valid, scale):
    """One query token over a cache: f32 scores (masked where ``valid`` is
    False, unmasked for None), softmax weights rounded to the cache dtype
    before P.V, as the JAX package's decode does."""
    s = _einsum("bqkgh,bskh->bkgqs", qg, k_cache).float() * scale
    if valid is not None:
        s = s.masked_fill(~valid, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqs,bskh->bqkgh", w.to(v_cache.dtype), v_cache)


# ---------------------------------------------------------------------------
# decode under a mesh: flash-decoding over a length-sharded cache
# ---------------------------------------------------------------------------

def _sharded_decode(q, k_new, v_new, cache, pos, kind, cfg, ctx, scale):
    """Decode attention of q (B,1,H,hd) and the new k/v (B,1,KV,hd),
    DTensors, over ``cache``, whose k and v are placed (or redistributed, at
    the first step) by the cache rules: (batch, cache, kv_heads), the
    reference's call site. Returns o (B,1,H,hd) placed as q.

    Every rank works on its local shards, so no collective moves the cache:
      * the new k/v goes into slot ``pos`` (``pos % L`` for a local ring) on
        the rank whose shard of the length holds it, in place; every rank
        computes the same clamped index, and the others write back what
        they hold (``_write_slot``);
      * q is placed as the cache's batch (gathered over a mesh axis that
        splits the cache's length: B x H x hd, small) with its heads as
        they are, and each rank's q heads meet their own kv heads (the GQA
        trap: a rank's q heads share kv heads that are whole on every rank,
        picked by index);
      * where the cache's length is split (``seq_shard_cache``), the scores'
        max and the sum of their exps are all-reduced over the mesh dims
        that split it (flash-decoding), the weights rounded to the cache
        dtype as unsharded, and each rank's P.V partial reduced in f32 and
        rounded to the cache dtype once, after the sum, as the unsharded
        product rounds it (GSPMD's program rounds each partial to bf16
        before its all-reduce: ROADMAP queue 3).
    Validity is computed on each rank's global slot indices."""
    k_cache = ctx.shard(cache["k"], "batch", "cache", "kv_heads", None)
    v_cache = ctx.shard(cache["v"], "batch", "cache", "kv_heads", None)
    cache["k"], cache["v"] = k_cache, v_cache
    mesh, cpl = k_cache.device_mesh, k_cache.placements
    L = k_cache.shape[1]
    split = [i for i, p in enumerate(cpl) if p == Shard(1)]
    start = first_index(k_cache, 1) if split else 0
    slot = pos % L if kind == LOCAL_ATTN else pos
    if slot >= L:
        # as the unsharded write's IndexError: no rank's shard holds the slot
        raise IndexError(f"decode position {pos} is past the cache's {L} slots")
    # the new k/v whole along every mesh dim that splits the length
    new_pl = [Replicate() if p == Shard(1) else p for p in cpl]
    for c, new in ((k_cache, k_new), (v_cache, v_new)):
        _write_slot(c.to_local(), new.to(c.dtype).redistribute(mesh, new_pl).to_local(),
                    slot - start)

    qpl = [Shard(0) if c == Shard(0) else p if p == Shard(2) else Replicate()
           for p, c in zip(q.placements, cpl)]
    qd = q.redistribute(mesh, qpl)
    ql, kl, vl = qd.to_local(), k_cache.to_local(), v_cache.to_local()
    H, KV = q.shape[2], k_cache.shape[2]
    g = H // KV
    mq, mk = (math.prod(mesh.size(i) for i, p in enumerate(pl) if p == Shard(2))
              for pl in (qpl, cpl))
    hl, gl = H // mq, g                 # where mk == mq, the rank's kv heads are its q heads'
    if mk < mq:
        # kv heads whole (they do not divide the model axis that splits q's):
        # q heads [r*hl, (r+1)*hl) use kv heads i // g, in groups of
        # gl = gcd(g, hl) q heads a kv head
        gl = math.gcd(g, hl)
        idx = (first_index(qd, 2) + torch.arange(0, hl, gl, device=ql.device)) // g
        kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
    b, _, _, hd = ql.shape
    qg = ql.reshape(b, 1, hl // gl, gl, hd)
    valid = _valid_slots(start + torch.arange(kl.shape[1], device=ql.device), pos, L, kind, cfg)
    if split:
        o = _flash_decode(qg, kl, vl, valid, scale, mesh, split)
    else:
        o = _decode_attention(qg, kl, vl, valid, scale)
    o = DTensor.from_local(o.reshape(b, 1, hl, hd), mesh, qpl, run_check=False)
    return o.redistribute(mesh, q.placements)


def _write_slot(local, new, idx):
    """Write ``new`` (b,1,kv,hd) into slot ``idx`` of ``local`` (b,L,kv,hd),
    this rank's shard of a cache, in place: an int where the rank holds
    the whole length, else a 0-d tensor (the global slot less the first
    index of the rank's shard; one value a rank under simulated ranks),
    written only where it falls in the shard."""
    if isinstance(idx, int):
        local[:, idx] = new[:, 0]
        return
    n = local.shape[1]
    mine = (idx >= 0) & (idx < n)
    i = idx.clamp(0, n - 1).reshape(1)
    local.index_copy_(1, i, torch.where(mine, new, local.index_select(1, i)))


def _flash_decode(qg, k, v, valid, scale, mesh, dims):
    """``_decode_attention`` of one query token over a cache whose length is
    split over the mesh dims ``dims``: k/v (b, L/n, kv, hd) this rank's
    shard. The softmax's max and sum are all-reduced over ``dims``; each
    rank's P.V partial is taken in f32 and summed over ``dims`` before the
    one rounding to the cache dtype."""
    s = _einsum("bqkgh,bskh->bkgqs", qg, k).float() * scale
    s = s.masked_fill(~valid, NEG_INF)
    m = _all_reduce(s.amax(dim=-1, keepdim=True), "max", mesh, dims)
    e = torch.exp(s - m)
    w = e / _all_reduce(e.sum(dim=-1, keepdim=True), "sum", mesh, dims)
    o = torch.einsum("bkgqs,bskh->bqkgh", w.to(v.dtype).float(), v.float())
    return _all_reduce(o, "sum", mesh, dims).to(v.dtype)


def _all_reduce(t, op, mesh, dims):
    """The local ``t`` all-reduced with ``op`` over the mesh dims ``dims``."""
    for i in dims:
        t = funcol.all_reduce(t, op, (mesh, i))
    return t
