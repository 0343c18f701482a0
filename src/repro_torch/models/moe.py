"""Mixture-of-Experts with top-k routing (counterpart of ``repro/models/moe.py``):
gather-based, capacity-bounded.

The T tokens of a call are routed as one group (the JAX package splits them
into one group per data-parallel shard; the port has no mesh), with
capacity C = capacity(T, E, k, cf) slots an expert. The router runs in
f32; the top-k weights are renormalised; each assignment's position in its
expert counts the assignments before it in (token, k) order, so earlier
tokens win a full expert and the rest are dropped. Dispatch gathers tokens
into (G, E, C, D) slots, the expert products are einsums batched over the
experts, and combine is a gather: each (token, k) reads its slot's output.

``route`` computes the routing; ``moe_apply`` looks it up in this module at
each call, so a caller can observe the routing by wrapping ``moe.route``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamSpec


def moe_specs(cfg):
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    return {
        "router": ParamSpec((d, e), ("embed", None), dtype=torch.float32),
        "wi": ParamSpec((e, d, f), ("experts", "embed", "ff")),
        "wg": ParamSpec((e, d, f), ("experts", "embed", "ff")),
        "wo": ParamSpec((e, f, d), ("experts", "ff", "embed")),
    }


def capacity(tokens: int, num_experts: int, k: int, cf: float) -> int:
    c = int(tokens * k * cf / num_experts)
    return max(8, -(-c // 8) * 8)           # round up to multiple of 8


class Routing(NamedTuple):
    """The routing of G groups of Tg tokens to E experts, k each (G is 1 in
    ``moe_apply``; the leading dimension keeps the JAX package's layout)."""
    gates: torch.Tensor      # (G,Tg,E) f32 softmax of the router logits
    top_w: torch.Tensor      # (G,Tg,k) f32 weights of the chosen experts, renormalised
    top_i: torch.Tensor      # (G,Tg,k) int64 expert ids, by gate descending
    keep: torch.Tensor       # (G,Tg*k) bool: the assignment has a slot
    slot: torch.Tensor       # (G,Tg*k) int64 expert * C + position in the expert


def route(router, xt, cfg, cap: int) -> Routing:
    """Route xt (G,Tg,D) with the f32 router (D,E) into `cap` slots an expert."""
    G, Tg, _ = xt.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    logits = torch.einsum("gtd,de->gte", xt.float(), router)
    gates = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(gates, K, dim=-1)             # sorted, as lax.top_k
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    # position of each assignment within its expert, per group: the count of
    # assignments to it before this one in (token, k) order. The one-hot is
    # laid out expert-major, so that the cumsum runs along contiguous memory
    # (a scan over the outer dimension of (Tg*K, E) took 3 ms a layer at
    # mixtral's prefill on an H100)
    flat_e = top_i.reshape(G, Tg * K)
    onehot = F.one_hot(flat_e, E).transpose(1, 2).contiguous()  # (G,E,Tg*K) int64
    pos = (onehot.cumsum(2) - onehot).gather(1, flat_e[:, None, :])[:, 0]
    return Routing(gates, top_w, top_i, pos < cap, flat_e * cap + pos)


def moe_apply(p, x, cfg):
    """x (B,S,D) -> (out (B,S,D), aux_loss f32 scalar)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    G, Tg = 1, B * S
    C = capacity(Tg, E, K, cfg.capacity_factor)
    xt = x.reshape(G, Tg, D)
    r = route(p["router"], xt, cfg, C)

    # load-balancing aux loss (Switch-style): first choices' density, no
    # gradient, against the mean gate
    density = F.one_hot(r.top_i[..., 0], E).float().mean(dim=(0, 1))
    aux = E * (density * r.gates.mean(dim=(0, 1))).sum()

    # slot -> token tables; a dropped assignment writes the spare slot E*C,
    # which is then cut off
    tok_of = (torch.arange(Tg * K, device=x.device) // K).expand(G, -1)
    slot_safe = torch.where(r.keep, r.slot, E * C)
    idx = torch.zeros((G, E * C + 1), dtype=torch.int64, device=x.device)
    idx = idx.scatter_(1, slot_safe, tok_of)[:, :-1]
    valid = torch.zeros((G, E * C + 1), dtype=torch.bool, device=x.device)
    valid = valid.scatter_(1, slot_safe, r.keep)[:, :-1]

    xg = xt.gather(1, idx[..., None].expand(-1, -1, D)).reshape(G, E, C, D)
    xg = xg * valid.reshape(G, E, C, 1).to(xg.dtype)
    h = torch.einsum("gecd,edf->gecf", xg, p["wi"])
    g = torch.einsum("gecd,edf->gecf", xg, p["wg"])
    g = F.silu(g) if cfg.act == "silu" else F.gelu(g, approximate="tanh")
    y = torch.einsum("gecf,efd->gecd", h * g, p["wo"])     # (G,E,C,D)

    # combine: each (token, k) reads its slot's output (gather, no scatter)
    read = torch.where(r.keep, r.slot, 0)
    yt = y.reshape(G, E * C, D).gather(1, read[..., None].expand(-1, -1, D))
    yt = yt * r.keep[..., None].to(yt.dtype)
    out = (yt.reshape(G, Tg, K, D) * r.top_w.reshape(G, Tg, K, 1).to(yt.dtype)).sum(dim=2)
    return out.reshape(B, S, D), aux
