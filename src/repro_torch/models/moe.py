"""Mixture-of-Experts with top-k routing (counterpart of ``repro/models/moe.py``):
grouped, gather-based, capacity-bounded.

The T tokens of a call are split into G = ``ctx.moe_groups`` groups (the
data-parallel degree under a mesh, 1 without one; 1 also where G does not
divide T), and each group routes its Tg = T/G tokens on its own, with
capacity C = capacity(Tg, E, k, cf) slots an expert. The router runs in
f32; the top-k weights are renormalised; each assignment's position in its
expert counts the assignments of its group before it in (token, k) order,
so earlier tokens win a full expert and the rest are dropped. Dispatch
gathers tokens into (G, E, C, D) slots, the expert products are einsums
batched over the experts, and combine is a gather: each (token, k) reads
its slot's output.

Under a mesh (x a DTensor) the four constraints of the reference's call
sites place xt (groups, -, embed), the dispatch tensor (groups, experts, -,
embed), the gated hidden (groups, experts, -, ff) and the expert outputs
(groups, experts, -, embed). Each rank routes, dispatches and combines the
groups it holds on local tensors; the expert products run on local shards
(``layers.local_product``): under expert parallelism (E divides the model
axis) a rank holds E/m whole experts, and the combine gathers every
expert's outputs of its groups over the model axis (an all-gather, where
GSPMD moves them with an all-to-all); where E does not divide it, every
rank holds all experts with ff split, and the down product's partial sums
are all-reduced at the output's constraint.

``route`` computes the routing; ``moe_apply`` looks it up in this module at
each call, so a caller can observe the routing by wrapping ``moe.route``.
Under a mesh it is called on each rank's local groups.
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models.layers import ParamSpec, grad_placements, local_product


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


# True while a sharded MoE layer runs its expert products
# (``expert_products``). The remat policy ``dots`` keeps the products with no
# batch dimension; a rank that holds one expert runs its expert products as
# bmm of a batch of one, which that policy cannot tell from a weight product
# without this flag (the reference's policy sees the expert dim as a batch
# dim). Unsharded, E > 1 experts make the batch
_EXPERTS = [False]


@contextlib.contextmanager
def expert_products():
    """While active, ``in_expert_products()`` is True."""
    prev, _EXPERTS[0] = _EXPERTS[0], True
    try:
        yield
    finally:
        _EXPERTS[0] = prev


def in_expert_products() -> bool:
    return _EXPERTS[0]


class Routing(NamedTuple):
    """The routing of G groups of Tg tokens to E experts, k each (under a
    mesh, of a rank's local groups)."""
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


def moe_apply(p, x, cfg, ctx=None):
    """x (B,S,D) -> (out (B,S,D), aux_loss f32 scalar), in ``ctx.moe_groups``
    dispatch groups (one without a ctx); under a mesh x is a DTensor
    (``_sharded_moe``)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    T = B * S
    G = max(ctx.moe_groups, 1) if ctx is not None else 1
    G = G if T % G == 0 else 1
    Tg = T // G
    C = capacity(Tg, E, K, cfg.capacity_factor)
    if isinstance(x, DTensor):
        return _sharded_moe(p, x, cfg, ctx, G, C)
    xt = x.reshape(G, Tg, D)
    r = route(p["router"], xt, cfg, C)
    aux = _aux_loss(*_means(r, E), E)
    y = _experts(p, _dispatch(xt, r, E, C), cfg)
    return _combine(y, r).reshape(B, S, D), aux


def _means(r, E):
    """The mean gate and the first choices' density (no gradient) over the
    tokens of a routing: (E,) each."""
    return r.gates.mean(dim=(0, 1)), F.one_hot(r.top_i[..., 0], E).float().mean(dim=(0, 1))


def _aux_loss(mean_gates, density, E):
    """Load-balancing aux loss (Switch-style): the first choices' density
    against the mean gate, both means over every token."""
    return E * (density * mean_gates).sum()


def _dispatch(xt, r, E, C):
    """xt (G,Tg,D) -> (G,E,C,D): each slot's token, zero where no kept
    assignment fills it. The slot -> token tables are built per group; a
    dropped assignment writes the spare slot E*C, which is then cut off."""
    G, Tg, D = xt.shape
    K = r.top_i.shape[-1]
    tok_of = (torch.arange(Tg * K, device=xt.device) // K).expand(G, -1)
    slot_safe = torch.where(r.keep, r.slot, E * C)
    idx = torch.zeros((G, E * C + 1), dtype=torch.int64, device=xt.device)
    idx = idx.scatter_(1, slot_safe, tok_of)[:, :-1]
    valid = torch.zeros((G, E * C + 1), dtype=torch.bool, device=xt.device)
    valid = valid.scatter_(1, slot_safe, r.keep)[:, :-1]
    xg = xt.gather(1, idx[..., None].expand(-1, -1, D)).reshape(G, E, C, D)
    return xg * valid.reshape(G, E, C, 1).to(xg.dtype)


def _act(g, cfg):
    return F.silu(g) if cfg.act == "silu" else F.gelu(g, approximate="tanh")


def _experts(p, xg, cfg):
    """The gated expert MLPs of the dispatched tokens: (G,E,C,D) -> (G,E,C,D)."""
    h = torch.einsum("gecd,edf->gecf", xg, p["wi"])
    g = _act(torch.einsum("gecd,edf->gecf", xg, p["wg"]), cfg)
    return torch.einsum("gecf,efd->gecd", h * g, p["wo"])


def _combine(y, r):
    """Each (token, k) reads its slot's output of y (G,E,C,D) (a gather, no
    scatter), weighted and summed over k: (G,Tg,D)."""
    G, E, C, D = y.shape
    Tg, K = r.top_w.shape[1:]
    read = torch.where(r.keep, r.slot, 0)
    yt = y.reshape(G, E * C, D).gather(1, read[..., None].expand(-1, -1, D))
    yt = yt * r.keep[..., None].to(yt.dtype)
    return (yt.reshape(G, Tg, K, D) * r.top_w.reshape(G, Tg, K, 1).to(yt.dtype)).sum(dim=2)


# ---------------------------------------------------------------------------
# under a mesh
# ---------------------------------------------------------------------------

def _sharded_moe(p, x, cfg, ctx, G, C):
    """``moe_apply`` of x (B,S,D), a DTensor, and the sharded weights: the
    routing, dispatch and combine of each rank's groups on its local
    tensors, the expert products on local shards. Returns (out, a DTensor
    placed as the groups' tokens, back in (B,S,D); aux, a replicated f32
    DTensor scalar)."""
    B, S, D = x.shape
    E = cfg.num_experts
    mesh = x.device_mesh
    xt = ctx.shard(_to_groups(x, G), "groups", None, "embed_nos")
    gpl = xt.placements                  # Shard(0) where a mesh dim splits the groups
    # Each boundary below between a DTensor and a rank's local tensor says
    # where the local gradient lies. The router is gathered whole, but a
    # rank's product covers only its groups: its gradient is a partial sum
    # over the mesh dims that split them (Partial, reduce-scattered into the
    # FSDP shards by the gather's backward), and whole elsewhere, where the
    # ranks route the same groups alike
    router = ctx.shard(p["router"], None, None)
    router = router.to_local(grad_placements=grad_placements(router, xt))
    # xt's local gradient (routing and dispatch) is whole for the rank's own
    # groups, the same on the ranks that share them: placed as xt
    r = route(router, xt.to_local(), cfg, C)
    # the means over every group: each rank's over its groups, summed over
    # the mesh dims that split them. Backward: the all-reduce hands every
    # rank the whole gradient of the sum, which is the gradient of its own
    # summand (DTensor keeps a replicated gradient of a Partial input as is)
    n, partial = _split(mesh, gpl), [Partial() if q == Shard(0) else q for q in gpl]
    aux = _aux_loss(*(DTensor.from_local(m / n, mesh, partial, run_check=False)
                      .redistribute(mesh, [Replicate()] * mesh.ndim) for m in _means(r, E)), E)

    # the dispatch tensor of the rank's groups, every expert: its gradient
    # comes back whole from the expert-parallel transition's backward (an
    # all-gather) or from local_product's reduction under ff
    xg = DTensor.from_local(_dispatch(xt.to_local(), r, E, C), mesh, gpl, run_check=False)
    # the expert-parallel transition: (groups, experts) over (data, model)
    xg = ctx.shard(xg, "groups", "experts", None, "embed_nos")
    x_axes = ("groups", "experts", None, "embed_nos")
    with expert_products():
        h, g = (local_product("gecd,edf->gecf", xg, p[w], ctx, x_axes, ("experts", None, "ff"))
                for w in ("wi", "wg"))
        h = ctx.shard(h * _act(g, cfg), "groups", "experts", None, "ff")
        y = local_product("gecf,efd->gecd", h, p["wo"], ctx, ("groups", "experts", None, "ff"),
                          ("experts", "ff", None))
    y = ctx.shard(y, "groups", "experts", None, "embed_nos")
    # combine on the rank's groups, every expert's outputs of them gathered.
    # The local gradient of the gathered outputs is whole for the rank's
    # groups (out's gradient is, and the routing is the same on the ranks
    # that share them), so the gather's backward takes each rank's slice
    out = _combine(y.redistribute(mesh, gpl).to_local(), r)
    return _from_groups(DTensor.from_local(out, mesh, gpl, run_check=False), B, S), aux


def _split(mesh, pl) -> int:
    """How many shards the mesh dims placed Shard(0) in ``pl`` cut dim 0 into."""
    return math.prod(mesh.size(i) for i, q in enumerate(pl) if q == Shard(0))


def _to_groups(x, G):
    """x (B,S,D), a DTensor -> (G, T/G, D), a DTensor whose local shard is
    its rank's rows' tokens in order: split over the mesh dims that split
    x's batch where those hold whole groups (the groups follow the batch
    rows, so nothing moves but the sequence, gathered), else whole. The
    rank's rows are whole on it, so their local gradient is placed as they
    are (``_from_groups`` likewise)."""
    mesh = x.device_mesh
    pl = [q if q == Shard(0) else Replicate() for q in x.placements]
    if G % _split(mesh, pl):
        pl = [Replicate()] * mesh.ndim
    local = x.redistribute(mesh, pl).to_local()
    return DTensor.from_local(local.reshape(G // _split(mesh, pl), -1, x.shape[2]), mesh, pl,
                              run_check=False)


def _from_groups(out, B, S):
    """``_to_groups``'s inverse: (G, Tg, D) placed Shard(0) or Replicate ->
    (B, S, D), split over the same mesh dims where B allows it, else whole."""
    mesh = out.device_mesh
    pl = list(out.placements)
    if B % _split(mesh, pl):
        pl = [Replicate()] * mesh.ndim
    local = out.redistribute(mesh, pl).to_local()
    return DTensor.from_local(local.reshape(B // _split(mesh, pl), S, out.shape[2]), mesh, pl,
                              run_check=False)
