"""Common layers + the ParamSpec system (counterpart of ``repro/models/layers.py``).

Every parameter is declared once as a ParamSpec (shape, logical axes, dtype,
init) in the JAX package's layout; the logical axes (a name or None per dim)
are what ``parallel/sharding.py`` maps onto a mesh. ``ParamTree``
materializes a nested dict of specs into an ``nn.Module`` of raw
``nn.Parameter``s with the same nesting, so the
functional layers below index it as ``p["wq"]`` exactly as the JAX code
indexes its pytree, and the weight bridge is a 1:1 copy. With ``abstract``
it takes ``abstract_from_specs``'s empty tensors instead, which a trace
under FakeTensorMode makes fake (``core/capture.py``).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    logical_axes: tuple | None = None   # logical axis name (or None) per dim; None: no names
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"          # normal | zeros | ones | rglru_a
    scale: float = 1.0            # stddev multiplier for "normal"

    def __post_init__(self):
        axes = ((None,) * len(self.shape) if self.logical_axes is None
                else tuple(self.logical_axes))
        if len(axes) != len(self.shape):
            raise ValueError(f"logical axes {axes} do not match shape {self.shape}")
        object.__setattr__(self, "logical_axes", axes)

    def materialize(self, generator: torch.Generator, device) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=device)
        if self.init == "rglru_a":
            # Griffin: a = sigmoid(lambda) in [0.9, 0.999] -> init lambda accordingly
            u = torch.empty(self.shape, dtype=torch.float32, device=device)
            u.uniform_(0.9, 0.999, generator=generator)
            return torch.log(u / (1 - u)).to(self.dtype)
        if self.init != "normal":
            raise ValueError(f"unknown init {self.init!r}")
        # truncated normal on [-2, 2] scaled by scale/sqrt(fan_in), drawn in f32
        fan_in = self.shape[0] if self.shape else 1
        std = self.scale / math.sqrt(max(fan_in, 1))
        x = torch.empty(self.shape, dtype=torch.float32, device=device)
        nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return (x * std).to(self.dtype)


def abstract_from_specs(specs, device):
    """Counterpart of ``repro/models/layers.py::abstract_from_specs``: the
    specs' shapes and dtypes as empty tensors, with no init. Made under a
    FakeTensorMode they are fake and take no memory."""
    if isinstance(specs, ParamSpec):
        return torch.empty(specs.shape, dtype=specs.dtype, device=device)
    return {k: abstract_from_specs(s, device) for k, s in specs.items()}


class ParamTree(nn.Module):
    """A nested dict of ParamSpecs as a module of raw parameters: seeded from
    ``generator``, or with ``abstract`` empty (``abstract_from_specs``).
    They take grads only when ``trainable`` (serving keeps them frozen).
    ``param_specs`` keeps the spec of each parameter of this module."""

    def __init__(self, specs: dict, generator: torch.Generator | None, device,
                 trainable: bool = False, abstract: bool = False):
        super().__init__()
        self.param_specs = {}
        for key in sorted(specs):
            spec = specs[key]
            if isinstance(spec, ParamSpec):
                self.param_specs[key] = spec
                value = (abstract_from_specs(spec, device) if abstract
                         else spec.materialize(generator, device))
                self.register_parameter(key, nn.Parameter(value, requires_grad=trainable))
            else:
                self.add_module(key, ParamTree(spec, generator, device, trainable, abstract))

    def __getitem__(self, key):
        return getattr(self, key)

    def __contains__(self, key):
        return key in self._parameters or key in self._modules


# ---------------------------------------------------------------------------
# functional layers
# ---------------------------------------------------------------------------

def local_product(eq, x, w, ctx, x_axes, w_axes):
    """The einsum ``eq`` of an activation x and a weight w, DTensors under a
    mesh, as GSPMD runs a dot under the rules: w redistributed to what
    ``w_axes`` resolve to (an FSDP weight gathered over its embed dim), x to
    ``x_axes`` except over a mesh axis that w takes for another dim, and
    each rank's product of its local shards. An output dim is placed as the
    operand dim it comes from; a mesh axis that shards a contracted dim of
    both leaves the output Partial(sum), which the next constraint reduces.
    Left to DTensor, einsum's flattened (h, k) dim can be sharded where h
    cannot (KV 2 over a 4-wide model axis), and the view back then fails."""
    w = ctx.shard(w, *w_axes)
    x = ctx.shard(x, *x_axes)
    (xs, ws), out = eq.split("->")[0].split(","), eq.split("->")[1]
    mesh = x.device_mesh
    xp = [Replicate() if a.is_shard() and b.is_shard() and xs[a.dim] != ws[b.dim] else a
          for a, b in zip(x.placements, w.placements)]
    x = x.redistribute(mesh, xp)
    pl = []
    for a, b in zip(x.placements, w.placements):
        dims = {s[p.dim] for s, p in ((xs, a), (ws, b)) if p.is_shard()}
        if not dims:
            pl.append(Replicate())
        elif len(dims) == 1 and (d := dims.pop()) in out:
            pl.append(Shard(out.index(d)))
        elif a.is_shard() and b.is_shard():
            pl.append(Partial())
        else:
            raise ValueError(f"{eq}: one operand alone is sharded over contracted dim "
                             f"{dims}: {x.placements} x {w.placements}")
    dt = torch.promote_types(x.dtype, w.dtype)
    y = torch.einsum(eq, x.to_local(grad_placements=grad_placements(x, w)).to(dt),
                     w.to_local(grad_placements=grad_placements(w, x)).to(dt))
    return DTensor.from_local(y, mesh, pl, run_check=False)


def grad_placements(a, b) -> tuple:
    """Where the gradient of a's local shard in a product of the local
    shards of ``a`` and ``b`` lies: as ``a`` is placed, except over a mesh
    dim where ``a`` is whole and ``b`` split (x whole over the model axis
    against w split by heads, ff or vocab; a weight gathered over the data
    axis against x split by batch). There each rank's product covers only
    its slice of ``b``, so its gradient of ``a`` is a partial sum over the
    ranks: Partial(), which the backward of the redistribute that made
    ``a`` reduces (or reduce-scatters into a sharded param)."""
    return tuple(Partial() if p.is_replicate() and q.is_shard() else p
                 for p, q in zip(a.placements, b.placements))


def rms_norm(x, scale, eps=1e-6):
    # variance in f32, elementwise product in the input dtype (as the JAX layer)
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * (1.0 + scale).to(x.dtype)


def rms_norm_specs(dim, axes=(None,)):
    return {"scale": ParamSpec((dim,), axes, init="zeros")}


def soft_cap(x, cap):
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


def rope(x, positions, theta):
    """Rotary embedding.  x: (..., S, H, hd); positions: (..., S)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., :, None].float() * freq                 # (..., S, half)
    ang = ang[..., :, None, :]                                    # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- gated MLP (SwiGLU / GeGLU) ---------------------------------------------

def mlp_specs(d_model, d_ff):
    return {
        "wi": ParamSpec((d_model, d_ff), ("embed", "ff")),
        "wg": ParamSpec((d_model, d_ff), ("embed", "ff")),
        "wo": ParamSpec((d_ff, d_model), ("ff", "embed")),
    }


def mlp_apply(p, x, act, ctx=None):
    if isinstance(x, DTensor):
        h, g = (local_product("bsd,df->bsf", x, p[w], ctx, ("batch", "seq", None),
                              (None, "ff")) for w in ("wi", "wg"))
    else:
        h = torch.einsum("bsd,df->bsf", x, p["wi"])
        g = torch.einsum("bsd,df->bsf", x, p["wg"])
    g = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    h = h * g
    if ctx is None:
        return torch.einsum("bsf,fd->bsd", h, p["wo"])
    h = ctx.shard(h, "batch", "seq", "ff")
    if isinstance(h, DTensor):
        return local_product("bsf,fd->bsd", h, p["wo"], ctx, ("batch", "seq", "ff"),
                             ("ff", None))
    return torch.einsum("bsf,fd->bsd", h, p["wo"])


# -- embedding ---------------------------------------------------------------

def embed_specs(vocab, d_model):
    return {"table": ParamSpec((vocab, d_model), ("vocab", "embed"))}


def local_embedding(tokens, table, ctx):
    """The rows of ``table`` at ``tokens``, DTensors under a mesh, as GSPMD
    runs the reference's lookup under the rules: the table gathered over
    its embed dim (FSDP), each rank's tokens looked up in its rows of the
    vocab-sharded table, the other rows masked to zero, the output Partial
    over the mesh dims that split the vocab (its sum over the shards is
    exact). Tokens are whole over those dims. In the backward each rank's
    gradient covers its rows only; left to DTensor, the lookup's backward
    builds each rank's gradient of the whole table (V x D)."""
    table = ctx.shard(table, "vocab", None)
    tokens = ctx.shard(tokens, "batch", None)
    mesh = table.device_mesh
    vocab_split = [p.is_shard() for p in table.placements]
    tokens = tokens.redistribute(mesh, [Replicate() if v else p for v, p in
                                        zip(vocab_split, tokens.placements)])
    rows = table.to_local(grad_placements=grad_placements(table, tokens))
    idx = tokens.to_local() - first_index(table, 0)
    keep = (idx >= 0) & (idx < rows.shape[0])
    h = F.embedding(idx.clamp(0, rows.shape[0] - 1), rows) * keep[..., None].to(rows.dtype)
    return DTensor.from_local(h, mesh, [Partial() if v else p for v, p in
                                        zip(vocab_split, tokens.placements)], run_check=False)


def first_index(t, dim):
    """The index along ``dim`` of the whole DTensor ``t`` at which this
    rank's shard starts: a 0-d tensor (one value a rank under simulated
    ranks), cut from an arange placed as ``t`` places ``dim``."""
    mesh = t.device_mesh
    index = DTensor.from_local(torch.arange(t.shape[dim], device=t.device), mesh,
                               [Replicate()] * mesh.ndim, run_check=False)
    return index.redistribute(mesh, [Shard(0) if p == Shard(dim) else Replicate()
                                     for p in t.placements]).to_local()[0]


def embed_apply(p, tokens, d_model, ctx=None):
    table = p["table"]
    h = local_embedding(tokens, table, ctx) if isinstance(table, DTensor) else table[tokens]
    return (h.float() * math.sqrt(d_model)).to(table.dtype)


def unembed_apply(table, h, cap=0.0, ctx=None):
    if isinstance(h, DTensor):
        logits = local_product("bsd,vd->bsv", h, table, ctx, ("batch", "seq", None),
                               ("vocab", None)).float()
    else:
        logits = torch.einsum("bsd,vd->bsv", h, table).float()
    return soft_cap(logits, cap)
