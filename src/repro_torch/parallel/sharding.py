"""Logical-axis -> mesh-axis resolution, and its DTensor placements
(counterpart of ``repro/parallel/sharding.py``).

Every tensor (param, activation, cache) carries *logical* axis names
(``ParamSpec.logical_axes`` or ``ctx.shard(...)`` call sites). Rules map each
logical name to an ordered list of candidate mesh-axis tuples; resolution
picks the first candidate whose mesh axes (a) exist in the mesh, (b) are not
already used by another dim of the same tensor, and (c) evenly divide the
dim. The rules and the resolution are the JAX package's, rule for rule;
``resolve_spec`` returns the entries of the JAX ``PartitionSpec`` (an axis
name, a tuple of names, or None per dim, trailing Nones trimmed) as a tuple.

``placements`` turns such a spec into DTensor placements on a
``DeviceMesh``: one ``Shard(dim)`` or ``Replicate()`` per mesh dim. Where
two mesh axes share a tensor dim, as ("pod", "data"), DTensor splits it in
mesh-dim order, which is the JAX order (major to minor) when the tuple
lists its axes in mesh order, as every rule does.

``shard_model`` makes each parameter a DTensor of its local shard;
``make_shard_fn`` is the ``ctx.shard`` hook, a ``redistribute`` to the
resolved placements (the counterpart of ``with_sharding_constraint``).
A step under a mesh runs inside ``implicit_replication``: a plain tensor
that meets a DTensor (rope's positions, a constant) counts as replicated.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import (CROSS_ATTN, ENC_ATTN, RGLRU, SSD,
                                      ParallelConfig)
from repro_torch.models.layers import ParamSpec
from repro_torch.parallel.mesh import coordinate, mesh_shape, rank_map

# candidate lists: first match wins.  Dims are resolved in _PRIORITY order
# (not positionally), so e.g. "vocab" claims the model axis before "batch"
# considers a (data, model) combo, and "seq" (sequence parallelism) only
# takes an axis nothing else in the tensor wanted.
_PRIORITY = ("experts", "vocab", "ff", "inner", "heads", "kv_heads",
             "groups", "cache", "batch", "embed", "layers", "seq")


def activation_rules(parallel: ParallelConfig):
    if parallel.model_axis == "zero3":
        # pure DP over (data x model); params ZeRO-3-sharded (param_rules)
        return {
            "batch": [("pod", "data", "model"), ("data", "model"),
                      ("pod", "data"), ("data",)],
            "seq": [],
            "heads": [], "kv_heads": [], "ff": [], "inner": [],
            "vocab": [("model",)],
            "experts": [("model",)],
            "groups": [("pod", "data", "model"), ("data", "model"),
                       ("pod", "data"), ("data",)],
            "embed": [],
            "cache": [("data",)] if parallel.seq_shard_cache else [],
            "layers": [],
        }
    return {
        "batch": [("pod", "data"), ("data",)],
        "seq": [("model",)] if parallel.seq_shard else [],
        "heads": [("model",)],
        "kv_heads": [("model",)],
        "ff": [("model",)],
        "vocab": [("model",)],
        "experts": [("model",)],
        "groups": [("pod", "data"), ("data",)],
        "inner": [("model",)],
        "embed": [],
        "cache": [("data",)] if parallel.seq_shard_cache else [],
        "layers": [],
    }


def param_rules(parallel: ParallelConfig):
    if parallel.model_axis == "zero3":
        # every weight fully sharded over (data x model) on its first
        # shardable dim: FSDP/ZeRO-3 semantics
        return {
            "batch": [], "seq": [], "layers": [],
            "vocab": [("model",)],
            "embed": [("data", "model"), ("data",)],
            "ff": [("data", "model"), ("data",)],
            "inner": [("data", "model"), ("data",)],
            "heads": [], "kv_heads": [],
            "experts": [("model",)],
            "groups": [],
            "cache": [],
        }
    rules = activation_rules(parallel)
    if parallel.fsdp:
        # FSDP: also shard the (usually replicated) embed dim of weight
        # matrices over the data axis
        rules = dict(rules)
        rules["embed"] = [("data",)]
    return rules


def resolve_spec(axes, shape, rules, mesh) -> tuple:
    """axes: a logical name (or None) per dim, resolved in _PRIORITY order so
    high-value dims claim contested mesh axes first. ``mesh``: a
    ``DeviceMesh`` or a mapping of axis sizes."""
    sizes = mesh_shape(mesh)
    used: set = set()
    out: list = [None] * len(axes)

    def try_assign(i, dim, name):
        for cand in rules.get(name, []) if name else []:
            if any(a not in sizes for a in cand):
                continue
            if any(a in used for a in cand):
                continue
            prod = math.prod(sizes[a] for a in cand)
            if prod > 1 and dim % prod == 0:
                used.update(cand)
                out[i] = tuple(cand) if len(cand) > 1 else cand[0]
                return

    rank = {n: r for r, n in enumerate(_PRIORITY)}
    order = sorted(range(len(axes)), key=lambda i: rank.get(axes[i], len(_PRIORITY)))
    for i in order:
        if axes[i]:
            try_assign(i, shape[i], axes[i])
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def placements(spec, ndim: int, mesh) -> tuple:
    """A resolved spec -> one DTensor placement per mesh dim: Shard(d) where
    the spec puts that mesh axis on tensor dim d, else Replicate()."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than a {ndim}-d tensor")
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            # DTensor splits a dim over its mesh dims in mesh order; no rule
            # lists a dim's axes in another order
            raise NotImplementedError(f"axes {group} of dim {d} are not in mesh order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def resolve_placements(axes, shape, rules, mesh) -> tuple:
    return placements(resolve_spec(axes, shape, rules, mesh), len(shape), mesh)


def shard_region(full, mesh, pl, coord):
    """A view of the region of ``full`` that the rank at ``coord`` holds
    under placements ``pl``: cut along each sharded mesh dim in mesh order,
    major to minor (even shards; the rules only shard a dim its axes
    divide)."""
    out = full
    for i, p in enumerate(pl):
        if p.is_shard():
            size = out.shape[p.dim] // mesh.size(i)
            out = out.narrow(p.dim, coord[i] * size, size)
    return out


def local_shard(full, mesh, pl, coord):
    """The shard of ``full`` that the rank at ``coord`` holds under
    placements ``pl`` (``shard_region``). A copy, never a view: under
    ``simulated_ranks`` the ranks that replicate a dim would otherwise share
    one storage, and an in-place update (AdamW) would run on it once a
    rank."""
    return shard_region(full, mesh, pl, coord).clone(memory_format=torch.contiguous_format)


def distribute(full, mesh, pl) -> DTensor:
    """A DTensor of ``full`` (the same on every rank) placed ``pl``: each
    rank cuts its own shard, and nothing moves between ranks.
    ``distribute_tensor`` with ``src_data_rank=None`` computes the same,
    but under ``simulated_ranks`` it runs as operators on every rank's whole
    copy: 1.8 s against 0.15 s for a 124 MB bf16 tensor over 256 ranks, on
    a CPU."""
    local = rank_map(lambda r: local_shard(full, mesh, pl, coordinate(mesh, r)))
    stride = [math.prod(full.shape[i + 1:]) for i in range(full.dim())]
    return DTensor.from_local(local, mesh, pl, run_check=False, shape=full.shape,
                              stride=tuple(stride))


# ---------------------------------------------------------------------------
# what runs under a mesh in this slice
# ---------------------------------------------------------------------------

# the layers that cannot run under a mesh yet, and those that serve under
# one but do not train under one yet
_LAYERS_WAITING = {SSD: "SSD", CROSS_ATTN: "cross-attention", ENC_ATTN: "encoder"}
_TRAIN_WAITING = {RGLRU: "RG-LRU"}


def check_mesh_support(cfg, train: bool = False) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for an arch this
    slice does not run under a mesh: one with an SSD, cross or encoder
    layer, and with ``train`` one with RG-LRU layers too (they serve under a
    mesh; their train step waits). The dense and MoE archs serve and train
    under one."""
    kinds = set(cfg.layer_kinds) | ({ENC_ATTN} if cfg.is_encdec else set())
    item = "(ROADMAP queue 1, item 5.3: the RG-LRU train step, SSD and cross/enc archs " \
           "under a mesh)"
    names = [name for kind, name in _LAYERS_WAITING.items() if kind in kinds]
    if names:
        raise NotImplementedError(
            f"{cfg.name}: its {', '.join(names)} layers do not run under a mesh yet {item}")
    names = [name for kind, name in _TRAIN_WAITING.items() if kind in kinds]
    if train and names:
        raise NotImplementedError(
            f"{cfg.name}: its {', '.join(names)} layers serve under a mesh, but its train "
            f"step does not run under one yet {item}")


# ---------------------------------------------------------------------------
# parameters, activations and inputs as DTensors
# ---------------------------------------------------------------------------

def shard_model(model, mesh, parallel: ParallelConfig):
    """Make each parameter of ``model`` (whole on every rank, as the seed or
    ``bridge.py`` gave it) a DTensor of its local shard under
    ``param_rules``, in place, keeping its name and ``requires_grad``.
    Nothing moves between ranks: each rank cuts its shard from its own
    copy. Returns the model."""
    check_mesh_support(model.cfg)
    rules = param_rules(parallel)
    for name, spec in model.param_specs().items():
        pl = resolve_placements(spec.logical_axes, spec.shape, rules, mesh)
        mod_name, key = name.rsplit(".", 1)
        mod = model.get_submodule(mod_name)
        p = mod._parameters[key]
        if isinstance(p, DTensor):
            raise ValueError(f"{name} is a DTensor already")
        mod._parameters[key] = nn.Parameter(distribute(p.detach(), mesh, pl),
                                            requires_grad=p.requires_grad)
    return model


def make_shard_fn(mesh, parallel: ParallelConfig):
    """ctx.shard hook: redistribute an activation to the placements its
    logical axes resolve to (None without a mesh). A plain tensor counts as
    replicated, as under ``implicit_replication``."""
    if mesh is None:
        return None
    rules = activation_rules(parallel)

    def f(x, axes):
        if len(axes) != x.ndim:
            axes = tuple(axes) + (None,) * (x.ndim - len(axes))
        pl = resolve_placements(axes, x.shape, rules, mesh)
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
        return x.redistribute(mesh, pl)

    return f


def batch_specs(model, kind: str, batch: int, seq_len: int) -> dict:
    """ParamSpecs of one step's data inputs (tokens/labels/memory) by
    ``kind``: train (also the eval step's batch), prefill (also the forward
    step's tokens) or decode."""
    B, S = batch, seq_len
    tok = ParamSpec((B, S), ("batch", "seq"), dtype=torch.int64, init="zeros")
    if kind == "train":
        out = {"tokens": tok, "labels": tok}
    elif kind == "prefill":
        out = {"tokens": tok}
    elif kind == "decode":
        out = {"token": ParamSpec((B, 1), ("batch", None), dtype=torch.int64, init="zeros")}
    else:
        raise ValueError(f"kind must be train, prefill or decode; got {kind!r}")
    ml = model.memory_len()
    if ml and kind != "decode":
        out["memory"] = ParamSpec((B, ml, model.cfg.d_model), ("batch", None, "embed"))
    return out


def shard_inputs(inputs: dict, specs: dict, mesh, parallel: ParallelConfig) -> dict:
    """Whole inputs (the same on every rank) -> DTensors of each rank's
    shard, placed as their ``batch_specs`` resolve under
    ``activation_rules``, as the JAX step's in_shardings place them. A
    DTensor input is redistributed to those placements."""
    rules = activation_rules(parallel)
    out = {}
    for k, x in inputs.items():
        s = specs[k]
        pl = resolve_placements(s.logical_axes, tuple(x.shape), rules, mesh)
        out[k] = x.redistribute(mesh, pl) if isinstance(x, DTensor) else distribute(x, mesh, pl)
    return out


# ---------------------------------------------------------------------------
# the decode cache
# ---------------------------------------------------------------------------

def _map_cache(fn, cache, specs):
    """``fn(tensor, spec)`` over the tensors of a cache layer's tree (None
    for each tensor where ``cache`` is None)."""
    if isinstance(specs, ParamSpec):
        return fn(cache, specs)
    return {k: _map_cache(fn, None if cache is None else cache[k], s)
            for k, s in specs.items()}


def shard_cache(model, cache, mesh, parallel: ParallelConfig) -> dict:
    """A decode cache ({"pos", "layers"}, as ``Model.init_cache`` or
    ``prefill`` made it) placed under ``activation_rules`` by the logical
    axes of its specs (``attn_cache_specs``: batch, cache, kv_heads), as the
    JAX decode step's in_shardings place it: a whole cache (the same on every
    rank) cut rank by rank, a DTensor one redistributed (a no-op where it is
    placed so already). ``pos`` stays a Python int, the same on every rank.
    Under ``seq_shard_cache`` the cache's length takes the data axis, which
    "cache" claims before "batch" (``_PRIORITY``), so its batch stays whole."""
    check_mesh_support(model.cfg)
    rules = activation_rules(parallel)

    def place(x, spec):
        pl = resolve_placements(spec.logical_axes, tuple(x.shape), rules, mesh)
        return x.redistribute(mesh, pl) if isinstance(x, DTensor) else distribute(x, mesh, pl)

    # the axes do not depend on the sizes
    specs = model.cache_specs(1, 1)
    return {"pos": cache["pos"],
            "layers": [_map_cache(place, c, s) for c, s in zip(cache["layers"], specs)]}


def init_cache(model, batch: int, cache_len: int, mesh, parallel: ParallelConfig) -> dict:
    """An empty decode cache placed as ``shard_cache`` places one: each rank
    makes the zeros of its own shard only (a copy of its own, as
    ``local_shard``), never the whole cache."""
    check_mesh_support(model.cfg)
    rules = activation_rules(parallel)

    def empty(spec):
        pl = resolve_placements(spec.logical_axes, spec.shape, rules, mesh)
        local = list(spec.shape)
        for i, p in enumerate(pl):
            if p.is_shard():
                local[p.dim] //= mesh.size(i)
        t = rank_map(lambda r: torch.zeros(local, dtype=spec.dtype, device=model.device))
        stride = [math.prod(spec.shape[i + 1:]) for i in range(len(spec.shape))]
        return DTensor.from_local(t, mesh, pl, run_check=False, shape=spec.shape,
                                  stride=tuple(stride))

    return {"pos": 0, "layers": [_map_cache(lambda _, s: empty(s), None, specs)
                                 for specs in model.cache_specs(batch, cache_len)]}
