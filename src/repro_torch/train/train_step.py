"""Train / eval step makers (counterpart of ``repro/train/train_step.py``).

make_train_step(model, ...) returns a function
    (TrainState, batch) -> (TrainState, metrics)
with optional microbatched gradient accumulation. PyTorch runs eagerly, so
the step makers return plain closures where the JAX package returns
functions to jit. The params of a TrainState are the model's own parameter
tensors, and a step updates them and the moments in place (the JAX step is
pure; in place saves a second copy of 46.6 GB of state at gemma3-4b's
width). A failure before the optimizer update leaves the state as it was,
so a step that raised there can be run again.

Under a mesh (``mesh``, a ``DeviceMesh``) the train and eval steps run on
a model made sharded by ``parallel.sharding.shard_model`` and take the batch
as DTensors (``shard_inputs``). The train step's gradients come back placed
as their params (FSDP/ZeRO-3: a weight gathered for its products has its
gradient reduce-scattered into its shards), and AdamW updates each rank's
shards of the params and of the moments, which ``init_train_state`` places
as the params.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ParallelConfig
from repro_torch.models.model import Ctx, Model
from repro_torch.parallel import sharding
from repro_torch.parallel.mesh import dp_size, model_size
from repro_torch.train.optimizer import (OptConfig, OptState, adamw_update,
                                         init_opt_state)


class TrainState(NamedTuple):
    params: dict           # {name: the model's parameter}
    opt: OptState
    err: dict              # error-feedback state for compressed DP ({}: none here)


def make_ctx(parallel: ParallelConfig, mesh=None) -> Ctx:
    return Ctx(remat=parallel.remat, shard_fn=sharding.make_shard_fn(mesh, parallel),
               moe_groups=moe_groups(parallel, mesh))


def moe_groups(parallel: ParallelConfig, mesh=None) -> int:
    """The MoE dispatch groups of a step, as the JAX ``make_ctx`` sets them:
    one a data-parallel rank, times the model axis under zero3 (where it is
    data-parallel too); 1 without a mesh."""
    if mesh is None:
        return 1
    groups = dp_size(mesh)
    if parallel.model_axis == "zero3":
        groups *= model_size(mesh)
    return groups


def under_mesh(fn, model: Model, mesh, train: bool = False):
    """``fn`` as it runs with a model sharded over ``mesh``: the arch
    checked for the step's kind (``check_mesh_support``), and the call
    inside ``implicit_replication``, where a plain tensor that meets a
    DTensor counts as replicated. ``fn`` itself without a mesh."""
    if mesh is None:
        return fn
    from torch.distributed.tensor.experimental import implicit_replication
    sharding.check_mesh_support(model.cfg, train)

    @functools.wraps(fn)
    def step(*args, **kwargs):
        with implicit_replication():
            return fn(*args, **kwargs)

    return step


def init_train_state(model: Model) -> TrainState:
    """The state of a model made with ``trainable=True`` (its seeded init
    stands for the JAX package's ``model.init(rng)``); of a sharded model,
    its moments are DTensors placed as the params."""
    params = dict(model.named_parameters())
    frozen = [k for k, p in params.items() if not p.requires_grad]
    if frozen:
        raise ValueError(f"parameters do not require grad (make the model with "
                         f"trainable=True): {frozen[:3]}")
    return TrainState(params=params, opt=init_opt_state(params), err={})


def _microbatches(batch, m, model=None, mesh=None, parallel=None):
    """Microbatch i: rows [i b/m, (i+1) b/m) of the batch, as the JAX step's
    reshape to (m, b/m, ...) takes them. Under a mesh each is placed as
    ``shard_inputs`` places a batch of b/m (the slice of a batch split over
    its rows gathers them: tokens and labels, a few KB)."""
    b = batch["tokens"].shape[0]
    if b % m:
        raise ValueError(f"batch {b} not divisible by microbatches {m}")
    n = b // m
    mbs = [{k: v[i * n:(i + 1) * n] for k, v in batch.items()} for i in range(m)]
    if mesh is None:
        return mbs
    specs = sharding.batch_specs(model, "train", n, batch["tokens"].shape[1])
    return [sharding.shard_inputs(mb, specs, mesh, parallel) for mb in mbs]


def _placed_as(g, p):
    """A DTensor param's grad redistributed to the param's placements (it
    may come back Partial, as a product's gradient of a gathered weight)."""
    if isinstance(p, DTensor) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(model: Model, opt_cfg: OptConfig, parallel: ParallelConfig,
                    mesh=None):
    ctx = make_ctx(parallel, mesh)
    ndims = model.stacked_ndims()          # the decay rule in the JAX layout

    def grads_of(params, batch):
        for p in params.values():
            p.grad = None
        loss, metrics = model.loss(batch, ctx)
        loss.backward()
        grads = {}
        for k, p in params.items():
            # zeros_like of a DTensor param is a DTensor placed as it
            grads[k] = _placed_as(p.grad, p) if p.grad is not None else torch.zeros_like(p)
            p.grad = None
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(state: TrainState, batch):
        params = state.params
        m = parallel.microbatches
        if m > 1:
            # grads summed in f32 (placed as the params), then averaged;
            # the loss averaged; the metrics of the last microbatch
            acc = {k: torch.zeros_like(p, dtype=torch.float32,
                                       memory_format=torch.contiguous_format)
                   for k, p in params.items()}
            loss = 0.0
            for mb in _microbatches(batch, m, model, mesh, parallel):
                l, metrics, g = grads_of(params, mb)
                for k, gk in g.items():
                    acc[k].add_(gk.float())
                loss = loss + l
                del g
            grads = {k: a.div_(m) for k, a in acc.items()}
            loss = loss / m
        else:
            loss, metrics, grads = grads_of(params, batch)
        _, new_opt, opt_metrics = adamw_update(opt_cfg, params, grads, state.opt, ndims)
        del grads
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return TrainState(params, new_opt, state.err), metrics

    return under_mesh(train_step, model, mesh, train=True)


def make_eval_step(model: Model, parallel: ParallelConfig, mesh=None):
    ctx = make_ctx(parallel, mesh)

    @torch.no_grad()
    def eval_step(batch):
        """The model's loss on ``batch`` with its current parameters (the
        JAX step takes them as an argument; here the model holds them)."""
        loss, metrics = model.loss(batch, ctx)
        return {"loss": loss, **metrics}

    return under_mesh(eval_step, model, mesh)
