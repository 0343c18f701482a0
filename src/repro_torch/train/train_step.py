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

Under a mesh (``mesh``, a ``DeviceMesh``) the eval step runs on a model
made sharded by ``parallel.sharding.shard_model`` and takes the batch as
DTensors (``shard_inputs``); the train step under a mesh is not ported yet.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.configs.base import ParallelConfig
from repro_torch.models.model import Ctx, Model
from repro_torch.parallel import sharding
from repro_torch.train.optimizer import (OptConfig, OptState, adamw_update,
                                         init_opt_state)


class TrainState(NamedTuple):
    params: dict           # {name: the model's parameter}
    opt: OptState
    err: dict              # error-feedback state for compressed DP ({}: none here)


def make_ctx(parallel: ParallelConfig, mesh=None) -> Ctx:
    return Ctx(remat=parallel.remat, shard_fn=sharding.make_shard_fn(mesh, parallel))


def under_mesh(fn, model: Model, mesh):
    """``fn`` as it runs with a model sharded over ``mesh``: the arch
    checked (``check_mesh_support``), and the call inside
    ``implicit_replication``, where a plain tensor that meets a DTensor
    counts as replicated. ``fn`` itself without a mesh."""
    if mesh is None:
        return fn
    from torch.distributed.tensor.experimental import implicit_replication
    sharding.check_mesh_support(model.cfg)

    @functools.wraps(fn)
    def step(*args, **kwargs):
        with implicit_replication():
            return fn(*args, **kwargs)

    return step


def init_train_state(model: Model) -> TrainState:
    """The state of a model made with ``trainable=True`` (its seeded init
    stands for the JAX package's ``model.init(rng)``)."""
    params = dict(model.named_parameters())
    frozen = [k for k, p in params.items() if not p.requires_grad]
    if frozen:
        raise ValueError(f"parameters do not require grad (make the model with "
                         f"trainable=True): {frozen[:3]}")
    return TrainState(params=params, opt=init_opt_state(params), err={})


def _microbatches(batch, m):
    b = batch["tokens"].shape[0]
    if b % m:
        raise ValueError(f"batch {b} not divisible by microbatches {m}")
    return [{k: v[i * (b // m):(i + 1) * (b // m)] for k, v in batch.items()}
            for i in range(m)]


def make_train_step(model: Model, opt_cfg: OptConfig, parallel: ParallelConfig,
                    mesh=None):
    if mesh is not None:
        raise NotImplementedError(sharding.TRAIN_WAITS)
    ctx = make_ctx(parallel)
    ndims = model.stacked_ndims()          # the decay rule in the JAX layout

    def grads_of(params, batch):
        for p in params.values():
            p.grad = None
        loss, metrics = model.loss(batch, ctx)
        loss.backward()
        grads = {}
        for k, p in params.items():
            grads[k] = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = None
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(state: TrainState, batch):
        params = state.params
        m = parallel.microbatches
        if m > 1:
            # grads summed in f32, then averaged; the loss averaged; the
            # metrics of the last microbatch
            acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for k, p in params.items()}
            loss = 0.0
            for mb in _microbatches(batch, m):
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

    return train_step


def make_eval_step(model: Model, parallel: ParallelConfig, mesh=None):
    ctx = make_ctx(parallel, mesh)

    @torch.no_grad()
    def eval_step(batch):
        """The model's loss on ``batch`` with its current parameters (the
        JAX step takes them as an argument; here the model holds them)."""
        loss, metrics = model.loss(batch, ctx)
        return {"loss": loss, **metrics}

    return under_mesh(eval_step, model, mesh)
