"""AdamW with f32 moments, gradient clipping and the LR schedule.

Counterpart of ``repro/train/optimizer.py``. Params, grads and moments are
dicts of tensors keyed by the model's parameter names. The update runs leaf
by leaf, and a large leaf in slices of at most ``SLICE`` elements, in place:
gemma3-4b's embedding alone is 671 M parameters, and an f32 temporary of all
of it would be 2.7 GB. Elementwise, each slice computes exactly what the
whole leaf would.

Under a mesh the params are DTensors (``parallel.sharding.shard_model``)
and the moments are DTensors placed as their param, the ZeRO semantics of
the JAX package (its ``opt_state_logical_axes``): each rank holds and
updates only its shards. A param, its grad and its moments share their
placements, so the update runs on each rank's local shards, and the global
norm sums each rank's local squares and reduces them once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

SLICE = 1 << 24          # elements of one f32 temporary of the update (64 MB)


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: int                # updates taken so far
    mu: dict                 # first moment, {name: f32 tensor, a DTensor placed as its param}
    nu: dict                 # second moment, the same


def init_opt_state(params: dict) -> OptState:
    # f32 zeros placed as each param (of a DTensor, each rank's shard)
    f32 = lambda p: torch.zeros_like(p, dtype=torch.float32,  # noqa: E731
                                     memory_format=torch.contiguous_format)
    return OptState(step=0, mu={k: f32(p) for k, p in params.items()},
                    nu={k: f32(p) for k, p in params.items()})


def lr_at(cfg: OptConfig, step) -> float:
    """Linear warmup to ``lr``, then cosine down to ``min_lr_ratio * lr`` at
    ``total_steps``. Computed in f32, as the JAX package does."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    step = f32(float(step))
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clip((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                      0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(f32(math.pi) * prog))
    return float(cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos))


def _slices(t):
    flat = t.view(-1)
    return flat.split(SLICE) if flat.numel() > SLICE else (flat,)


def _sum_squares(t, total=None):
    for part in _slices(t):
        sq = part.float().square().sum()
        total = sq if total is None else total + sq
    return total


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a 0-d tensor).
    A DTensor leaf's local squares are summed on each rank. Over a mesh dim
    that shards the leaf the ranks' sums are parts of its sum; over one that
    replicates it each rank's sum is the whole, so it counts 1/size of it
    (exact for a power of two). Every leaf's parts are added on each rank,
    and the sum, Partial over the mesh, is reduced once; the result is the
    replicated sum's local value."""
    total, parts = None, None
    for leaf in tree.values():
        if not isinstance(leaf, DTensor):
            total = _sum_squares(leaf, total)
            continue
        mesh = leaf.device_mesh
        sq = _sum_squares(leaf.to_local())
        copies = math.prod(mesh.size(i) for i, p in enumerate(leaf.placements)
                           if p.is_replicate())
        sq = DTensor.from_local(sq / copies, mesh, [Partial()] * mesh.ndim, run_check=False)
        parts = sq if parts is None else parts + sq
    if parts is not None:
        whole = parts.redistribute(parts.device_mesh, [Replicate()] * parts.device_mesh.ndim)
        total = whole.to_local() if total is None else total + whole.to_local()
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return total.sqrt()


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


@torch.no_grad()
def adamw_update(cfg: OptConfig, params: dict, grads: dict, state: OptState,
                 ndims: dict | None = None):
    """Updates ``params`` and the moments in place; returns (params, new
    state, metrics {gnorm, lr}). f32 math: the clip by global norm, bias
    correction, decoupled weight decay on matrices only (ndim >= 2), and the
    new value cast back to the param's dtype. ``ndims`` gives each leaf's
    ndim for that rule where it is not the tensor's own: the trainer passes
    ``Model.stacked_ndims()``, the JAX package's layout. DTensor params
    take grads and moments of their placements, and each rank updates its
    local shards: the same f32 math as on the whole tensor."""
    step = state.step + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_at(cfg, step)
    f32 = torch.float32
    b1c = 1 - torch.tensor(cfg.b1, dtype=f32) ** step
    b2c = 1 - torch.tensor(cfg.b2, dtype=f32) ** step
    for name, p in params.items():
        g, mu, nu = grads[name], state.mu[name], state.nu[name]
        if isinstance(p, DTensor):
            placed = [t.placements if isinstance(t, DTensor) else None for t in (g, mu, nu)]
            if any(pl != p.placements for pl in placed):
                raise ValueError(f"{name}: grad and moments must be DTensors placed as the "
                                 f"param {p.placements}; got {placed}")
        decay = (p.dim() if ndims is None else ndims[name]) >= 2
        p, g, mu, nu = _local(p), _local(g), _local(mu), _local(nu)
        if not p.is_contiguous():
            raise ValueError(f"{name}: the update runs on contiguous params only")
        dev = p.device
        clip_d, b1c_d, b2c_d = clip.to(dev), b1c.to(dev), b2c.to(dev)
        for pp, gg, mm, nn in zip(_slices(p), _slices(g.contiguous()), _slices(mu),
                                  _slices(nu)):
            gg = gg.float() * clip_d
            mm.mul_(cfg.b1).add_((1 - cfg.b1) * gg)
            nn.mul_(cfg.b2).add_((1 - cfg.b2) * gg.square())
            delta = (mm / b1c_d).div_((nn / b2c_d).sqrt_().add_(cfg.eps))
            p32 = pp.float()
            if decay:
                delta.add_(cfg.weight_decay * p32)
            pp.copy_(p32.sub_(lr * delta))
    return params, OptState(step, state.mu, state.nu), {"gnorm": gnorm, "lr": lr}
