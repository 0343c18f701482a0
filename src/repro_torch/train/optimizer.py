"""AdamW with f32 moments, gradient clipping and the LR schedule.

Counterpart of ``repro/train/optimizer.py``, on one device (no ZeRO
sharding). Params, grads and moments are dicts of tensors keyed by the
model's parameter names. The update runs leaf by leaf, and a large leaf in
slices of at most ``SLICE`` elements, in place: gemma3-4b's embedding alone
is 671 M parameters, and an f32 temporary of all of it would be 2.7 GB.
Elementwise, each slice computes exactly what the whole leaf would.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

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
    mu: dict                 # first moment, {name: f32 tensor}
    nu: dict                 # second moment, {name: f32 tensor}


def init_opt_state(params: dict) -> OptState:
    f32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
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


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a 0-d tensor)."""
    total = None
    for leaf in tree.values():
        for part in _slices(leaf):
            sq = part.float().square().sum()
            total = sq if total is None else total + sq
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return total.sqrt()


@torch.no_grad()
def adamw_update(cfg: OptConfig, params: dict, grads: dict, state: OptState,
                 ndims: dict | None = None):
    """Updates ``params`` and the moments in place; returns (params, new
    state, metrics {gnorm, lr}). f32 math: the clip by global norm, bias
    correction, decoupled weight decay on matrices only (ndim >= 2), and the
    new value cast back to the param's dtype. ``ndims`` gives each leaf's
    ndim for that rule where it is not the tensor's own: the trainer passes
    ``Model.stacked_ndims()``, the JAX package's layout."""
    step = state.step + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_at(cfg, step)
    f32 = torch.float32
    b1c = 1 - torch.tensor(cfg.b1, dtype=f32) ** step
    b2c = 1 - torch.tensor(cfg.b2, dtype=f32) ** step
    for name, p in params.items():
        if not p.is_contiguous():
            raise ValueError(f"{name}: the update runs on contiguous params only")
        parts = zip(_slices(p), _slices(grads[name].contiguous()),
                    _slices(state.mu[name]), _slices(state.nu[name]))
        for pp, g, mu, nu in parts:
            g = g.float() * clip.to(g.device)
            mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            nu.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
            delta = (mu / b1c.to(g.device)).div_(
                (nu / b2c.to(g.device)).sqrt_().add_(cfg.eps))
            p32 = pp.float()
            if (p.dim() if ndims is None else ndims[name]) >= 2:
                delta.add_(cfg.weight_decay * p32)
            pp.copy_(p32.sub_(lr * delta))
    return params, OptState(step, state.mu, state.nu), {"gnorm": gnorm, "lr": lr}
