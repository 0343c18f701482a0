"""Serving steps: prefill + batched single-token decode.

Counterpart of ``repro/train/serve_step.py``. PyTorch runs eagerly, so the
step makers return plain closures where the JAX package returns functions
to jit. Under a mesh (``mesh``, a ``DeviceMesh``, with ``parallel`` for
the rules) the prefill and forward steps run on a model made sharded by
``parallel.sharding.shard_model`` and take DTensor inputs
(``shard_inputs``), and decode runs on that model over a cache placed by
the cache rules.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ParallelConfig
from repro_torch.models.model import Ctx, Model
from repro_torch.parallel import sharding
from repro_torch.train.train_step import moe_groups, under_mesh


def _ctx(ctx, parallel, mesh):
    if mesh is None:
        return ctx or Ctx()
    if ctx is not None:
        raise ValueError("under a mesh the step makes its own Ctx: pass parallel, not ctx")
    # serving keeps no activations for a backward, so nothing is rematted
    parallel = parallel or ParallelConfig()
    return Ctx(shard_fn=sharding.make_shard_fn(mesh, parallel),
               moe_groups=moe_groups(parallel, mesh))


def make_prefill_step(model: Model, cache_len: int, ctx: Ctx | None = None, *,
                      parallel: ParallelConfig | None = None, mesh=None):
    ctx = _ctx(ctx, parallel, mesh)

    def prefill_step(tokens, memory=None):
        return model.prefill(tokens, cache_len, ctx, memory)

    return under_mesh(prefill_step, model, mesh)


def make_forward_step(model: Model, ctx: Ctx | None = None, *,
                      parallel: ParallelConfig | None = None, mesh=None):
    """A full-sequence forward (the JAX package's prefill dry-run shape):
    ``model.apply`` over every position, then the last position's logits
    (B, V). Unlike ``prefill`` it unembeds every position and keeps no
    cache."""
    ctx = _ctx(ctx, parallel, mesh)

    def forward(tokens, memory=None):
        return model.apply(tokens, ctx, memory)[:, -1]

    return under_mesh(forward, model, mesh)


def make_decode_step(model: Model, ctx: Ctx | None = None, *,
                     parallel: ParallelConfig | None = None, mesh=None):
    """One token against the cache: (token (B, 1), cache) -> (logits (B, V),
    cache), the cache updated in place. Under a mesh the cache comes from
    the sharded prefill, ``model.init_cache(..., mesh=...)`` or
    ``sharding.shard_cache``; each layer's is placed by the cache rules at
    the first step, and under ``seq_shard_cache`` its length stays split
    over the data axis (flash-decoding, ``attention._sharded_decode``)."""
    ctx = _ctx(ctx, parallel, mesh)

    def decode_step(token, cache):
        return model.decode_step(token, cache, ctx)

    return under_mesh(decode_step, model, mesh)


def sample_token(logits, temperature: float = 0.0, generator=None):
    """logits (B, V) -> (B, 1) int64. Greedy at temperature 0; otherwise a
    draw from softmax(logits / temperature) with ``generator`` (required)."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1, keepdim=True)
    if generator is None:
        raise ValueError("sampling at temperature > 0 needs a torch.Generator")
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)


def generate(model: Model, prompt, steps: int, cache_len: int = 0,
             temperature: float = 0.0, generator=None, ctx: Ctx | None = None,
             memory=None, *, parallel: ParallelConfig | None = None, mesh=None):
    """Greedy/temperature generation: prompt (B,S) -> (B, steps) token ids.
    ``memory``: the stub frontend's embeddings, for an arch with
    cross-attention (``model.memory_len() > 0``). Under a mesh (the model
    sharded, the prompt from ``shard_inputs``) each step's logits are
    gathered whole before sampling, and the ids come back whole."""
    cache_len = cache_len or (prompt.shape[1] + steps)
    prefill = make_prefill_step(model, cache_len, ctx, parallel=parallel, mesh=mesh)
    decode = make_decode_step(model, ctx, parallel=parallel, mesh=mesh)

    def sample(logits):
        if isinstance(logits, DTensor):
            logits = logits.full_tensor()
        return sample_token(logits, temperature, generator)

    logits, cache = prefill(prompt, memory)
    tok = sample(logits)
    toks = [tok]
    for _ in range(steps - 1):
        logits, cache = decode(tok, cache)
        tok = sample(logits)
        toks.append(tok)
    return torch.cat(toks, dim=1)
