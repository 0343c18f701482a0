"""Deterministic synthetic data pipeline (counterpart of ``repro/train/data.py``).

Stateless-resumable: batch(step) is a pure function of (seed, step, shape),
so restarting from a checkpoint at step k replays the exact token stream.
The port has its own generator (``jax.random`` cannot be reproduced here) and
keeps the reference's stream law:
  * a banded Markov chain: a uniform start token, then jumps of 1, 2, 3 or 5
    with probabilities 0.55, 0.2, 0.15 and 0.1, cumulated mod vocab;
  * a copied motif: the first ``min(32, seq_len // 4)`` tokens spliced in
    again at ``seq_len // 2`` (when at least 4 long);
  * labels are the tokens shifted by one;
  * an arch with cross-attention also gets the stub frontend's memory
    (B, memory_len, d_model): standard normals in bf16 times 0.02, drawn
    after the tokens from the same generator.
Tests that compare the two packages feed both the reference's batches.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device

JUMPS = (1, 2, 3, 5)
JUMP_PROBS = (0.55, 0.2, 0.15, 0.1)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    memory_len: int = 0          # stub frontend tokens (vlm/audio)
    d_model: int = 0


def _generator(seed: int, step: int) -> torch.Generator:
    """A CPU torch.Generator seeded from (seed, step) alone."""
    words = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(words[0]) << 32 | int(words[1]))


def _markov_tokens(gen, batch, seq, vocab):
    start = torch.randint(0, vocab, (batch, 1), generator=gen)
    probs = torch.tensor(JUMP_PROBS, dtype=torch.float64).expand(batch, -1)
    jumps = torch.multinomial(probs, seq, replacement=True, generator=gen)
    return (start + torch.cumsum(torch.tensor(JUMPS)[jumps], dim=1)) % vocab


def make_batch(cfg: DataConfig, step: int, device=None) -> dict:
    """Pure function of (cfg, step) -> {tokens, labels} (B, seq_len) int64,
    and with ``memory_len`` {memory} (B, memory_len, d_model) bf16, drawn on
    the CPU and moved to ``device`` (``None`` means ``cuda``)."""
    gen = _generator(cfg.seed, step)
    toks = _markov_tokens(gen, cfg.global_batch, cfg.seq_len + 1, cfg.vocab_size)
    motif_len = min(32, cfg.seq_len // 4)
    if motif_len >= 4:
        mid = cfg.seq_len // 2
        toks[:, mid:mid + motif_len] = toks[:, :motif_len]
    device = resolve_device(device)
    batch = {"tokens": toks[:, :-1].to(device), "labels": toks[:, 1:].to(device)}
    if cfg.memory_len:
        mem = torch.randn(cfg.global_batch, cfg.memory_len, cfg.d_model, generator=gen)
        batch["memory"] = (mem.to(torch.bfloat16) * 0.02).to(device)
    return batch


class DataIterator:
    """Step-indexed iterator with exact resume."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, device=None):
        self.cfg = cfg
        self.step = start_step
        self.device = device

    def __next__(self):
        b = make_batch(self.cfg, self.step, self.device)
        self.step += 1
        return b

    def __iter__(self):
        return self
