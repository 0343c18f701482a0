"""Checkpointing: atomic, keep-last-k, async-capable (counterpart of
``repro/train/checkpoint.py``).

Format: one directory per step, ``step_<8 digits>``, containing
  * arrays.npz  -- the state's leaves keyed by path: ``params/<name>``,
                   ``opt/step``, ``opt/mu/<name>``, ``opt/nu/<name>`` (the
                   port's parameter names; bf16 leaves as their uint16 bits)
  * meta.json   -- step, timestamp, user metadata
A save writes into a temporary directory and renames it into place.
Checkpoints do not cross between the two packages yet (ROADMAP queue 1,
item 5).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.train.optimizer import OptState
from repro_torch.train.train_step import TrainState


def flatten_state(state: TrainState) -> dict:
    """{path: tensor or int} of a TrainState."""
    flat = {f"params/{k}": v for k, v in state.params.items()}
    flat["opt/step"] = state.opt.step
    flat.update({f"opt/mu/{k}": v for k, v in state.opt.mu.items()})
    flat.update({f"opt/nu/{k}": v for k, v in state.opt.nu.items()})
    flat.update({f"err/{k}": v for k, v in state.err.items()})
    return flat


def _host(x) -> np.ndarray:
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach().to("cpu", copy=True)        # a copy even of a CPU tensor
    if x.dtype == torch.bfloat16:
        return x.view(torch.uint16).numpy()
    return x.numpy()


def save_checkpoint(ckpt_dir: str, step: int, state: TrainState,
                    meta: Optional[dict] = None, keep: int = 3, async_save: bool = False):
    """Atomically persist ``state`` under ckpt_dir/step_<step>. The host copy
    is taken before returning, so an async save may overlap later steps."""
    os.makedirs(ckpt_dir, exist_ok=True)
    host = {k: _host(v) for k, v in flatten_state(state).items()}
    meta = dict(meta or {})
    meta.update({"step": int(step), "time": time.time()})

    def write():
        tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
        try:
            np.savez(os.path.join(tmp, "arrays.npz"), **host)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            final = os.path.join(ckpt_dir, f"step_{step:08d}")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        _cleanup(ckpt_dir, keep)

    if async_save:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def _cleanup(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    return int(steps[-1].split("_")[1]) if steps else None


@torch.no_grad()
def restore_checkpoint(ckpt_dir: str, step: int, template: TrainState):
    """Restore into ``template``: every tensor leaf is overwritten in place
    (its dtype and device kept, so a model whose parameters are the
    template's params holds the restored weights). Returns (state, meta)."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with np.load(os.path.join(d, "arrays.npz")) as z:
        data = {k: z[k] for k in z.files}
    flat = flatten_state(template)
    for key, leaf in flat.items():
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key}")
        if not isinstance(leaf, torch.Tensor):
            continue
        arr = data[key]
        if leaf.dtype == torch.bfloat16:
            src = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
        else:
            src = torch.from_numpy(np.array(arr))
        if tuple(src.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(src.shape)} != "
                             f"{tuple(leaf.shape)}")
        leaf.copy_(src.to(leaf.dtype))
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    opt = OptState(int(data["opt/step"]), template.opt.mu, template.opt.nu)
    return TrainState(template.params, opt, template.err), meta
