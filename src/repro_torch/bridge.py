"""Weight, optimizer-state and cache bridge from the JAX package's pytrees
to the port.

The JAX model stacks the superblock's layers along a leading ``layers`` axis
(``blocks/sb/slot{i}``, one entry per repeat) and keeps the remainder as
``blocks/rem{j}``; the port holds one ``ParamTree`` per layer. Slot i of
repeat r becomes layer ``r * len(superblock) + i``; remainder j follows the
stack. The encoder of an enc-dec model is stacked the same way
(``encoder/sb/slot0``, one entry per encoder layer) and becomes
``encoder.layers.N``. Every other subtree keeps its path. Inputs are nested
dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``), so
this module needs no JAX; bf16 moves bit-exactly through a uint16 view.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _flatten(tree, prefix=""):
    for key in sorted(tree):
        path = f"{prefix}{key}"
        if isinstance(tree[key], dict):
            yield from _flatten(tree[key], path + ".")
        else:
            yield path, tree[key]


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.itemsize == 2 and a.dtype.kind not in "fiu":    # bf16 (ml_dtypes or npz void)
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _unstack(tree, cfg):
    """Flat {port path: array} of a JAX params-or-cache tree (see module doc)."""
    nsb = len(cfg.superblock)
    flat = {}

    def put(key, leaf):
        if key in flat:
            raise ValueError(f"two JAX leaves map to {key}")
        flat[key] = leaf

    def spread(path, leaf, n, what, name):
        """Entry r of a stacked leaf (leading axis n, cfg.<what>) to name(r)."""
        if np.shape(leaf)[0] != n:
            raise ValueError(f"{path}: leading axis {np.shape(leaf)[0]} != {what} {n}")
        for r in range(n):
            put(name(r), leaf[r])

    for path, leaf in _flatten(tree):
        parts = path.split(".")
        if parts[0] == "encoder":
            if parts[1:3] == ["sb", "slot0"]:
                spread(path, leaf, cfg.encoder_layers, "encoder_layers",
                       lambda n: ".".join([f"encoder.layers.{n}"] + parts[3:]))
            elif parts[1] == "final_norm":
                put(path, leaf)
            else:
                raise ValueError(f"unexpected JAX encoder leaf {path}")
        elif parts[0] != "blocks":
            put(path, leaf)
        elif parts[1] == "sb":
            i = int(parts[2][len("slot"):])
            spread(path, leaf, cfg.sb_repeat, "sb_repeat",
                   lambda r: ".".join([f"layers.{r * nsb + i}"] + parts[3:]))
        elif parts[1].startswith("rem"):
            j = int(parts[1][len("rem"):])
            put(".".join([f"layers.{nsb * cfg.sb_repeat + j}"] + parts[2:]), leaf)
        else:
            raise ValueError(f"unexpected JAX block {path}")
    return flat


def from_jax_params(tree, cfg, device=None) -> dict[str, torch.Tensor]:
    """JAX ``Model.init`` pytree -> the port's state dict (load it with
    ``model.load_state_dict(..., strict=True)``)."""
    device = resolve_device(device)
    return {k: _tensor(v, device) for k, v in _unstack(tree, cfg).items()}


def from_jax_opt_state(opt_state, cfg, device=None):
    """JAX ``OptState`` (step, mu, nu; leaves as numpy) -> the port's
    ``OptState``, mu and nu unstacked as ``from_jax_params`` unstacks params."""
    from repro_torch.train.optimizer import OptState
    device = resolve_device(device)
    step, mu, nu = opt_state
    return OptState(step=int(np.asarray(step)),
                    mu={k: _tensor(v, device) for k, v in _unstack(mu, cfg).items()},
                    nu={k: _tensor(v, device) for k, v in _unstack(nu, cfg).items()})


def from_jax_cache(tree, cfg, device=None) -> dict:
    """JAX decode cache (``Model.prefill`` / ``init_cache``) -> the port's
    cache: {"pos": int, "layers": [per-layer cache dict, ...]}; each layer's
    dict keeps the JAX subtrees (``attn``, ``mixer``, an enc-dec layer's
    ``xattn``)."""
    device = resolve_device(device)
    flat = _unstack({k: v for k, v in tree.items() if k != "pos"}, cfg)
    layers = [{} for _ in cfg.layer_kinds]
    for key, leaf in flat.items():
        _, n, *rest = key.split(".")
        node = layers[int(n)]
        for part in rest[:-1]:
            node = node.setdefault(part, {})
        node[rest[-1]] = _tensor(leaf, device)
    return {"pos": int(np.asarray(tree["pos"])), "layers": layers}
