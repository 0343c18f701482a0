#!/usr/bin/env python3
"""Run phase 8's train steps under a mesh (``chip_smoke.phase_mesh_train``
on ``MESH_TRAIN`` and ``MESH_MOE_TRAIN``: the sharded step against the
unsharded step from the same state, the MoE run's routing pinned to the
unsharded step's) and phase 7's train-step captures on (16, 16)
(``MESH_TRAIN_CAPTURE`` and ``MESH_MOE_TRAIN_CAPTURE``, held by
``check_train_capture``) alone, in one process on one card: the short call
after a change to the train step under a mesh.

  python3 scripts/mesh_moe_train.py

Prints phase 8's ``[mesh]`` lines, each capture's ``[capture]`` line, the
seconds of each part, and the card's name and power limit; exits non-zero where a check
fails (``chip_smoke: FAIL``); needs a GPU. K1 builds at its first use.
"""
from __future__ import annotations

import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402


def main():
    import torch
    if not torch.cuda.is_available():
        print("mesh_moe_train: no GPU found", file=sys.stderr)
        return 2
    sys.path.insert(0, cs.SRC)
    from repro_torch.configs.registry import get_config
    card = cs.phase_device(torch)
    seconds = {}
    t0 = time.perf_counter()
    runs = cs.phase_mesh_train(torch, card, cs.MESH_MOE_TRAIN)
    seconds["moe train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    runs.update(cs.phase_mesh_train(torch, card))
    seconds["dense train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    by_key = {}
    jobs = [(cs.MESH_TRAIN_CAPTURE[0], cs.MESH_TRAIN_CAPTURE[1:])]
    jobs += [(arch, cs.MESH_MOE_TRAIN_CAPTURE[1:]) for arch in cs.MESH_MOE_TRAIN_CAPTURE[0]]
    for arch, (shape, batch, depths) in jobs:
        for L in depths:
            r = cs.capture_path(torch, cs.mesh_config(get_config, arch, L),
                                cs.mesh_what("train", shape, batch))
            by_key[(r["config"], r["what"])] = r
    cs.check_train_capture(by_key, runs)
    seconds["captures"] = time.perf_counter() - t0
    cs.log(f"[mesh_moe_train] seconds {({k: round(v, 1) for k, v in seconds.items()})}")
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
