#!/usr/bin/env python3
"""Run phase 8's serving path under a mesh (``chip_smoke.phase_mesh``: each
``MESH_RUNS`` prefill, its decode steps under the mesh against the unsharded
decode, the ``seq_shard_cache`` run) and phase 7's decode captures
(``MESH_DECODE_CAPTURES``, held by ``check_decode_captures``) alone, in one
process on one card: the short call after a change to decode under a mesh.

  python3 scripts/mesh_decode.py

Prints phase 8's ``[mesh]`` lines, each capture's ``[capture]`` line and
seconds, the seconds of each part, and the card's name and power limit;
exits non-zero where a check fails (``chip_smoke: FAIL``); needs a GPU. The
kernels build at their first use (K1 in the first prefill).
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
        print("mesh_decode: no GPU found", file=sys.stderr)
        return 2
    sys.path.insert(0, cs.SRC)
    from repro_torch.configs.registry import get_config
    t0 = time.perf_counter()
    card = cs.phase_device(torch)
    cs.phase_mesh(torch, card)
    t_mesh = time.perf_counter() - t0
    by_key = {}
    t0 = time.perf_counter()
    for c in cs.MESH_DECODE_CAPTURES:
        r = cs.capture_path(torch, get_config(cs.QWEN), cs.mesh_what("decode", *c))
        by_key[(r["config"], r["what"])] = r
    cs.check_decode_captures(by_key)
    t_capture = time.perf_counter() - t0
    cs.log(f"[mesh_decode] phase 8 {t_mesh:.1f} s, decode captures {t_capture:.1f} s")
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
