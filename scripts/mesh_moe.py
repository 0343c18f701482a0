#!/usr/bin/env python3
"""Run phase 8's MoE runs under a mesh (``chip_smoke.phase_mesh`` on the
``MESH_RUNS`` of an arch with experts: prefill and decode sharded, routed in
the mesh's dispatch groups, against the unsharded twin with its routing
pinned) and phase 7's MoE forward captures (``MESH_MOE_CAPTURE``, held by
``check_moe_captures``) alone, in one process on one card: the short call
after a change to MoE under a mesh.

  python3 scripts/mesh_moe.py

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
        print("mesh_moe: no GPU found", file=sys.stderr)
        return 2
    sys.path.insert(0, cs.SRC)
    from repro_torch.configs.registry import get_config
    card = cs.phase_device(torch)
    t0 = time.perf_counter()
    runs = [r for r in cs.MESH_RUNS if get_config(r.arch).num_experts]
    cs.phase_mesh(torch, card, runs)
    t_mesh = time.perf_counter() - t0
    archs, dense, shape, batch, depths = cs.MESH_MOE_CAPTURE
    what = cs.mesh_what("forward", shape, batch)
    by_key = {}
    t0 = time.perf_counter()
    for arch, ds in [(a, depths) for a in archs] + [(dense, depths[:2])]:
        for L in ds:
            r = cs.capture_path(torch, cs.mesh_config(get_config, arch, L), what)
            by_key[(r["config"], r["what"])] = r
    cs.check_moe_captures(by_key)
    t_capture = time.perf_counter() - t0
    cs.log(f"[mesh_moe] phase 8's MoE runs {t_mesh:.1f} s, MoE captures {t_capture:.1f} s")
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
