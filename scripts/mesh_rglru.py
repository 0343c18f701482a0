#!/usr/bin/env python3
"""Run phase 8's recurrentgemma-9b runs under a mesh (``chip_smoke.phase_mesh``
on its ``MESH_RUNS``: the 5-layer cut's prefill and decode sharded over (2, 4)
in bf16 and f32, K3 on each rank's local channels, against the unsharded run)
and phase 7's recurrentgemma-9b captures under a mesh (the measured prefill,
the full-depth forward and the decode step on (16, 16), held by
``check_mesh_captures`` and ``check_rg_decode_capture``) alone, in one
process on one card: the short call after a change to RG-LRU under a
mesh.

  python3 scripts/mesh_rglru.py

Prints phase 8's ``[mesh]`` lines, each capture's ``[capture]`` line and
seconds, the seconds of each part, and the card's name and power limit;
exits non-zero where a check fails (``chip_smoke: FAIL``); needs a GPU. The
kernels build at their first use (K3 in the first prefill).
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
        print("mesh_rglru: no GPU found", file=sys.stderr)
        return 2
    sys.path.insert(0, cs.SRC)
    from repro_torch.configs.registry import get_config
    card = cs.phase_device(torch)
    t0 = time.perf_counter()
    out = cs.phase_mesh(torch, card, [r for r in cs.MESH_RUNS if r.arch == cs.RG_ARCH])
    t_mesh = time.perf_counter() - t0
    runs = {(r["config"], tuple(r["mesh"])): r for r in out.values()
            if r["dtype"] == "bfloat16"}
    captures = [c for c in cs.MESH_CAPTURES if c[0] == cs.RG_ARCH]
    jobs = [(cs.mesh_config(get_config, arch, layers), cs.mesh_what(step, mesh, batch))
            for arch, layers, step, mesh, batch in captures]
    jobs.append((get_config(cs.RG_ARCH), cs.mesh_what("decode", *cs.MESH_RG_DECODE_CAPTURE)))
    by_key = {}
    t0 = time.perf_counter()
    for cfg, what in jobs:
        r = cs.capture_path(torch, cfg, what)
        by_key[(r["config"], r["what"])] = r
        cs.log(f"[capture] {r['config']} {what}: {r['seconds']:.1f} s")
    cs.check_mesh_captures(by_key, runs, captures)
    cs.check_rg_decode_capture(by_key, runs)
    t_capture = time.perf_counter() - t0
    cs.log(f"[mesh_rglru] phase 8's recurrentgemma-9b runs {t_mesh:.1f} s, its captures "
           f"{t_capture:.1f} s")
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
