#!/usr/bin/env python3
"""Time an arch's prefill in this tree against another checkout of the
repository (the parent commit), in turns, in one call on one card, alone
and with the tree's capture process running beside it.

  mkdir -p build/ab/parent && git archive HEAD | tar -x -C build/ab/parent
  python3 scripts/prefill_vs_parent.py build/ab/parent --arch seamless-m4t-medium

Each turn is a process of its own, started in that tree, that runs the
tree's ``chip_smoke.phase_serve`` for the arch (B 4 x 2048 tokens, one
timed prefill a call) ``--reps`` times alone, then starts the tree's capture
process (``chip_smoke.start_captures``, the one that runs beside phases 4-6
of ``chip_smoke.py``), waits ``--settle`` seconds, and runs it ``--reps``
times more. Turns: the other tree, this tree twice, the other tree. Each
tree builds its kernels at first use into its own ``build/``. Prints each
turn's prefill ms, then one JSON object and the card's name and power limit;
needs a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TURN = """
import json, sys, time
sys.path.insert(0, '.')
import chip_smoke as cs
import torch
sys.path.insert(0, cs.SRC)
from repro_torch.configs.registry import get_config
card = cs.phase_device(torch)
arch = {arch!r}
per_prefill = {{"flash_attention": len(cs.k1_layers(cs.serve_config(get_config, arch)))}}
alone = [cs.phase_serve(torch, arch, per_prefill)["prefill_ms"] for _ in range({reps})]
torch.cuda.empty_cache()
proc = cs.start_captures()
time.sleep({settle})
beside = [cs.phase_serve(torch, arch, per_prefill)["prefill_ms"] for _ in range({reps})]
running = proc.poll() is None
proc.kill()
proc.wait()
print("TURN", json.dumps({{"alone": alone, "beside": beside, "captures_running": running,
                          "card": card}}))
"""


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", help="the other checkout's root")
    ap.add_argument("--arch", default="seamless-m4t-medium")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--settle", type=float, default=10.0)
    args = ap.parse_args(argv)
    trees = {"other": os.path.abspath(args.other), "this": HERE}
    code = TURN.format(arch=args.arch, reps=args.reps, settle=args.settle)
    turns = []
    for name in ("other", "this", "this", "other"):
        out = subprocess.run([sys.executable, "-c", code], cwd=trees[name],
                             capture_output=True, text=True)
        if out.returncode:
            print(out.stdout[-3000:], out.stderr[-3000:], file=sys.stderr)
            return out.returncode
        line = next(x for x in out.stdout.splitlines() if x.startswith("TURN"))
        r = json.loads(line[len("TURN "):])
        print(f"{name}: prefill ms alone {r['alone']}, beside the capture process "
              f"{r['beside']} (still running at the end: {r['captures_running']})", flush=True)
        turns.append({"tree": name, **{k: r[k] for k in ("alone", "beside",
                                                          "captures_running")}})
    print(json.dumps({"arch": args.arch, "turns": turns}))
    print(r["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
