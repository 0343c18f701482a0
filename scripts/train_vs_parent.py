#!/usr/bin/env python3
"""Time an arch's training step in this tree against another checkout of
the repository (the parent commit), in turns, in one call on one card.

  mkdir -p build/ab/parent && git archive HEAD | tar -x -C build/ab/parent
  python3 scripts/train_vs_parent.py build/ab/parent --arch mamba2-780m

Each turn is a process of its own, started in that tree, that runs the
tree's ``chip_smoke.phase_train`` (the arch at its training cut, B 2 x S
2048, remat full, 6 AdamW steps; the median of steps 2-6): the other tree,
this tree twice, the other tree. Each tree builds its kernels at first use
into its own ``build/``. Prints each turn's step ms and losses, then one
JSON object and the card's name and power limit; needs a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TURN = ("import json, sys; sys.path.insert(0, '.'); import chip_smoke as cs; import torch; "
        "sys.path.insert(0, cs.SRC); card = cs.phase_device(torch); "
        "r = cs.phase_train(torch, card, {arch!r}); "
        "print('TURN', json.dumps({{'step_ms': r['step_ms'], 'card': card}}))")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", help="the other checkout's root")
    ap.add_argument("--arch", default="mamba2-780m")
    args = ap.parse_args(argv)
    trees = {"other": os.path.abspath(args.other), "this": HERE}
    turns = []
    for name in ("other", "this", "this", "other"):
        out = subprocess.run([sys.executable, "-c", TURN.format(arch=args.arch)],
                             cwd=trees[name], capture_output=True, text=True)
        if out.returncode:
            print(out.stdout[-3000:], out.stderr[-3000:], file=sys.stderr)
            return out.returncode
        line = next(x for x in out.stdout.splitlines() if x.startswith("TURN"))
        r = json.loads(line[len("TURN "):])
        train = [x for x in out.stdout.splitlines() if x.startswith("[train]")]
        print(f"{name}: {r['step_ms']:.2f} ms a step; {train[-1] if train else ''}", flush=True)
        turns.append({"tree": name, "step_ms": r["step_ms"]})
    print(json.dumps({"arch": args.arch, "turns": turns}))
    print(r["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
