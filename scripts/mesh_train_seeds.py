#!/usr/bin/env python3
"""Run phase 8's train step under a mesh (``chip_smoke.phase_mesh_train``:
gemma3-4b, 6 layers at full width, f32, mesh (2, 4), every rank simulated
on one card, 3 steps against the unsharded step) once for each of several
seeds, one process a seed, and print each step's readings.

  python3 scripts/mesh_train_seeds.py --seeds 1 2 3

The seed replaces ``chip_smoke.SEED``, from which the weights (SEED) and the
tokens (SEED + 2) are made. A process prints its ``[mesh] train`` lines;
a failed check (``chip_smoke: FAIL``) is printed and the next seed runs.
Ends with one JSON object, {seed: {"rc", "steps": [{"update", "norm",
"grad"}]}}, and the card's name and power limit; needs a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TURN = ("import sys; sys.path.insert(0, '.'); import chip_smoke as cs; import torch; "
        "sys.path.insert(0, cs.SRC); cs.SEED = {seed}; card = cs.phase_device(torch); "
        "print('CARD', card, flush=True); cs.phase_mesh_train(torch, card)")
STEP = re.compile(r"step (\d+):.*max gradient leaf error (\S+) .*sharded norm (\S+) "
                  r"\(rule \S+\); the norms (\S+) apart")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    args = ap.parse_args(argv)
    out, card = {}, ""
    for seed in args.seeds:
        run = subprocess.run([sys.executable, "-c", TURN.format(seed=seed)], cwd=HERE,
                             capture_output=True, text=True)
        lines = [x for x in (run.stdout + run.stderr).splitlines()
                 if x.startswith("[mesh] train") or "FAIL" in x]
        for x in lines:
            print(f"seed {seed}: {x}", flush=True)
        steps = [{"grad": float(m[2]), "update": float(m[3]), "norm": float(m[4])}
                 for m in map(STEP.search, lines) if m]
        out[seed] = {"rc": run.returncode, "steps": steps}
        if run.returncode and not lines:
            print(run.stderr[-3000:], file=sys.stderr)
        card = next((x[len("CARD "):] for x in run.stdout.splitlines()
                     if x.startswith("CARD ")), card)
    print(json.dumps(out))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
