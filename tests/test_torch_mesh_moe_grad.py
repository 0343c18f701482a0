"""The MoE archs' gradient under a mesh against the port's own unsharded
gradient (smoke configs, CPU, 8 simulated ranks; no JAX).

The same seeded f32 weights and numpy-seeded tokens and labels (B 4 x S 48,
B 8 under zero3) go through ``model.loss`` unsharded, routed in the mesh's
dispatch groups (``Ctx(moe_groups=train_step.moe_groups(par, mesh))``), and
sharded under ``train_step.make_ctx``. Every gradient leaf, gathered from
the placements of its param, is held within 1e-5 of the leaf's max, the
router of each layer (``layers.N.moe.router``) by name among them:
mixtral-8x7b and dbrx-132b on (2, 4) and (4, 2) under the default rules
(2 and 4 dispatch groups, split over the data axis), and dbrx-132b on (2, 4)
under ``model_axis="zero3"`` (8 groups, split over both axes).

The router is gathered whole for the routing, but each rank routes only its
own groups, so its gradient of the router is a partial sum over the mesh
dims that split them. Placed as a replicated gradient instead, the gather's
backward keeps one rank's part where it should reduce-scatter the sum: the
router's gradient then lies 0.5-0.9 of its max away, on every mesh here.

One subprocess a case, all started together: a process group and
LocalTensorMode are global to a process.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
GRAD_RTOL = 1e-5
# (arch, mesh, ParallelConfig fields, batch)
CASES = [("mixtral-8x7b", (2, 4), {}, 4), ("mixtral-8x7b", (4, 2), {}, 4),
         ("dbrx-132b", (2, 4), {}, 4), ("dbrx-132b", (4, 2), {}, 4),
         ("dbrx-132b", (2, 4), {"model_axis": "zero3"}, 8)]

CASE = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.models import Ctx, Model
    from repro_torch.parallel import sharding
    from repro_torch.parallel.mesh import make_mesh, simulated_ranks
    from repro_torch.train import train_step as ts

    torch.set_num_threads(1)
    arch, shape, kw, B = sys.argv[1], tuple(json.loads(sys.argv[2])), json.loads(sys.argv[3]), \\
        int(sys.argv[4])
    S = 48
    cfg = get_config(arch, smoke=True)
    par = ParallelConfig(**kw)
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, cfg.vocab_size, (B, S))
    labels = rng.randint(0, cfg.vocab_size, (B, S))
    labels[:, -3:] = -1                                   # padding
    batch = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    model = Model(cfg, device="cpu", seed=0, trainable=True).float()
    groups = ts.moe_groups(par, dict(zip(("data", "model"), shape)))
    want_loss = model.loss(batch, Ctx(moe_groups=groups))[0]
    want_loss.backward()
    want = {k: p.grad.clone() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    with simulated_ranks(8) as mode:
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        sharding.shard_model(model, mesh, par)
        ins = sharding.shard_inputs(batch, sharding.batch_specs(model, "train", B, S), mesh,
                                    par)
        with implicit_replication():
            loss = model.loss(ins, ts.make_ctx(par, mesh))[0]
            loss.backward()
        got = {k: ts._placed_as(p.grad, p).full_tensor() for k, p in model.named_parameters()}
        loss = loss.full_tensor()
    errs = {}
    for k, g in got.items():
        g = g.reconcile()
        errs[k] = float((g - want[k]).abs().max() / want[k].abs().max().clamp_min(1e-30))
    print(json.dumps({"groups": groups, "errs": errs, "loss": float(loss.reconcile()),
                      "want_loss": float(want_loss)}))
""")


def _key(case):
    arch, mesh, kw, _ = case
    return f"{arch}-{'x'.join(map(str, mesh))}" + "".join(f"-{v}" for v in kw.values())


_results = {}


def result(case):
    """CASE's result of `case`; the processes of every case start together
    at the first call."""
    if not _results:
        env = dict(os.environ,
                   PYTHONPATH=os.pathsep.join([SRC, os.environ.get("PYTHONPATH", "")]))
        procs = {_key(c): subprocess.Popen(
            [sys.executable, "-c", CASE, c[0], json.dumps(c[1]), json.dumps(c[2]), str(c[3])],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
            for c in CASES}
        for k, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-4000:]
            _results[k] = json.loads(out.strip().splitlines()[-1])
    return _results[_key(case)]


@pytest.mark.parametrize("case", CASES, ids=_key)
def test_sharded_moe_gradient_is_the_unsharded_gradient(case):
    r = result(case)
    errs = r["errs"]
    routers = {k: v for k, v in errs.items() if k.endswith(".moe.router")}
    worst = max(errs, key=errs.get)
    print(_key(case), r["groups"], "groups: routers", routers, "worst leaf", worst, errs[worst])
    assert r["groups"] == (8 if case[2] else case[1][0])
    assert len(routers) == 3, routers                # the smoke configs' three layers
    assert max(routers.values()) <= GRAD_RTOL, routers
    assert errs[worst] <= GRAD_RTOL, (worst, errs[worst])
    assert abs(r["loss"] - r["want_loss"]) <= 1e-6 * abs(r["want_loss"]), r
