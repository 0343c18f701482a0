"""The MoE archs' serving path under a mesh against the JAX package's sharded
steps (smoke configs, CPU, 8 ranks).

mixtral-8x7b and dbrx-132b (their smoke configs route 4 experts top-2) on
meshes (2, 4), (4, 2) and (1, 8) over ("data", "model"), under the default
rules (tp, fsdp, sequence parallel). The same f32 weights (``Model.init``
through ``bridge.from_jax_params``) and numpy-seeded tokens and labels (B 4 x
S 48) go through the JAX forward and eval steps jitted with the rules'
shardings on 8 fake CPU devices, and through the port's sharded steps, every
rank simulated in one process (``parallel.mesh.simulated_ranks``). Both
split the tokens into one dispatch group a data rank (2, 4 and 1 groups),
each routed with its own capacity.

Held here:
  * the sharded forward's last-position logits within 5e-5 absolute and
    the eval loss within 1e-6 relative (tests/test_torch_mesh.py's rules);
  * the placements of the MoE layer's grouped tensors (xt, the dispatch
    tensor xg, the gated hidden h and the expert outputs y) at every
    constraint the port makes, against the JAX ``resolve_spec`` of the same
    logical axes and shape at the reference's constraint: expert
    parallelism on (2, 4) and (4, 2) (4 experts over a model axis of 4 or
    2), the ff fallback on (1, 8) (4 experts do not divide 8: ff over
    model);
  * on (4, 2) the answer depends on the grouping: the port's unsharded
    forward with 4 groups is within 5e-5 of the JAX sharded step, with one
    group it is far from it (smaller capacities a group drop other
    assignments);
  * a batch of 2 rows in the mesh's groups, the port's sharded forward
    against its unsharded one (5e-5): on (4, 2) its rows do not split over
    the data axis while its 4 groups do.

One subprocess an (arch, mesh), all six started together: a process group,
LocalTensorMode and JAX's fake devices are global to a process.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ("mixtral-8x7b", "dbrx-132b")
MESHES = ((2, 4), (4, 2), (1, 8))
F32_ATOL, LOSS_RTOL = 5e-5, 1e-6
IDS = {"ids": lambda m: "x".join(map(str, m))}

PARITY = textwrap.dedent("""
    import json, sys, types
    import numpy as np
    import jax, jax.numpy as jnp
    import torch
    import repro.train.train_step as jts
    from repro.configs.base import ParallelConfig as JParallel
    from repro.configs.registry import get_config as jax_config
    from repro.models import build_model as jax_build
    from repro.parallel import sharding as js
    from repro.parallel.mesh import make_mesh as jax_mesh, mesh_context
    from repro.train.serve_step import make_forward_step as jax_forward
    from repro.train.train_step import make_eval_step as jax_eval
    from repro_torch.bridge import from_jax_params
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.models import Ctx, Model
    from repro_torch.parallel import sharding
    from repro_torch.parallel.mesh import make_mesh, simulated_ranks
    from repro_torch.train.serve_step import make_forward_step
    from repro_torch.train.train_step import make_eval_step

    torch.set_num_threads(1)
    arch = sys.argv[1]
    mesh_shape = tuple(int(n) for n in sys.argv[2].split("x"))
    B, S = 4, 48
    jcfg = jax_config(arch, smoke=True)
    jm = jax_build(jcfg)
    params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32),
                                    jm.init(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, jcfg.vocab_size, (B, S))
    labels = rng.randint(0, jcfg.vocab_size, (B, S))
    labels[:, -3:] = -1                                   # padding
    np_params = jax.tree_util.tree_map(np.asarray, params)
    shape = types.SimpleNamespace(global_batch=B, seq_len=S, kind="train")

    def trimmed(spec):
        spec = [list(e) if isinstance(e, tuple) else e for e in spec]
        while spec and spec[-1] is None:
            spec.pop()
        return spec

    def port_spec(t):
        # a DTensor's placements as a PartitionSpec's entries
        spec = [[] for _ in range(t.ndim)]
        for name, pl in zip(t.device_mesh.mesh_dim_names, t.placements):
            if pl.is_shard():
                spec[pl.dim].append(name)
        return trimmed([None if not e else e[0] if len(e) == 1 else tuple(e) for e in spec])

    def key(axes, shp):
        return json.dumps([list(axes), [int(n) for n in shp]])

    # the MoE call sites' constraints (axes that lead with "groups"): the
    # spec JAX resolves there, and the placements the port's hook gives
    jax_seen, port_seen = {}, {}
    jax_make = jts.make_shard_fn

    def jax_recording(mesh, parallel):
        f = jax_make(mesh, parallel)
        rules = js.activation_rules(parallel)

        def g(x, axes):
            if axes[0] == "groups":
                jax_seen[key(axes, x.shape)] = trimmed(js.resolve_spec(axes, x.shape, rules,
                                                                       mesh))
            return f(x, axes)
        return g

    jts.make_shard_fn = jax_recording
    par = JParallel()
    jmesh = jax_mesh(mesh_shape, ("data", "model"))
    psh = js.tree_shardings(jmesh, jm.param_specs(), js.param_rules(par))
    bsh = js.tree_shardings(jmesh, js.batch_specs(jcfg, shape, jm), js.activation_rules(par))
    jp = jax.device_put(params, psh)
    batch = jax.device_put({"tokens": jnp.asarray(tokens, jnp.int32),
                            "labels": jnp.asarray(labels, jnp.int32)}, bsh)
    with mesh_context(jmesh):
        want = np.asarray(jax.jit(jax_forward(jm, par, jmesh))(jp, batch["tokens"]))
        want_loss = float(jax.jit(jax_eval(jm, par, jmesh))(jp, batch)["loss"])

    cfg = get_config(arch, smoke=True)
    model = Model(cfg, device="cpu")
    model.load_state_dict(from_jax_params(np_params, cfg, device="cpu"), strict=True,
                          assign=True)
    # the port unsharded, with the mesh's groups and with one; and on two
    # rows, which (4, 2)'s 4 groups split within a row
    groups = mesh_shape[0]
    half = torch.from_numpy(tokens[:2])
    with torch.no_grad():
        one = {g: model.apply(torch.from_numpy(tokens), Ctx(moe_groups=g))[:, -1].numpy()
               for g in (groups, 1)}
        half_want = model.apply(half, Ctx(moe_groups=groups))[:, -1].numpy()
    port_make = sharding.make_shard_fn

    def port_recording(mesh, parallel):
        f = port_make(mesh, parallel)

        def g(x, axes):
            out = f(x, axes)
            if axes[0] == "groups":
                port_seen.setdefault(key(axes, x.shape), []).append(port_spec(out))
            return out
        return g

    sharding.make_shard_fn = port_recording
    with simulated_ranks(8) as mode:
        mesh = make_mesh(mesh_shape, ("data", "model"), "cpu")
        p = ParallelConfig()
        sharding.shard_model(model, mesh, p)
        ins = sharding.shard_inputs(
            {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)},
            sharding.batch_specs(model, "train", B, S), mesh, p)
        got = make_forward_step(model, parallel=p, mesh=mesh)(ins["tokens"]).full_tensor()
        loss = make_eval_step(model, p, mesh)(ins)
        got_loss, got_aux = loss["loss"].full_tensor(), loss["aux"].full_tensor()
        sharding.make_shard_fn = port_make        # the steps above recorded
        half_in = sharding.shard_inputs({"tokens": half},
                                        sharding.batch_specs(model, "prefill", 2, S), mesh, p)
        got_half = make_forward_step(model, parallel=p, mesh=mesh)(half_in["tokens"])
        half_placed = str(half_in["tokens"].placements)
        got_half = got_half.full_tensor()
        with mode.disable():
            got = got.reconcile().numpy()
            got_loss, got_aux = float(got_loss.reconcile()), float(got_aux.reconcile())
            got_half = got_half.reconcile().numpy()

    def err(a):
        return float(np.abs(a - want).max())

    print(json.dumps({
        "err": err(got), "max": float(np.abs(want).max()), "shape": list(got.shape),
        "want_shape": list(want.shape), "finite": bool(np.isfinite(got).all()),
        "loss": got_loss, "want_loss": want_loss, "aux": got_aux, "groups": groups,
        "unsharded": err(one[groups]), "one_group": err(one[1]),
        "half": float(np.abs(got_half - half_want).max()), "half_placed": half_placed,
        "jax": jax_seen, "port": port_seen}))
""")


def _run(code, *args, devices=None):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, os.environ.get("PYTHONPATH", "")]))
    if devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    return subprocess.Popen([sys.executable, "-c", code, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


_results = {}


def result(arch, mesh):
    """PARITY's results of (arch, mesh); the six processes start together at
    the first call and are kept for the module."""
    if not _results:
        procs = {(a, m): _run(PARITY, a, "x".join(map(str, m)), devices=8)
                 for a in ARCHS for m in MESHES}
        for k, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-4000:]
            _results[k] = json.loads(out.strip().splitlines()[-1])
    return _results[arch, mesh]


@pytest.mark.parametrize("mesh", MESHES, **IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_moe_forward_logits_match_the_jax_sharded_step(arch, mesh):
    r = result(arch, mesh)
    assert r["shape"] == r["want_shape"] == [4, 512] and r["finite"], r
    print(arch, mesh, r["groups"], "groups: max |logit| error", r["err"], "of", r["max"])
    assert r["err"] <= F32_ATOL, r


@pytest.mark.parametrize("mesh", MESHES, **IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_moe_eval_loss_matches_the_jax_sharded_step(arch, mesh):
    r = result(arch, mesh)
    print(arch, mesh, "loss", r["loss"], "JAX", r["want_loss"], "aux", r["aux"])
    assert abs(r["loss"] - r["want_loss"]) <= LOSS_RTOL * abs(r["want_loss"]), r
    assert r["aux"] > 0


# the resolved spec of the dispatch tensor and the expert outputs (xg, y:
# groups, experts, -, embed) and of the gated hidden (h: groups, experts, -,
# ff): expert parallelism where the 4 experts divide the model axis, else ff
# over it; the groups over data where it has more than one rank
WANT = {(2, 4): ({"xg": ["data", "model"], "h": ["data", "model"]}),
        (4, 2): ({"xg": ["data", "model"], "h": ["data", "model"]}),
        (1, 8): ({"xg": [], "h": [None, None, None, "model"]})}


@pytest.mark.parametrize("mesh", MESHES, **IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_placements_are_the_jax_specs(arch, mesh):
    """Every constraint of the MoE layer the port makes, at the shape it
    makes it, resolves as the JAX constraint of the same logical axes and
    shape: the port makes no other, and none that JAX does not."""
    r = result(arch, mesh)
    assert r["port"].keys() == r["jax"].keys(), (r["port"].keys(), r["jax"].keys())
    seen = {}
    for k, specs in r["port"].items():
        axes, _ = json.loads(k)
        assert all(s == r["jax"][k] for s in specs), (k, specs, r["jax"][k])
        seen["h" if axes[-1] == "ff" else "xg" if axes[1] == "experts" else "xt"] = specs[0]
    assert seen["xg"] == WANT[mesh]["xg"] and seen["h"] == WANT[mesh]["h"], seen
    assert seen["xt"] == (["data"] if mesh[0] > 1 else []), seen


@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_groups_decide_the_answer_on_4x2(arch):
    """On (4, 2) the port's unsharded forward routed in the mesh's 4 groups
    is the JAX sharded step's answer; routed in one group it is not."""
    r = result(arch, (4, 2))
    print(arch, "(4, 2): unsharded with 4 groups", r["unsharded"], "with one", r["one_group"])
    assert r["groups"] == 4 and r["unsharded"] <= F32_ATOL, r
    assert r["one_group"] > 100 * F32_ATOL, r


@pytest.mark.parametrize("mesh", MESHES, **IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_groups_that_split_batch_rows_match_the_unsharded_layer(arch, mesh):
    """Two rows in the mesh's groups: on (4, 2) the 2 rows do not split
    over the 4 data ranks (the tokens come whole) while the 4 groups do, so
    each rank takes half a row's tokens and the outputs are gathered back;
    the sharded forward within 5e-5 of the port's unsharded one in 4
    groups."""
    r = result(arch, mesh)
    print(arch, mesh, "two rows: max |logit - unsharded|", r["half"], r["half_placed"])
    # the rows split over data on (2, 4) alone ((1, 8) has one data rank)
    assert r["half_placed"].startswith("(Shard(dim=0)") == (mesh == (2, 4)), r
    assert r["half"] <= F32_ATOL, r
