"""The MoE archs' train step under a mesh against the JAX package's sharded
train step (smoke configs, CPU, 8 ranks).

mixtral-8x7b and dbrx-132b (their smoke configs route 4 experts top-2) on
meshes (2, 4), (4, 2) and (1, 8) over ("data", "model") under the default
``ParallelConfig()`` (tp, fsdp, sequence parallel; remat dots: expert
parallelism where the 4 experts divide the model axis, ff over it on
(1, 8)), dbrx-132b on (2, 4) under ``model_axis="zero3"`` (8 dispatch
groups, B 8) and mixtral-8x7b on (2, 4) under ``microbatches=2`` (B 8, each
microbatch routed in 2 groups of its own): eight ranks simulated in one
process (``parallel.mesh.simulated_ranks``), against the JAX train step
jitted with the same rules' shardings on 8 fake CPU devices, from the same
f32 weights (``Model.init`` through ``bridge.from_jax_params``) and
numpy-seeded tokens and labels with padding, B 4 (8) x S 48,
``OptConfig(warmup_steps=0)``. The rules of tests/test_torch_mesh_train.py:
  * the first step's loss, 1e-6 relative, and gnorm, 1e-5 relative
    (mixtral-8x7b 2e-5: without a mesh its port is 1.32e-5 from JAX's), and
    both against the port's own unsharded loss and gradient, routed in the
    mesh's groups, 1e-6 and 1e-5;
  * every gradient leaf that the step hands AdamW, gathered, against the
    JAX gradient of ``jax.value_and_grad(model.loss)`` under the same mesh
    (the mean over the microbatches for ``microbatches=2``), within 3e-4 of
    the leaf's max (the MoE archs' unsharded tolerance,
    tests/test_torch_moe.py), each layer's router held by name;
  * each gradient, first moment and second moment is a DTensor placed as
    its param (the experts' split over the model axis, by experts or by
    ff), and each rank holds only its shard;
  * at every step (3 on (2, 4) under the defaults and under zero3, 1 on
    the others), AdamW on the DTensors equals the unsharded
    ``adamw_update`` of the gathered state within 1e-6 of each leaf's max;
  * remat none, dots and full give the same gradients under a mesh, 1e-6
    relative (mixtral-8x7b on (2, 4): the recompute routes again).
The routing is compared, not absorbed: each MoE call of the port's first
step (every rank's groups gathered) chooses the experts that the JAX
model's routing chooses from the input its own sharded forward gave that
layer (read through ``jax.debug.callback``, the layer known by its router),
or the test fails with the token and its gate margin; and the remat
recompute of each layer routes bit for bit as its forward.

Every case runs in a subprocess (the default process group and JAX's fake
devices are global to a process); the JAX and port processes of every run
list start together at the first test and write the gradients and
routings to files. This file holds mixtral-8x7b's runs (with the remat
runs); tests/test_torch_mesh_moe_train_2.py holds dbrx-132b's by the same
tests, so that pytest-xdist's workers take the two halves in parallel.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LOSS_RTOL, GNORM_RTOL, GRAD_RTOL, OPT_RTOL, REMAT_RTOL = 1e-6, 1e-5, 3e-4, 1e-6, 1e-6
# the gnorm against JAX's: GNORM_RTOL, but for mixtral-8x7b, whose smoke
# config's port sits 1.32e-5 from the JAX gnorm without a mesh (f32, the same
# weights and batch, in 1, 2 or 4 groups; its gradient leaves agree within
# the MoE archs' 3e-4). Against the port's own unsharded step, GNORM_RTOL
JAX_GNORM_RTOL = {"mixtral-8x7b": 2e-5, "dbrx-132b": GNORM_RTOL}
REMAT_ARCH, REMAT_MESH = "mixtral-8x7b", "2x4"
K = 2                                   # the smoke configs' experts a token

# (key, mesh, ParallelConfig fields, batch, steps) of each run, by process:
# two processes (a JAX and a port one) for each list. Steps after the first
# hold only AdamW (a step of a simulated mesh costs 5-10 s of CPU here)
PROCS = [("mixtral-8x7b", [["2x4", [2, 4], {}, 4, 3], ["4x2", [4, 2], {}, 4, 1]]),
         ("mixtral-8x7b", [["1x8", [1, 8], {}, 4, 1],
                           ["2x4/mb2", [2, 4], {"microbatches": 2}, 8, 1]]),
         ("dbrx-132b", [["2x4", [2, 4], {}, 4, 3], ["4x2", [4, 2], {}, 4, 1]]),
         ("dbrx-132b", [["1x8", [1, 8], {}, 4, 1],
                        ["2x4/zero3", [2, 4], {"model_axis": "zero3"}, 8, 3]])]
STEPS = {(arch, r[0]): r[4] for arch, runs in PROCS for r in runs}
MICRO = {(arch, r[0]): r[2].get("microbatches", 1) for arch, runs in PROCS for r in runs}
# this file's run lists
JOBS = [p for p in PROCS if p[0] == "mixtral-8x7b"]


def keys_of(jobs):
    return [(arch, r[0]) for arch, runs in jobs for r in runs]


KEYS = keys_of(JOBS)

COMMON = textwrap.dedent("""
    import json, sys, time
    import numpy as np
    import jax, jax.numpy as jnp
    import torch
    from repro.configs.registry import get_config as jax_config
    from repro.models import build_model as jax_build
    from repro_torch.bridge import from_jax_params
    from repro_torch.configs.registry import get_config

    torch.set_num_threads(1)
    arch, out_dir, runs = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
    T0 = time.perf_counter()
    S = 48
    jcfg = jax_config(arch, smoke=True)
    jm = jax_build(jcfg)
    params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32),
                                    jm.init(jax.random.PRNGKey(0)))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    cfg = get_config(arch, smoke=True)

    def data(B):
        rng = np.random.RandomState(1)
        tokens = rng.randint(0, jcfg.vocab_size, (B, S))
        labels = rng.randint(0, jcfg.vocab_size, (B, S))
        labels[:, -3:] = -1                                   # padding
        return tokens, labels

    def path(key, side, what="grads"):
        return f"{out_dir}/{arch}-{key.replace('/', '-')}-{side}-{what}.pt"
""")

JAX_STEP = COMMON + textwrap.dedent("""
    import types
    from jax.sharding import NamedSharding, PartitionSpec as P
    import repro.models.moe as jax_moe
    from repro.configs.base import ParallelConfig as JParallel
    from repro.parallel import sharding as js
    from repro.parallel.mesh import make_mesh, mesh_context
    from repro.train.optimizer import OptConfig, init_opt_state
    from repro.train.train_step import TrainState, make_ctx, make_train_step

    # each layer's router, to know a recorded MoE input's layer by
    routers = {int(k.split(".")[1]): v.numpy() for k, v in
               from_jax_params(np_params, cfg, device="cpu").items() if k.endswith("moe.router")}
    jax_apply = jax_moe.moe_apply

    def recording(seen):
        def apply(p, x, cfg_, ctx):
            jax.debug.callback(lambda v, r: seen.append((np.asarray(v), np.asarray(r))),
                               x, p["router"])
            return jax_apply(p, x, cfg_, ctx)
        return apply

    def routing(seen, groups):
        # [(gates, top-k ids)] of each layer: the reference's lines
        # (repro/models/moe.py) on the input its sharded forward gave the layer
        out = {}
        for x, router in seen:
            (layer,) = [i for i, r in routers.items() if np.array_equal(r, router)]
            B_, S_, D = x.shape
            G = groups if (B_ * S_) % groups == 0 else 1
            gates = jax.nn.softmax(jnp.einsum("gtd,de->gte", jnp.asarray(x).reshape(G, -1, D),
                                              jnp.asarray(router)), axis=-1)
            out.setdefault(layer, (np.asarray(gates),
                                   np.asarray(jax.lax.top_k(gates, jcfg.experts_per_token)[1])))
        return [out[i] for i in sorted(out)]

    out = {}
    for key, mesh_shape, kw, B, _ in runs:
        tokens, labels = data(B)
        par = JParallel(**kw)
        mesh = make_mesh(tuple(mesh_shape), ("data", "model"))
        psh = js.tree_shardings(mesh, jm.param_specs(), js.param_rules(par))

        def placed(tok, lab):
            shape = types.SimpleNamespace(global_batch=tok.shape[0], seq_len=S, kind="train")
            bsh = js.tree_shardings(mesh, js.batch_specs(jcfg, shape, jm),
                                    js.activation_rules(par))
            return jax.device_put({"tokens": jnp.asarray(tok, jnp.int32),
                                   "labels": jnp.asarray(lab, jnp.int32)}, bsh)

        jp = jax.device_put(params, psh)
        opt = jax.device_put(init_opt_state(params),
                             type(init_opt_state(params))(NamedSharding(mesh, P()), psh, psh))
        with mesh_context(mesh):
            _, met = jax.jit(make_train_step(jm, OptConfig(warmup_steps=0), par, mesh))(
                TrainState(jp, opt, {}), placed(tokens, labels))
            ctx = make_ctx(par, mesh)
            vg = jax.jit(jax.value_and_grad(lambda p, b: jm.loss(p, b, ctx), has_aux=True))
            m, n = par.microbatches, B // par.microbatches
            grads, routes = None, []
            mbs = [placed(tokens[i * n:(i + 1) * n], labels[i * n:(i + 1) * n])
                   for i in range(m)]
            for mb in mbs:              # the JAX step's sum in f32, then / m
                _, g = vg(jp, mb)
                grads = g if grads is None else jax.tree_util.tree_map(jnp.add, grads, g)
            grads = jax.tree_util.tree_map(lambda g: g / m, grads)
            # the routing of each microbatch, from a forward of its own (the
            # callback stays out of the programs whose gradients are held)
            for mb in mbs:
                seen = []
                jax_moe.moe_apply = recording(seen)
                try:
                    jax.jit(lambda p, b: jm.loss(p, b, ctx)[0])(jp, mb)
                    jax.effects_barrier()
                finally:
                    jax_moe.moe_apply = jax_apply
                routes.append(routing(seen, ctx.moe_groups))
        torch.save(from_jax_params(jax.tree_util.tree_map(np.asarray, grads), cfg,
                                   device="cpu"), path(key, "jax"))
        torch.save(routes, path(key, "jax", "routes"))
        out[key] = {"loss": float(met["loss"]), "gnorm": float(met["gnorm"]),
                    "lr": float(met["lr"]), "groups": ctx.moe_groups,
                    "seconds": time.perf_counter() - T0}
    print(json.dumps(out))
""")

PORT_STEP = COMMON + textwrap.dedent("""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.models import Ctx, Model, moe
    from repro_torch.parallel import sharding
    from repro_torch.parallel.mesh import coordinate, make_mesh, simulated_ranks
    from repro_torch.train import train_step as ts
    from repro_torch.train.optimizer import OptConfig, OptState

    remat_key = sys.argv[4] if len(sys.argv) > 4 else ""
    adamw, route = ts.adamw_update, moe.route

    def local_shape(t):
        shape = list(t.shape)
        for i, p in enumerate(t.placements):
            if p.is_shard():
                shape[p.dim] //= t.device_mesh.size(i)
        return shape

    def rel(got, want):
        return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))

    def gathered(d):
        return {k: v.full_tensor() for k, v in d.items()}

    def whole_groups(top_i, mesh, par, groups):
        # the (G, Tg, k) expert ids of every group from the ranks' local
        # groups, placed as the MoE layer places its grouped tokens; the
        # ranks that share groups must agree
        n, tg, k = next(iter(top_i._local_tensors.values())).shape
        pl = sharding.resolve_placements(("groups", None, "embed_nos"), (groups, tg, cfg.d_model),
                                         sharding.activation_rules(par), mesh)
        out = torch.full((groups, tg, k), -1, dtype=torch.int64)
        for r, local in top_i._local_tensors.items():
            region = sharding.shard_region(out, mesh, pl, coordinate(mesh, r))
            assert (region < 0).all() or torch.equal(region, local), "ranks disagree"
            region.copy_(local)
        assert (out >= 0).all()
        return out

    out = {}
    for key, mesh_shape, kw, B, steps in runs:
        tokens, labels = data(B)
        par = ParallelConfig(**kw)
        model = Model(cfg, device="cpu", trainable=True)
        model.load_state_dict(from_jax_params(np_params, cfg, device="cpu"), strict=True,
                              assign=True)
        # the port's unsharded twin: the mean loss and the norm of the mean
        # gradient over the microbatches, each routed in the mesh's groups
        m, n = par.microbatches, B // par.microbatches
        ctx0 = Ctx(moe_groups=ts.moe_groups(par, dict(zip(("data", "model"), mesh_shape))))
        twin_loss = 0.0
        for i in range(m):
            mb = {"tokens": torch.from_numpy(tokens[i * n:(i + 1) * n]),
                  "labels": torch.from_numpy(labels[i * n:(i + 1) * n])}
            loss0 = model.loss(mb, ctx0)[0] / m
            loss0.backward()
            twin_loss += float(loss0)
        twin = {"loss": twin_loss,
                "gnorm": float(sum(p.grad.double().square().sum() for p in model.parameters())
                               ** 0.5)}
        model.zero_grad(set_to_none=True)
        rec = {"placed": [], "local": [], "opt": [], "grads": None, "gnorm_whole": []}
        calls = []

        def recording(*a):
            r = route(*a)
            calls.append(r.top_i)
            return r

        @torch.no_grad()
        def spy(cfg_, params, grads, state, ndims=None):
            # what the step hands AdamW, and the update held to the
            # unsharded update of the gathered tensors
            moe.route = route
            for k, p in params.items():
                ts_ = (grads[k], state.mu[k], state.nu[k])
                rec["placed"].append(all(isinstance(t, DTensor) and t.placements == p.placements
                                         for t in ts_))
                rec["local"].append(all(list(t.to_local().shape) == local_shape(p)
                                        for t in (p, *ts_)))
            g, p0, mu0, nu0 = (gathered(d) for d in (grads, params, state.mu, state.nu))
            if rec["grads"] is None:
                rec["grads"] = g
            res = adamw(cfg_, params, grads, state, ndims)
            want_p, want_st, want_met = adamw(cfg_, p0, g, OptState(state.step, mu0, nu0), ndims)
            rec["gnorm_whole"].append(rel(res[2]["gnorm"], want_met["gnorm"]))
            rec["opt"].append(max(rel(t.full_tensor(), w[k])
                                  for k in params
                                  for t, w in ((params[k], want_p), (res[1].mu[k], want_st.mu),
                                               (res[1].nu[k], want_st.nu))))
            return res

        ts.adamw_update = spy
        try:
            with simulated_ranks(8) as mode:
                mesh = make_mesh(tuple(mesh_shape), ("data", "model"), "cpu")
                sharding.shard_model(model, mesh, par)
                ins = sharding.shard_inputs(
                    {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)},
                    sharding.batch_specs(model, "train", B, S), mesh, par)
                groups = ts.moe_groups(par, mesh)
                remat = {}
                if key == remat_key:
                    for r in ("none", "full"):
                        ctx = ts.make_ctx(par.replace(remat=r), mesh)
                        with implicit_replication():
                            model.loss(ins, ctx)[0].backward()
                        remat[r] = {k: ts._placed_as(p.grad, p).full_tensor()
                                    for k, p in model.named_parameters()}
                        model.zero_grad(set_to_none=True)
                state = ts.init_train_state(model)
                moments = all(state.opt.mu[k].placements == state.opt.nu[k].placements
                              == p.placements for k, p in state.params.items())
                step = ts.make_train_step(model, OptConfig(warmup_steps=0), par, mesh)
                metrics = []
                for i in range(steps):
                    moe.route = recording if i == 0 else route
                    state, met = step(state, ins)
                    metrics.append({"loss": float(met["loss"].full_tensor()),
                                    "gnorm": float(met["gnorm"]), "lr": float(met["lr"])})
                remat = {r: max(rel(g[k], rec["grads"][k]) for k in g) for r, g in remat.items()}
                grads = rec["grads"]
                with mode.disable():
                    routes = [whole_groups(t, mesh, par, groups) for t in calls]
        finally:
            ts.adamw_update, moe.route = adamw, route
        torch.save({k: v.reconcile() for k, v in grads.items()}, path(key, "port"))
        torch.save(routes, path(key, "port", "routes"))
        out[key] = {"metrics": metrics, "placed": all(rec["placed"]), "local": all(rec["local"]),
                    "leaves": len(rec["placed"]) // steps, "opt": rec["opt"], "moments": moments,
                    "gnorm_whole": rec["gnorm_whole"], "remat": remat, "groups": groups,
                    "twin": twin,
                    "seconds": time.perf_counter() - T0}
    print(json.dumps(out))
""")


def _run(code, args, devices=None):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, os.environ.get("PYTHONPATH", "")]))
    if devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    return subprocess.Popen([sys.executable, "-c", code, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def run_results(tmp_path_factory, jobs):
    """{(arch, key): (JAX result, port result, JAX grads, port grads, JAX
    routes, port routes)}: a JAX and a port process for each run list of
    ``jobs``, all started together."""
    out_dir = str(tmp_path_factory.mktemp("mesh_moe_train"))
    procs = []
    for arch, runs in jobs:
        args = [arch, out_dir, json.dumps(runs)]
        procs.append(("jax", arch, _run(JAX_STEP, args, devices=8)))
        remat = [REMAT_MESH] if arch == REMAT_ARCH and runs[0][0] == REMAT_MESH else []
        procs.append(("port", arch, _run(PORT_STEP, args + remat)))
    got = {}
    for side, arch, proc in procs:
        out, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, err[-4000:]
        for key, r in json.loads(out.strip().splitlines()[-1]).items():
            got.setdefault((arch, key), {})[side] = r
    res = {}
    for (arch, key), r in got.items():
        files = [os.path.join(out_dir, f"{arch}-{key.replace('/', '-')}-{side}-{what}.pt")
                 for what in ("grads", "routes") for side in ("jax", "port")]
        res[arch, key] = (r["jax"], r["port"], *(torch.load(f, weights_only=False)
                                                 for f in files))
    return res


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_results(tmp_path_factory, JOBS)


def _ids(k):
    return f"{k[0]}-{k[1]}"


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _assert_same_choices(got, want, gates, what):
    """Top-k ids equal; else fail with each differing token's gate margin
    (tests/test_torch_moe.py's rule)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bad = np.argwhere((got != want).any(-1))
    if len(bad):
        lines = []
        for idx in bad[:5]:
            g = np.sort(gates[tuple(idx)])[::-1]
            lines.append(f"token {tuple(int(i) for i in idx)}: port {got[tuple(idx)]}, "
                         f"JAX {want[tuple(idx)]}, gate margin {g[K - 1] - g[K]:.3g}")
        pytest.fail(f"{what}: {len(bad)} routing flips; " + "; ".join(lines))


@pytest.mark.parametrize("case", KEYS, ids=_ids)
def test_loss_and_gnorm_match_the_jax_sharded_train_step(results, case):
    j, p, *_ = results[case]
    first = p["metrics"][0]
    print(case, "seconds", j["seconds"], p["seconds"], "groups", p["groups"])
    print(case, "loss", first["loss"], "JAX", j["loss"], "gnorm", first["gnorm"], "JAX",
          j["gnorm"])
    assert p["groups"] == j["groups"]
    assert abs(first["loss"] - j["loss"]) <= LOSS_RTOL * abs(j["loss"]), (p, j)
    assert abs(first["gnorm"] - j["gnorm"]) <= JAX_GNORM_RTOL[case[0]] * abs(j["gnorm"]), (p, j)
    assert first["lr"] == pytest.approx(j["lr"], rel=1e-7)
    assert all(np.isfinite([m["loss"], m["gnorm"]]).all() for m in p["metrics"])


@pytest.mark.parametrize("case", KEYS, ids=_ids)
def test_loss_and_gnorm_match_the_ports_unsharded_step(results, case):
    """The first step's loss and gnorm against the port's own unsharded
    loss and gradient, routed in the mesh's dispatch groups: only the
    summation order differs."""
    _, p, *_ = results[case]
    first, twin = p["metrics"][0], p["twin"]
    print(case, "loss", first["loss"], "unsharded", twin["loss"], "gnorm", first["gnorm"],
          "unsharded", twin["gnorm"])
    for k, rtol in (("loss", LOSS_RTOL), ("gnorm", GNORM_RTOL)):
        assert abs(first[k] - twin[k]) <= rtol * abs(twin[k]), (k, first, twin)


@pytest.mark.parametrize("case", KEYS, ids=_ids)
def test_every_gathered_gradient_leaf_matches_jax(results, case):
    _, _, jg, pg, _, _ = results[case]
    assert pg.keys() == jg.keys()
    errs = {}
    for k, g in pg.items():
        assert g.shape == jg[k].shape and torch.isfinite(g).all(), k
        errs[k] = _rel(g.numpy(), jg[k].numpy())
    routers = {k: v for k, v in errs.items() if k.endswith(".moe.router")}
    worst = max(errs, key=errs.get)
    print(case, "routers", routers, "worst gradient leaf", worst, errs[worst])
    assert len(routers) == 3 and max(routers.values()) <= GRAD_RTOL, routers
    assert errs[worst] <= GRAD_RTOL, (worst, errs[worst])


@pytest.mark.parametrize("case", KEYS, ids=_ids)
def test_every_moe_call_routes_as_jax(results, case):
    """The first step's MoE calls: per microbatch, each layer's forward
    against the JAX routing of that layer, then the remat recompute (in
    reverse layer order) bit for bit as the forward."""
    _, _, _, _, jr, pr = results[case]
    m = MICRO[case]
    assert len(jr) == m and len(pr) == 2 * 3 * m, (len(jr), len(pr))
    for i in range(m):
        calls = pr[6 * i:6 * (i + 1)]
        for layer, ((gates, top_i), got) in enumerate(zip(jr[i], calls[:3])):
            _assert_same_choices(got.numpy(), top_i, gates,
                                 f"{case} microbatch {i} layer {layer}")
        for layer, (fwd, again) in enumerate(zip(calls[:3], calls[3:][::-1])):
            assert torch.equal(fwd, again), (case, i, layer)


@pytest.mark.parametrize("case", KEYS, ids=_ids)
def test_grads_and_moments_are_placed_as_their_params(results, case):
    _, p, *_ = results[case]
    assert p["moments"]
    assert p["placed"] and p["local"]
    assert p["leaves"] == len(results[case][3])


@pytest.mark.parametrize("case", KEYS, ids=_ids)
def test_adamw_over_dtensors_is_the_unsharded_update(results, case):
    _, p, *_ = results[case]
    assert len(p["opt"]) == STEPS[case]
    print(case, "AdamW on DTensors against the gathered update, by step", p["opt"],
          "gnorm", p["gnorm_whole"])
    assert max(p["opt"]) <= OPT_RTOL, p["opt"]
    assert max(p["gnorm_whole"]) <= GNORM_RTOL, p["gnorm_whole"]


def test_remat_policies_give_the_same_gradients_under_a_mesh(results):
    _, p, *_ = results[REMAT_ARCH, REMAT_MESH]
    assert sorted(p["remat"]) == ["full", "none"]
    print("remat none and full against dots", p["remat"])
    assert max(p["remat"].values()) <= REMAT_RTOL, p["remat"]
