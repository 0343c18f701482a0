"""The port's train step under a mesh against the JAX package's sharded
train step (smoke configs, CPU).

Held here, for gemma3-4b, qwen3-8b, granite-3-8b and gemma3-12b on meshes
(2, 4) and (4, 2) over ("data", "model") under the default
``ParallelConfig()`` (tp, fsdp, sequence parallel; remat dots), and for
qwen3-8b on (2, 4) under ``model_axis="zero3"`` and under
``microbatches=2`` (B 8): eight ranks simulated in one process
(``parallel.mesh.simulated_ranks``), against the JAX train step jitted with
the same rules' shardings on 8 fake CPU devices, from the same f32 weights
(``Model.init`` through ``bridge.from_jax_params``) and numpy-seeded tokens
and labels with padding, B 4 (8) x S 48, ``OptConfig(warmup_steps=0)``:
  * the first step's loss, 1e-6 relative, and gnorm, 1e-5 relative (f32
    summation order; the port reduces each rank's squares once);
  * every gradient leaf that the step hands AdamW, gathered, against the
    JAX gradient of ``jax.jit(jax.value_and_grad(model.loss))`` under the
    same mesh (the mean over the microbatches for ``microbatches=2``),
    relative to the leaf's max, within the arch's unsharded tolerance
    (tests/test_torch_train_parity.py and tests/test_torch_dense.py):
    2e-5, granite-3-8b 1e-4;
  * each gradient, first moment and second moment is a DTensor placed as
    its param, and each rank holds only its shard (``to_local().shape``);
  * at every step (3 on (2, 4) under the defaults and under zero3, 1 on
    the others), AdamW on the DTensors equals the unsharded
    ``adamw_update`` of the gathered params, gradients and moments, within
    1e-6 of each leaf's max (the clip's norm is summed in another order);
  * remat none, dots and full give the same gradients under a mesh, 1e-6
    relative (gemma3-4b on (2, 4): the recompute replays the gathers).
A whole step is not compared element by element (see
tests/test_torch_train_parity.py: at step 1 AdamW moves each element by
about lr * sign(g)).

Every case runs in a subprocess (the default process group and JAX's fake
devices are global to a process); the JAX and port processes of every arch
start together at the first test and write the gradients to files. This
file holds gemma3-4b and granite-3-8b (with the remat runs);
tests/test_torch_mesh_train_2.py holds qwen3-8b (with its zero3 and
microbatched runs) and gemma3-12b, by the same tests, so that pytest-xdist's
workers take the two halves in parallel.
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
ARCHS = ("gemma3-4b", "qwen3-8b", "granite-3-8b", "gemma3-12b")
GRAD_RTOL = {"gemma3-4b": 2e-5, "qwen3-8b": 2e-5, "granite-3-8b": 1e-4, "gemma3-12b": 2e-5}
LOSS_RTOL, GNORM_RTOL, OPT_RTOL, REMAT_RTOL = 1e-6, 1e-5, 1e-6, 1e-6
REMAT_ARCH, REMAT_MESH = "gemma3-4b", "2x4"

# (key, mesh, ParallelConfig fields, batch, steps) of each run, by process:
# every arch on both meshes under the defaults; qwen3-8b's zero3 and
# microbatched runs in a process pair of their own. Steps after the first
# hold only AdamW (a step of a simulated mesh costs 5-10 s of CPU here)
RUNS = {arch: [["2x4", [2, 4], {}, 4, 3], ["4x2", [4, 2], {}, 4, 1]] for arch in ARCHS}
EXTRA = ("qwen3-8b", [["2x4/zero3", [2, 4], {"model_axis": "zero3"}, 8, 3],
                      ["2x4/mb2", [2, 4], {"microbatches": 2}, 8, 1]])
STEPS = {(arch, r[0]): r[4] for arch, runs in [*RUNS.items(), EXTRA] for r in runs}
# this file's (arch, runs) process pairs
JOBS = [(arch, RUNS[arch]) for arch in ("gemma3-4b", "granite-3-8b")]


def keys_of(jobs):
    return [(arch, r[0]) for arch, runs in jobs for r in runs]


KEYS = keys_of(JOBS)

COMMON = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    import torch
    from repro.configs.registry import get_config as jax_config
    from repro.models import build_model as jax_build
    from repro_torch.bridge import from_jax_params
    from repro_torch.configs.registry import get_config

    torch.set_num_threads(1)
    arch, out_dir, runs = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
    import time
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

    def path(key, side):
        return f"{out_dir}/{arch}-{key.replace('/', '-')}-{side}.pt"
""")

JAX_STEP = COMMON + textwrap.dedent("""
    import types
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs.base import ParallelConfig as JParallel
    from repro.parallel import sharding as js
    from repro.parallel.mesh import make_mesh, mesh_context
    from repro.train.optimizer import OptConfig, init_opt_state
    from repro.train.train_step import TrainState, make_ctx, make_train_step

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
            grads = None
            for i in range(m):          # the JAX step's sum in f32, then / m
                _, g = vg(jp, placed(tokens[i * n:(i + 1) * n], labels[i * n:(i + 1) * n]))
                grads = g if grads is None else jax.tree_util.tree_map(jnp.add, grads, g)
            grads = jax.tree_util.tree_map(lambda g: g / m, grads)
        torch.save(from_jax_params(jax.tree_util.tree_map(np.asarray, grads), cfg,
                                   device="cpu"), path(key, "jax"))
        out[key] = {"loss": float(met["loss"]), "gnorm": float(met["gnorm"]),
                    "lr": float(met["lr"]), "seconds": time.perf_counter() - T0}
    print(json.dumps(out))
""")

PORT_STEP = COMMON + textwrap.dedent("""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.models import Model
    from repro_torch.parallel import sharding
    from repro_torch.parallel.mesh import make_mesh, simulated_ranks
    from repro_torch.train import train_step as ts
    from repro_torch.train.optimizer import OptConfig, OptState

    remat_key = sys.argv[4] if len(sys.argv) > 4 else ""
    adamw = ts.adamw_update

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

    out = {}
    for key, mesh_shape, kw, B, steps in runs:
        tokens, labels = data(B)
        par = ParallelConfig(**kw)
        model = Model(cfg, device="cpu", trainable=True)
        model.load_state_dict(from_jax_params(np_params, cfg, device="cpu"), strict=True,
                              assign=True)
        rec = {"placed": [], "local": [], "opt": [], "grads": None, "gnorm_whole": []}

        @torch.no_grad()
        def spy(cfg_, params, grads, state, ndims=None):
            # what the step hands AdamW, and the update held to the
            # unsharded update of the gathered tensors
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
            with simulated_ranks(8):
                mesh = make_mesh(tuple(mesh_shape), ("data", "model"), "cpu")
                sharding.shard_model(model, mesh, par)
                ins = sharding.shard_inputs(
                    {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)},
                    sharding.batch_specs(model, "train", B, S), mesh, par)
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
                for _ in range(steps):
                    state, met = step(state, ins)
                    metrics.append({"loss": float(met["loss"].full_tensor()),
                                    "gnorm": float(met["gnorm"]), "lr": float(met["lr"])})
                remat = {r: max(rel(g[k], rec["grads"][k]) for k in g) for r, g in remat.items()}
                grads = rec["grads"]
        finally:
            ts.adamw_update = adamw
        torch.save({k: v.reconcile() for k, v in grads.items()}, path(key, "port"))
        out[key] = {"metrics": metrics, "placed": all(rec["placed"]), "local": all(rec["local"]),
                    "leaves": len(rec["placed"]) // steps, "opt": rec["opt"], "moments": moments,
                    "gnorm_whole": rec["gnorm_whole"], "remat": remat,
                    "seconds": time.perf_counter() - T0}
    print(json.dumps(out))
""")


def _run(code, args, devices=None):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, os.environ.get("PYTHONPATH", "")]))
    if devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    return subprocess.Popen([sys.executable, "-c", code, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


_cache = {}


def run_results(tmp_path_factory, jobs):
    """{(arch, key): (JAX result, port result, JAX grads, port grads)}: a JAX
    process and a port process for each (arch, runs) of ``jobs``, started
    together."""
    out_dir = str(tmp_path_factory.mktemp("mesh_train"))
    procs = []
    for arch, runs in jobs:
        args = [arch, out_dir, json.dumps(runs)]
        procs.append(("jax", arch, _run(textwrap.dedent(JAX_STEP), args, devices=8)))
        remat = [REMAT_MESH] if arch == REMAT_ARCH and runs is RUNS[arch] else []
        procs.append(("port", arch, _run(PORT_STEP, args + remat)))
    got = {}
    for side, arch, proc in procs:
        out, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, err[-4000:]
        for key, r in json.loads(out.strip().splitlines()[-1]).items():
            got.setdefault((arch, key), {})[side] = r
    res = {}
    for (arch, key), r in got.items():
        files = [os.path.join(out_dir, f"{arch}-{key.replace('/', '-')}-{side}.pt")
                 for side in ("jax", "port")]
        res[arch, key] = (r["jax"], r["port"], *(torch.load(f) for f in files))
    return res


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_results(tmp_path_factory, JOBS)


def _ids(k):
    return f"{k[0]}-{k[1]}"


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("case", KEYS, ids=_ids)
def test_loss_and_gnorm_match_the_jax_sharded_train_step(results, case):
    j, p, _, _ = results[case]
    first = p["metrics"][0]
    print(case, "seconds", j["seconds"], p["seconds"])
    print(case, "loss", first["loss"], "JAX", j["loss"], "gnorm", first["gnorm"], "JAX",
          j["gnorm"])
    assert abs(first["loss"] - j["loss"]) <= LOSS_RTOL * abs(j["loss"]), (p, j)
    assert abs(first["gnorm"] - j["gnorm"]) <= GNORM_RTOL * abs(j["gnorm"]), (p, j)
    assert first["lr"] == pytest.approx(j["lr"], rel=1e-7)
    assert all(np.isfinite([m["loss"], m["gnorm"]]).all() for m in p["metrics"])


@pytest.mark.parametrize("case", KEYS, ids=_ids)
def test_every_gathered_gradient_leaf_matches_jax(results, case):
    _, _, jg, pg = results[case]
    assert pg.keys() == jg.keys()
    errs = {}
    for k, g in pg.items():
        assert g.shape == jg[k].shape and torch.isfinite(g).all(), k
        errs[k] = _rel(g.numpy(), jg[k].numpy())
    worst = max(errs, key=errs.get)
    print(case, "worst gradient leaf", worst, errs[worst])
    assert errs[worst] <= GRAD_RTOL[case[0]], (worst, errs[worst])


@pytest.mark.parametrize("case", KEYS, ids=_ids)
def test_grads_and_moments_are_placed_as_their_params(results, case):
    _, p, _, _ = results[case]
    assert p["moments"]
    assert p["placed"] and p["local"]
    assert p["leaves"] == len(results[case][3])


@pytest.mark.parametrize("case", KEYS, ids=_ids)
def test_adamw_over_dtensors_is_the_unsharded_update(results, case):
    _, p, _, _ = results[case]
    assert len(p["opt"]) == STEPS[case]
    print(case, "AdamW on DTensors against the gathered update, by step", p["opt"],
          "gnorm", p["gnorm_whole"])
    assert max(p["opt"]) <= OPT_RTOL, p["opt"]
    assert max(p["gnorm_whole"]) <= GNORM_RTOL, p["gnorm_whole"]


def test_remat_policies_give_the_same_gradients_under_a_mesh(results):
    _, p, _, _ = results[REMAT_ARCH, REMAT_MESH]
    assert sorted(p["remat"]) == ["full", "none"]
    print("remat none and full against dots", p["remat"])
    assert max(p["remat"].values()) <= REMAT_RTOL, p["remat"]
