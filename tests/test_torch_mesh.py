"""The port's serving path under a mesh against the JAX package's sharded
step (smoke configs, CPU), and the mesh's process-global state.

Held here:
  * the sharded forward logits and eval loss of gemma3-4b, qwen3-8b,
    granite-3-8b and gemma3-12b on meshes (2, 4) and (4, 2) over
    ("data", "model"), eight ranks simulated in one process
    (``parallel.mesh.simulated_ranks``, LocalTensorMode), against the JAX
    package's forward and eval steps jitted with the same rules' shardings on
    8 fake CPU devices, from the same f32 weights (``Model.init`` through
    ``bridge.from_jax_params``) and numpy-seeded tokens and labels. On (2, 4)
    the smoke archs' 4 q heads split over the 4-wide model axis and their 2
    kv heads stay whole on every rank (the GQA trap); on (4, 2) both split.
    Tolerances are tests/test_torch_dense.py's: logits 5e-5 absolute (f32
    summation order; the JAX step runs its own "xla" attention, which
    tests/test_torch_dense.py holds the port's K1 to at 5e-5 too), loss
    1e-6 relative;
  * K1 on local heads (``attention._local_attention``) against K1 on the
    whole tensors for GQA shapes where the kv heads split with the q heads,
    where they cannot and each rank's q heads share one kv head, and where
    they share it in part (gcd of G and the local heads);
  * ``make_production_mesh``: (16, 16) and (2, 16, 16) under fake process
    groups of 256 and 512 ranks, and its refusal at other world sizes;
  * ``fake_process_group`` leaves no default group behind;
  * the archs outside the slice raise NotImplementedError naming their
    ROADMAP item under a mesh, for every step maker, the train and decode
    steps' among them, and recurrentgemma-9b for the train step alone (it
    serves under a mesh: tests/test_torch_mesh_rglru*.py); the train and
    decode steps build for the dense and MoE archs
    (tests/test_torch_mesh_train.py and tests/test_torch_mesh_decode*.py
    hold what they compute); without a mesh every Ctx has no hook.

Everything that stands up a process group, LocalTensorMode or JAX's fake
devices runs in a subprocess: the default process group is global to a
process, and one left standing would change what later tests in the same
worker see.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.configs.registry import ARCH_NAMES, get_config  # noqa: E402
from repro_torch.models import Ctx, Model  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.train import serve_step, train_step  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ("gemma3-4b", "qwen3-8b", "granite-3-8b", "gemma3-12b")
MESHES = ((2, 4), (4, 2))
F32_ATOL, LOSS_RTOL = 5e-5, 1e-6


def _run(code, *args, devices=None):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, os.environ.get("PYTHONPATH", "")]))
    if devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    return subprocess.Popen([sys.executable, "-c", code, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def _result(proc, timeout=600):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# sharded forward and eval against the JAX sharded step
# ---------------------------------------------------------------------------

PARITY = textwrap.dedent("""
    import json, sys, types
    import numpy as np
    import jax, jax.numpy as jnp
    import torch
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
    from repro_torch.models import Model
    from repro_torch.models import attention
    from repro_torch.parallel import sharding
    from repro_torch.parallel.mesh import make_mesh, simulated_ranks
    from repro_torch.train.serve_step import make_forward_step
    from repro_torch.train.train_step import make_eval_step

    torch.set_num_threads(2)
    arch, B, S = sys.argv[1], 4, 48
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

    def recorded(fn, seen):
        def rec(attend, q, k, v, kv_heads):
            seen.append([str(q.placements), str(k.placements)])
            return fn(attend, q, k, v, kv_heads)
        return rec

    out = {}
    for mesh_shape in ((2, 4), (4, 2)):
        key = "x".join(map(str, mesh_shape))
        par = JParallel()
        jmesh = jax_mesh(mesh_shape, ("data", "model"))
        psh = js.tree_shardings(jmesh, jm.param_specs(), js.param_rules(par))
        bsh = js.tree_shardings(jmesh, js.batch_specs(jcfg, shape, jm),
                                js.activation_rules(par))
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
        seen, local_attention = [], attention._local_attention
        attention._local_attention = recorded(local_attention, seen)
        try:
            with simulated_ranks(8):
                mesh = make_mesh(mesh_shape, ("data", "model"), "cpu")
                p = ParallelConfig()
                sharding.shard_model(model, mesh, p)
                ins = sharding.shard_inputs(
                    {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)},
                    sharding.batch_specs(model, "train", B, S), mesh, p)
                got = make_forward_step(model, parallel=p, mesh=mesh)(ins["tokens"])
                got_placements = str(got.placements)
                got = got.full_tensor().numpy()
                got_loss = float(make_eval_step(model, p, mesh)(ins)["loss"].full_tensor())
        finally:
            attention._local_attention = local_attention
        out[key] = {"err": float(np.abs(got - want).max()), "max": float(np.abs(want).max()),
                    "shape": list(got.shape), "want_shape": list(want.shape),
                    "finite": bool(np.isfinite(got).all()), "placements": got_placements,
                    "loss": got_loss, "want_loss": want_loss, "attention": seen,
                    "layers": cfg.num_layers}
    print(json.dumps(out))
""")

_parity = {}


def parity(arch):
    """The subprocess's results for every arch, started together at the
    first call (four processes at once) and kept for the module."""
    if not _parity:
        procs = {a: _run(PARITY, a, devices=8) for a in ARCHS}
        for a, proc in procs.items():
            _parity[a] = _result(proc)
    return _parity[arch]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_forward_logits_match_the_jax_sharded_step(arch, mesh):
    r = parity(arch)["x".join(map(str, mesh))]
    assert r["shape"] == r["want_shape"] == [4, 512] and r["finite"]
    assert r["err"] <= F32_ATOL, r
    print(arch, mesh, "max |logit| error", r["err"], "of", r["max"])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_eval_loss_matches_the_jax_sharded_step(arch, mesh):
    r = parity(arch)["x".join(map(str, mesh))]
    assert abs(r["loss"] - r["want_loss"]) <= LOSS_RTOL * abs(r["want_loss"]), r
    print(arch, mesh, "loss", r["loss"], "JAX", r["want_loss"])


@pytest.mark.parametrize("arch", ARCHS)
def test_q_heads_split_over_whole_kv_heads_on_the_wide_model_axis(arch):
    """On (2, 4) each of the 4 q heads has a rank of its own and the 2 kv
    heads are whole on every rank (Replicate over model); on (4, 2) both
    split over the model axis. Every attention layer of the forward and of
    the eval step went through the local path."""
    wide, narrow = parity(arch)["2x4"], parity(arch)["4x2"]
    for r in (wide, narrow):
        assert len(r["attention"]) == 2 * r["layers"]
    q, k = wide["attention"][0]
    assert q == "(Shard(dim=0), Shard(dim=2))" and k == "(Shard(dim=0), Replicate())", (q, k)
    q, k = narrow["attention"][0]
    assert q == k == "(Shard(dim=0), Shard(dim=2))", (q, k)


# ---------------------------------------------------------------------------
# K1 on local heads: the GQA head mapping
# ---------------------------------------------------------------------------

GQA = textwrap.dedent("""
    import json, math
    import torch
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.kernels import ops
    from repro_torch.models import attention
    from repro_torch.parallel import sharding
    from repro_torch.parallel.mesh import make_mesh, simulated_ranks

    torch.manual_seed(0)
    out = []
    # (mesh, H, KV): kv split with q; kv whole, one kv head a rank; kv whole,
    # gcd(G, H/m) q heads a kv head; q and kv unsplit; batch over data too
    for mesh_shape, H, KV in (((1, 4), 8, 4), ((1, 4), 8, 2), ((1, 6), 12, 3),
                              ((1, 4), 12, 2), ((2, 2), 4, 2), ((2, 4), 4, 2),
                              ((2, 4), 8, 1), ((1, 3), 4, 2)):
        B, S, hd = 2, 24, 8
        q, k, v = (torch.randn(B, S, n, hd) for n in (H, KV, KV))

        def attend(qg, k, v):
            return ops.flash_attention(qg, k, v, causal=True, window=0,
                                       scale=1 / math.sqrt(hd))

        want = attention._ungroup(attend(attention._group(q, KV), k, v))
        world = math.prod(mesh_shape)
        with simulated_ranks(world):
            mesh = make_mesh(mesh_shape, ("data", "model"), "cpu")
            heads = "heads" if H % mesh_shape[1] == 0 else None
            kv_heads = "kv_heads" if KV % mesh_shape[1] == 0 else None
            rules = sharding.activation_rules(sharding.ParallelConfig())
            qd, kd, vd = (sharding.distribute(t, mesh, sharding.resolve_placements(
                              ("batch", None, ax, None), t.shape, rules, mesh))
                          for t, ax in ((q, heads), (k, kv_heads), (v, kv_heads)))
            o = attention._local_attention(attend, qd, kd, vd, KV)
            placed = o.placements == qd.placements
            got = o.full_tensor()
        out.append({"case": [list(mesh_shape), H, KV], "err": float((got - want).abs().max()),
                    "placed": placed, "q": str(qd.placements), "k": str(kd.placements)})
    print(json.dumps(out))
""")


def test_local_attention_maps_each_local_q_head_to_its_own_kv_head():
    for r in _result(_run(GQA)):
        assert r["placed"], r
        assert r["err"] <= 1e-6, r


# ---------------------------------------------------------------------------
# meshes and process groups
# ---------------------------------------------------------------------------

MESH = textwrap.dedent("""
    import json
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.parallel import mesh as pm

    out = {}
    for world, multi in ((256, False), (512, True)):
        with pm.fake_process_group(world):
            m = make_production_mesh(multi_pod=multi, device_type="cpu")
            out[str(world)] = {"shape": list(m.shape), "names": list(m.mesh_dim_names),
                               "dp": pm.dp_size(m), "model": pm.model_size(m),
                               "coord": pm.coordinate(m, world - 1)}
            try:
                make_production_mesh(multi_pod=not multi, device_type="cpu")
                out[str(world)]["other"] = "made"
            except RuntimeError as e:
                out[str(world)]["other"] = str(e)
        out[str(world)]["after"] = dist.is_initialized()
    with pm.fake_process_group(8):
        try:
            make_production_mesh(device_type="cpu")
        except RuntimeError as e:
            out["8"] = str(e)
        try:
            with pm.fake_process_group(8):
                pass
        except RuntimeError as e:
            out["nested"] = str(e)
        try:
            pm.make_mesh((4, 4), ("data", "model"), "cpu")
        except ValueError as e:
            out["16 of 8"] = str(e)
    try:
        make_production_mesh(device_type="cpu")
    except RuntimeError as e:
        out["none"] = str(e)
    out["after"] = dist.is_initialized()
    print(json.dumps(out))
""")


def test_production_meshes_and_fake_process_groups():
    r = _result(_run(MESH))
    assert r["256"]["shape"] == [16, 16] and r["256"]["names"] == ["data", "model"]
    assert (r["256"]["dp"], r["256"]["model"], r["256"]["coord"]) == (16, 16, [15, 15])
    assert r["512"]["shape"] == [2, 16, 16] and r["512"]["names"] == ["pod", "data", "model"]
    assert (r["512"]["dp"], r["512"]["model"], r["512"]["coord"]) == (32, 16, [1, 15, 15])
    assert "512 ranks" in r["256"]["other"] and "it has 256" in r["256"]["other"]
    assert "256 ranks" in r["512"]["other"] and "it has 512" in r["512"]["other"]
    assert "it has 8" in r["8"] and "there is none" in r["none"]
    assert "exists already" in r["nested"] and "needs 16 ranks" in r["16 of 8"]
    assert not r["256"]["after"] and not r["512"]["after"] and not r["after"]


def test_axis_sizes_take_a_mapping_or_none():
    from repro_torch.parallel import mesh as pm
    shape = {"pod": 2, "data": 16, "model": 16}
    assert (pm.dp_size(shape), pm.model_size(shape), pm.axis_size(shape, "x")) == (32, 16, 1)
    assert (pm.dp_size(None), pm.model_size(None)) == (1, 1)
    assert (pm.DATA_AXIS, pm.MODEL_AXIS, pm.POD_AXIS) == ("data", "model", "pod")


# ---------------------------------------------------------------------------
# what waits for later slices, and the path without a mesh
# ---------------------------------------------------------------------------

# a mesh stand-in: the axis sizes a step maker reads (the MoE dispatch
# groups of its Ctx); every refusal below comes before the mesh is used
MESH_STANDIN = {"data": 2, "model": 4}
WAITING = {"mamba2-780m": "SSD", "llama-3.2-vision-90b": "cross",
           "seamless-m4t-medium": "encoder"}
# serve under a mesh, but their train step waits
TRAIN_WAITING = {"recurrentgemma-9b": "RG-LRU"}
# the MoE archs serve and train under a mesh
MOE_ARCHS = ("mixtral-8x7b", "dbrx-132b")


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_archs_outside_the_slice_raise_under_a_mesh(arch):
    cfg = get_config(arch, smoke=True)
    model = Model(cfg, device="cpu")
    makers = (lambda: serve_step.make_forward_step(model, mesh=MESH_STANDIN),
              lambda: serve_step.make_prefill_step(model, 8, mesh=MESH_STANDIN),
              lambda: serve_step.make_decode_step(model, mesh=MESH_STANDIN),
              lambda: train_step.make_eval_step(model, ParallelConfig(), MESH_STANDIN),
              lambda: train_step.make_train_step(model, OptConfig(), ParallelConfig(),
                                                 MESH_STANDIN))
    for i, make in enumerate(makers):
        if arch in WAITING or (arch in TRAIN_WAITING and i == len(makers) - 1):
            with pytest.raises(NotImplementedError, match=r"ROADMAP queue 1, item 5\.3"):
                make()
        else:
            assert callable(make())
    if arch in WAITING:
        for train in (False, True):
            with pytest.raises(NotImplementedError, match=WAITING[arch]):
                sharding.check_mesh_support(cfg, train)
    elif arch in TRAIN_WAITING:
        sharding.check_mesh_support(cfg)
        with pytest.raises(NotImplementedError, match=TRAIN_WAITING[arch] + " .*train step"):
            sharding.check_mesh_support(cfg, train=True)
    else:
        sharding.check_mesh_support(cfg, train=True)
        assert (arch in MOE_ARCHS) == bool(cfg.num_experts)


def test_decode_and_train_steps_raise_under_a_mesh():
    """The decode and train steps build under a mesh for a dense and an MoE
    arch; the decode step builds for the RG-LRU arch and its train step
    raises; the decode step raises for an SSD arch, naming the item that
    waits."""
    model = Model(get_config("qwen3-8b", smoke=True), device="cpu", trainable=True)
    assert callable(serve_step.make_decode_step(model, mesh=MESH_STANDIN))
    assert callable(serve_step.make_decode_step(model, parallel=ParallelConfig(
        seq_shard_cache=True), mesh=MESH_STANDIN))
    assert callable(train_step.make_train_step(model, OptConfig(), ParallelConfig(),
                                               MESH_STANDIN))
    ssm = Model(get_config("mamba2-780m", smoke=True), device="cpu", trainable=True)
    with pytest.raises(NotImplementedError, match=r"SSD .*item 5\.3"):
        serve_step.make_decode_step(ssm, mesh=MESH_STANDIN)
    rg = Model(get_config("recurrentgemma-9b", smoke=True), device="cpu", trainable=True)
    assert callable(serve_step.make_decode_step(rg, mesh=MESH_STANDIN))
    assert callable(serve_step.make_decode_step(rg, parallel=ParallelConfig(
        seq_shard_cache=True), mesh=MESH_STANDIN))
    with pytest.raises(NotImplementedError, match=r"RG-LRU .*item 5\.3"):
        train_step.make_train_step(rg, OptConfig(), ParallelConfig(), MESH_STANDIN)
    moe = Model(get_config("mixtral-8x7b", smoke=True), device="cpu", trainable=True)
    assert callable(serve_step.make_decode_step(moe, mesh=MESH_STANDIN))
    assert callable(train_step.make_train_step(moe, OptConfig(), ParallelConfig(),
                                               MESH_STANDIN))
    with pytest.raises(ValueError, match="pass parallel, not ctx"):
        serve_step.make_forward_step(model, Ctx(), mesh=MESH_STANDIN)
    with pytest.raises(ValueError, match="pass parallel, not ctx"):
        serve_step.make_decode_step(model, Ctx(), mesh=MESH_STANDIN)


def test_without_a_mesh_there_is_no_hook():
    assert Ctx().shard_fn is None and Ctx().shard(3, "batch") == 3
    assert train_step.make_ctx(ParallelConfig()).shard_fn is None
    assert Ctx().moe_groups == train_step.make_ctx(ParallelConfig()).moe_groups == 1
    assert sharding.make_shard_fn(None, ParallelConfig()) is None


def test_moe_dispatch_groups_follow_the_data_parallel_degree():
    """A step's MoE dispatch groups, as the JAX make_ctx sets them: the
    data-parallel degree (pod x data), times the model axis under zero3; 1
    without a mesh. The serving steps' Ctx takes the same."""
    mesh3 = {"pod": 2, "data": 16, "model": 16}
    assert train_step.moe_groups(ParallelConfig(), MESH_STANDIN) == 2
    assert train_step.moe_groups(ParallelConfig(model_axis="zero3"), MESH_STANDIN) == 8
    assert train_step.moe_groups(ParallelConfig(), mesh3) == 32
    assert train_step.moe_groups(ParallelConfig(), None) == 1
    assert train_step.make_ctx(ParallelConfig(), MESH_STANDIN).moe_groups == 2
    assert serve_step._ctx(None, None, MESH_STANDIN).moe_groups == 2
    assert serve_step._ctx(None, None, None).moe_groups == 1
