"""Decode of the MoE archs under a mesh against the JAX package's sharded
decode (smoke configs, CPU, 8 ranks), and rank 0's capture of it.

mixtral-8x7b and dbrx-132b on meshes (2, 4), (4, 2) and (1, 8) over
("data", "model"). The same f32 weights (``Model.init`` through
``bridge.from_jax_params``) and numpy-seeded prompt (B 4 x P 30) go through
a sharded prefill into a cache of 64, then 3 decode steps of forced tokens
(positions 30-32: under ``seq_shard_cache`` the written slot crosses from
one data rank's shard of the length to the next at 32; mixtral's local ring
of 32 wraps to slot 0). A decode step routes its B = 4 tokens in one group a data
rank (2, 4 and 1 groups: one token a group on (4, 2)), as the reference
does. The JAX side is ``make_decode_step`` jitted with ``launch/specs.py``'s
decode in_shardings on 8 fake CPU devices after its own sharded prefill;
the port runs every rank in one process (``simulated_ranks``).

Rules (tests/test_torch_mesh_decode*.py's):
  * under the default rules, every step's logits within 4e-3 absolute of
    the JAX sharded decode (both keep the cache in bf16: two f32 sums in
    another order can round a cached value one bf16 ulp apart);
  * under ``seq_shard_cache``, within 4e-3 of the JAX sharded decode under
    the default rules (the same program but for where the cache lives, and
    the same dispatch groups; the JAX unsharded decode routes the prefill in
    one group). The JAX sharded decode under ``seq_shard_cache`` rounds
    each rank's bf16 P.V partial before its all-reduce (ROADMAP queue 3),
    which puts it up to 4.07% of max |logit| from its own default-rules
    decode here (mixtral-8x7b on (4, 2); 1.7% on (2, 4), dbrx-132b up to
    1.9%): the port is held within that spread plus 4e-3 of it, and the
    spread is printed;
  * with the cache in f32 (``attention.CACHE_DTYPE`` patched), the port's
    sharded decode within 5e-5 of its own unsharded decode with the mesh's
    dispatch groups (``Ctx(moe_groups=...)``), under both rules;
  * rank 0's ``capture_sharded_step`` of the decode step (default rules,
    position 32) on (2, 4) and (1, 8): its ``parsed_flops`` equal the JAX
    per-device ``parsed_flops`` less the gaps ``decode_gap`` sets out, held
    exactly; no kernel node.

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

from repro_torch.configs.registry import get_config  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ("mixtral-8x7b", "dbrx-132b")
MESHES = ((2, 4), (4, 2), (1, 8))
CAPTURED = ((2, 4), (1, 8))
RULES = ("default", "seq_shard_cache")
BF16_ATOL, F32_ATOL = 4e-3, 5e-5
B, P, N, C = 4, 30, 3, 64
IDS = {"ids": lambda m: "x".join(map(str, m))}


def decode_gap(cfg, mesh):
    """The FLOPs by which rank 0's decode step exceeds GSPMD's per-device
    program (measured, and held exactly). On (2, 4), where the 2 kv heads do
    not divide the model axis m, each rank's k and v products take the
    whole kv heads of its batch rows (one token a row), 4 B D KV hd L / dp
    FLOPs, where GSPMD splits them evenly over all ranks
    (tests/test_torch_mesh_capture_decode.py's ``kv_gap``); and each rank
    computes the router product of its groups whole (2 (B/dp) D E FLOPs a
    layer), where GSPMD splits it over the model axis too. On (1, 8), one
    data rank, GSPMD computes both whole on every rank, as the port does:
    no gap."""
    dp, m = mesh
    if dp == 1:
        return 0
    L, D, E = cfg.num_layers, cfg.d_model, cfg.num_experts
    kv = 4 * B * D * cfg.num_kv_heads * cfg.head_dim * L // dp
    router = 2 * (B // dp) * D * E * L
    return (kv - kv // m if cfg.num_kv_heads % m else 0) + router - router // m


PARITY = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    import torch
    from repro.configs.base import ParallelConfig as JParallel, ShapeConfig
    from repro.configs.registry import get_config as jax_config
    from repro.core import capture_step as jax_capture
    from repro.launch.specs import input_specs
    from repro.parallel import sharding as js
    from repro.parallel.mesh import make_mesh as jax_mesh, mesh_context
    from repro.train.serve_step import (make_decode_step as jax_decode,
                                        make_prefill_step as jax_prefill)
    from repro_torch.bridge import from_jax_params
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core import capture_sharded_step, fake_mode
    from repro_torch.models import Ctx, Model, attention
    from repro_torch.parallel import sharding
    from repro_torch.parallel.mesh import fake_process_group, make_mesh, simulated_ranks
    from repro_torch.train.serve_step import make_decode_step, make_prefill_step

    torch.set_num_threads(1)
    arch = sys.argv[1]
    mesh_shape = tuple(int(n) for n in sys.argv[2].split("x"))
    capture = sys.argv[3] == "1"
    B, P, N, C = %d, %d, %d, %d
    jcfg = jax_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, jcfg.vocab_size, (B, P))
    forced = rng.randint(0, jcfg.vocab_size, (B, N))
    shape = ShapeConfig("decode_smoke", "decode", C, B)
    jmesh = jax_mesh(mesh_shape, ("data", "model"))

    def jax_run(rule):
        # the logits of each step, and the f32 params
        par = JParallel(seq_shard_cache=rule == "seq_shard_cache")
        _, (psh, tsh, csh), jm, par, _ = input_specs(jcfg, shape, jmesh, par)
        jp = jax.device_put(jax.tree_util.tree_map(
            lambda x: x.astype(jnp.float32), jm.init(jax.random.PRNGKey(0))), psh)
        pre_sh = js.tree_shardings(jmesh, js.batch_specs(jcfg, ShapeConfig(
            "p", "prefill", P, B), jm), js.activation_rules(par))["tokens"]
        with mesh_context(jmesh):
            prefill = jax.jit(jax_prefill(jm, par, jmesh, C))
            decode = jax.jit(jax_decode(jm, par, jmesh), in_shardings=(psh, tsh, csh))
            _, cache = prefill(jp, jax.device_put(jnp.asarray(tokens, jnp.int32), pre_sh))
            out = []
            for i in range(N):
                lg, cache = decode(jp, jax.device_put(jnp.asarray(forced[:, i:i + 1],
                                                                  jnp.int32), tsh),
                                   jax.device_put(cache, csh))
                out.append(np.asarray(lg))
        return out, jax.tree_util.tree_map(np.asarray, jp)

    def model_of(np_params):
        model = Model(cfg, device="cpu")
        model.load_state_dict(from_jax_params(np_params, cfg, device="cpu"), strict=True,
                              assign=True)
        return model

    def feed(i):
        return torch.from_numpy(forced[:, i:i + 1])

    def port_run(rule, np_params):
        # the logits of each step of the sharded prefill and decode
        model = model_of(np_params)
        with simulated_ranks(8):
            mesh = make_mesh(mesh_shape, ("data", "model"), "cpu")
            p = ParallelConfig(seq_shard_cache=rule == "seq_shard_cache")
            sharding.shard_model(model, mesh, p)
            ins = sharding.shard_inputs({"tokens": torch.from_numpy(tokens)},
                                        sharding.batch_specs(model, "prefill", B, P), mesh, p)
            _, cache = make_prefill_step(model, C, parallel=p, mesh=mesh)(ins["tokens"])
            step = make_decode_step(model, parallel=p, mesh=mesh)
            specs = sharding.batch_specs(model, "decode", B, 1)
            out = []
            for i in range(N):
                tok = sharding.shard_inputs({"token": feed(i)}, specs, mesh, p)["token"]
                lg, cache = step(tok, cache)
                out.append(lg.full_tensor().reconcile().numpy())
        return out

    def port_unsharded(np_params):
        # the port's own unsharded decode, routed in the mesh's groups
        model = model_of(np_params)
        ctx = Ctx(moe_groups=mesh_shape[0])
        _, cache = make_prefill_step(model, C, ctx)(torch.from_numpy(tokens))
        step = make_decode_step(model, ctx)
        out = []
        for i in range(N):
            lg, cache = step(feed(i), cache)
            out.append(lg.numpy())
        return out

    def err(a, b):
        return float(max(np.abs(x - y).max() for x, y in zip(a, b)))

    out = {}
    want = {rule: jax_run(rule) for rule in ("default", "seq_shard_cache")}
    np_params = want["default"][1]
    top = float(max(np.abs(x).max() for x in want["default"][0]))
    got = {rule: port_run(rule, np_params) for rule in want}
    out["max"] = top
    out["shape"] = list(got["default"][0].shape)
    out["finite"] = bool(all(np.isfinite(x).all() for g in got.values() for x in g))
    out["default"] = err(got["default"], want["default"][0])
    out["seq_vs_default"] = err(got["seq_shard_cache"], want["default"][0])
    out["seq_vs_seq"] = err(got["seq_shard_cache"], want["seq_shard_cache"][0])
    out["spread"] = err(want["seq_shard_cache"][0], want["default"][0])
    attention.CACHE_DTYPE = torch.float32
    ref = port_unsharded(np_params)
    out["f32"] = {rule: err(port_run(rule, np_params), ref) for rule in want}
    out["f32_max"] = float(max(np.abs(x).max() for x in ref))
    attention.CACHE_DTYPE = torch.bfloat16

    if capture:
        par = JParallel()
        args, sh, jm, par, _ = input_specs(jcfg, shape, jmesh, par)
        cap = jax_capture(jax_decode(jm, par, jmesh), args, sh, jmesh)
        out["jax_capture"] = {"flops": cap.summary["parsed_flops"],
                              "partitions": cap.meta["num_partitions"],
                              "comm": {k: v["count"] for k, v in cap.summary["comm"].items()}}
        p = ParallelConfig()
        with fake_process_group(8):
            mesh = make_mesh(mesh_shape, ("data", "model"), "cpu")
            with fake_mode():
                model = Model(cfg, device="cpu", abstract=True)
                sharding.shard_model(model, mesh, p)
                token = sharding.shard_inputs(
                    {"token": torch.empty(B, 1, dtype=torch.long)},
                    sharding.batch_specs(model, "decode", B, 1), mesh, p)["token"]
                cache = model.init_cache(B, C, mesh=mesh, parallel=p)
                cache["pos"] = 32
                cap = capture_sharded_step(make_decode_step(model, parallel=p, mesh=mesh),
                                           model, [token, cache])
        s = cap.summary
        out["port_capture"] = {"flops": s["parsed_flops"], "kernel_nodes": s["kernel_nodes"],
                               "world": cap.meta["world_size"],
                               "comm": {k: v["count"] for k, v in s["comm"].items()}}
    print(json.dumps(out))
""") % (B, P, N, C)


def _run(arch, mesh):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, os.environ.get("PYTHONPATH", "")]),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    return subprocess.Popen([sys.executable, "-c", PARITY, arch, "x".join(map(str, mesh)),
                             "1" if mesh in CAPTURED else "0"], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


_results = {}


def result(arch, mesh):
    """PARITY's results of (arch, mesh); the six processes start together at
    the first call and are kept for the module."""
    if not _results:
        procs = {(a, m): _run(a, m) for a in ARCHS for m in MESHES}
        for k, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-4000:]
            _results[k] = json.loads(out.strip().splitlines()[-1])
    return _results[arch, mesh]


@pytest.mark.parametrize("mesh", MESHES, **IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_moe_decode_matches_the_jax_sharded_decode(arch, mesh):
    r = result(arch, mesh)
    assert r["shape"] == [4, 512] and r["finite"], r
    print(arch, mesh, f"max |logit| error over {N} steps", r["default"], "of", r["max"])
    assert r["default"] <= BF16_ATOL, r


@pytest.mark.parametrize("mesh", MESHES, **IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_length_sharded_moe_decode_matches_the_jax_sharded_decode(arch, mesh):
    r = result(arch, mesh)
    print(arch, mesh, "seq_shard_cache: against the JAX default-rules decode",
          r["seq_vs_default"], "; against the JAX seq_shard_cache decode", r["seq_vs_seq"],
          "; that decode's spread", r["spread"], f"({r['spread'] / r['max']:.2%})")
    assert r["seq_vs_default"] <= BF16_ATOL, r
    assert r["seq_vs_seq"] <= r["spread"] + BF16_ATOL, r


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("mesh", MESHES, **IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_moe_decode_matches_the_unsharded_decode_with_an_f32_cache(arch, mesh, rule):
    r = result(arch, mesh)
    print(arch, mesh, rule, "f32 cache: max |logit| error", r["f32"][rule], "of", r["f32_max"])
    assert r["f32"][rule] <= F32_ATOL, r


@pytest.mark.parametrize("mesh", CAPTURED, **IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_rank0_moe_decode_capture_flops_match_the_jax_capture(arch, mesh):
    r = result(arch, mesh)
    j, p = r["jax_capture"], r["port_capture"]
    assert j["partitions"] == p["world"] == 8 and p["kernel_nodes"] == {}, (j, p)
    gap = decode_gap(get_config(arch, smoke=True), mesh)
    print(arch, mesh, "rank 0's decode FLOPs: JAX", j["flops"], "port", p["flops"], "gap",
          gap, "| collectives: JAX", j["comm"], "port", p["comm"])
    assert p["flops"] - j["flops"] == gap
