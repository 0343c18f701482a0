"""Decode under a mesh against the JAX package's sharded decode step (smoke
configs, CPU, 8 ranks), under the default rules (tp, fsdp, sequence
parallel): the cache split by batch over the data axis, its kv heads over
the model axis where they divide it. tests/test_torch_mesh_decode_seq.py
runs the same under ``seq_shard_cache`` and
tests/test_torch_mesh_decode_f32.py holds the port's sharded decode to its
unsharded decode with an f32 cache.

gemma3-4b, qwen3-8b, granite-3-8b and gemma3-12b, each on meshes (2, 4) and
(4, 2) over ("data", "model"). The same f32 weights (``Model.init`` through
``bridge.from_jax_params``) and numpy-seeded prompt (B 4 x P 30) go through a
sharded prefill into a cache of 64, then 6 decode steps of forced tokens
(positions 30-35): the global cache's written slot crosses from one data
rank's shard of the length to the next at 32 under ``seq_shard_cache`` on
both meshes (shards of 32 and 16), and gemma's local ring of 32 wraps from
slot 31 to slot 0, across its shards (16 and 8). The JAX side is
``make_decode_step`` jitted with ``launch/specs.py``'s decode in_shardings on
8 fake CPU devices after its own sharded prefill, and its unsharded decode.
The port runs every rank in one process (``simulated_ranks``).

Rules:
  * every step's logits (B, V) against the JAX sharded decode: 4e-3
    absolute. Both packages keep the cache in bf16, so two programs whose
    f32 sums run in another order can round a cache value one bf16 ulp
    apart (tests/test_torch_model.py's reason for its 2e-3). At these inputs
    that reaches 3.21e-3 between the JAX sharded decode on (4, 2) and the
    JAX unsharded decode (gemma3-4b, step 1): the rule is held to that
    spread of the reference's own programs too;
  * each layer's k and v cache after the last step, gathered, against the
    JAX sharded cache within one bf16 ulp of its max |k|;
  * layer 0's placements against the JAX cache spec (layers dropped where
    stacked).

Everything runs in subprocesses, one an arch, the two archs of a half
(``PARTS``) at once: a process group, LocalTensorMode and JAX's fake
devices are global to a process. This file holds gemma3-4b and qwen3-8b;
tests/test_torch_mesh_decode_2.py holds granite-3-8b and gemma3-12b by the
same tests, so that pytest-xdist's workers take the two halves in parallel.
"""
import json
import math
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import get_config  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ("gemma3-4b", "qwen3-8b", "granite-3-8b", "gemma3-12b")
# the halves of ARCHS whose processes run together, each in a file of its own
PARTS = (ARCHS[:2], ARCHS[2:])
MESHES = ((2, 4), (4, 2))
BF16_ATOL = 4e-3            # a bf16 cache value one ulp apart (module docstring)

PARITY = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    import torch
    from repro.configs.base import ParallelConfig as JParallel, ShapeConfig
    from repro.configs.registry import get_config as jax_config
    from repro.launch.specs import input_specs
    from repro.parallel import sharding as js
    from repro.parallel.mesh import make_mesh as jax_mesh, mesh_context
    from repro.train.serve_step import (make_decode_step as jax_decode,
                                        make_prefill_step as jax_prefill)
    from repro_torch.bridge import from_jax_cache, from_jax_params
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.models import Model
    from repro_torch.parallel import sharding
    from repro_torch.parallel.mesh import make_mesh, simulated_ranks
    from repro_torch.train.serve_step import make_decode_step, make_prefill_step

    torch.set_num_threads(1)
    arch, rule = sys.argv[1], sys.argv[2]
    seq_shard = rule == "seq_shard_cache"
    B, P, N, C = 4, 30, 6, 64
    jcfg = jax_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, jcfg.vocab_size, (B, P))
    forced = rng.randint(0, jcfg.vocab_size, (B, N))
    shape = ShapeConfig("decode_smoke", "decode", C, B)

    def jax_run(mesh_shape):
        # (logits of each step, the cache after the last, layer 0's k spec, the params)
        par = JParallel(seq_shard_cache=seq_shard)
        if mesh_shape is None:
            from repro.models import build_model
            jm = build_model(jcfg)
            jp = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32),
                                        jm.init(jax.random.PRNGKey(0)))
            prefill = jax.jit(jax_prefill(jm, par, None, C))
            decode = jax.jit(jax_decode(jm, par, None))
            _, cache = prefill(jp, jnp.asarray(tokens, jnp.int32))
            out = []
            for i in range(N):
                lg, cache = decode(jp, jnp.asarray(forced[:, i:i + 1], jnp.int32), cache)
                out.append(np.asarray(lg))
            return out, jax.tree_util.tree_map(np.asarray, cache), None, jp
        jmesh = jax_mesh(mesh_shape, ("data", "model"))
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
        # layer 0's k cache: its spec, without the stacked layers axis
        blocks = csh["blocks"]
        spec = (tuple(blocks["sb"]["slot0"]["attn"]["k"].spec)[1:] if "sb" in blocks
                else tuple(blocks["rem0"]["attn"]["k"].spec))
        return out, jax.tree_util.tree_map(np.asarray, cache), trimmed(spec), jp

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

    def port_run(mesh_shape, np_params):
        # (logits of each step, each layer's gathered k/v, layer 0's k spec)
        model = Model(cfg, device="cpu")
        model.load_state_dict(from_jax_params(np_params, cfg, device="cpu"), strict=True,
                              assign=True)
        with simulated_ranks(8):
            mesh = make_mesh(mesh_shape, ("data", "model"), "cpu")
            p = ParallelConfig(seq_shard_cache=seq_shard)
            sharding.shard_model(model, mesh, p)
            ins = sharding.shard_inputs({"tokens": torch.from_numpy(tokens)},
                                        sharding.batch_specs(model, "prefill", B, P), mesh, p)
            _, cache = make_prefill_step(model, C, parallel=p, mesh=mesh)(ins["tokens"])
            step = make_decode_step(model, parallel=p, mesh=mesh)
            out = []
            for i in range(N):
                tok = sharding.shard_inputs({"token": torch.from_numpy(forced[:, i:i + 1])},
                                            sharding.batch_specs(model, "decode", B, 1),
                                            mesh, p)["token"]
                lg, cache = step(tok, cache)
                out.append(lg.full_tensor().reconcile().numpy())
            kv = [{n: t.full_tensor().reconcile().float().numpy() for n, t in c["attn"].items()}
                  for c in cache["layers"]]
            placed = port_spec(cache["layers"][0]["attn"]["k"])
        return out, kv, placed

    def err(a, b):
        return float(max(np.abs(x - y).max() for x, y in zip(a, b)))

    def cache_errs(kv, jcache):
        # per layer and name: (max |port - JAX|, max |JAX|)
        jl = from_jax_cache(jcache, cfg, device="cpu")["layers"]
        return [[float(np.abs(kv[i][n] - jl[i]["attn"][n].float().numpy()).max()),
                 float(np.abs(jl[i]["attn"][n].float().numpy()).max())]
                for i in range(len(kv)) for n in ("k", "v")]

    out = {}
    ref, ref_cache, _, _ = jax_run(None)
    for mesh_shape in ((2, 4), (4, 2)):
        want, want_cache, spec, jp = jax_run(mesh_shape)
        got, kv, placed = port_run(mesh_shape, jax.tree_util.tree_map(np.asarray, jp))
        out["x".join(map(str, mesh_shape))] = {
            "sharded": err(got, want), "unsharded": err(got, ref), "spread": err(want, ref),
            "max": float(max(np.abs(x).max() for x in want)), "shape": list(got[0].shape),
            "finite": bool(all(np.isfinite(x).all() for x in got)),
            "placed": placed, "jax_spec": spec,
            "cache": cache_errs(kv, ref_cache if seq_shard else want_cache)}
    print(json.dumps(out))
""")


def _run(code, *args, devices=None):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, os.environ.get("PYTHONPATH", "")]))
    if devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    return subprocess.Popen([sys.executable, "-c", code, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def run_all(rule, archs=ARCHS):
    """{arch: {mesh key: results}} of PARITY under ``rule``, the processes
    of ``archs`` started together."""
    procs = {a: _run(PARITY, a, rule, devices=8) for a in archs}
    out = {}
    for a, proc in procs.items():
        stdout, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, err[-4000:]
        out[a] = json.loads(stdout.strip().splitlines()[-1])
    return out


def within_one_bf16_ulp(cache):
    """[(error, max |x|)] of each layer's k and v: each error at most one
    bf16 ulp of that max."""
    return all(e <= 2.0 ** (math.floor(math.log2(top)) - 7) for e, top in cache)


def part_of(arch):
    return next(p for p in PARTS if arch in p)


_results = {}


def result(arch, mesh):
    """PARITY's results of ``arch`` under the default rules; the processes
    of its half start together at its first call."""
    if arch not in _results:
        _results.update(run_all("default", part_of(arch)))
    return _results[arch]["x".join(map(str, mesh))]


IDS = {"ids": lambda m: "x".join(map(str, m))}


@pytest.mark.parametrize("mesh", MESHES, **IDS)
@pytest.mark.parametrize("arch", PARTS[0])
def test_sharded_decode_logits_match_the_jax_sharded_decode(arch, mesh):
    r = result(arch, mesh)
    assert r["shape"] == [4, 512] and r["finite"], r
    print(arch, mesh, "max |logit| error over 6 steps", r["sharded"], "of", r["max"],
          "; the JAX sharded decode against its unsharded decode", r["spread"])
    assert r["sharded"] <= BF16_ATOL, r
    assert r["spread"] <= BF16_ATOL, r


@pytest.mark.parametrize("mesh", MESHES, **IDS)
@pytest.mark.parametrize("arch", PARTS[0])
def test_each_layer_cache_matches_the_jax_sharded_cache_within_one_bf16_ulp(arch, mesh):
    r = result(arch, mesh)
    print(arch, mesh, "k/v errors and max of each layer", r["cache"])
    assert len(r["cache"]) == 2 * get_config(arch, smoke=True).num_layers
    assert within_one_bf16_ulp(r["cache"]), r["cache"]


@pytest.mark.parametrize("mesh", MESHES, **IDS)
@pytest.mark.parametrize("arch", PARTS[0])
def test_cache_is_placed_by_batch_and_kv_heads_as_the_jax_spec(arch, mesh):
    """Batch over data; the 2 kv heads over the model axis on (4, 2), whole
    on (2, 4), where they do not divide it."""
    r = result(arch, mesh)
    want = ["data", None, "model"] if mesh == (4, 2) else ["data"]
    assert r["placed"] == r["jax_spec"] == want, r
