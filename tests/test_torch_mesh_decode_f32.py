"""The port's decode under a mesh against its own unsharded decode, with the
cache in f32 (``attention.CACHE_DTYPE`` patched in the subprocess), so that
only the f32 summation order separates them (smoke configs, CPU, 8 ranks).

gemma3-4b, qwen3-8b, granite-3-8b and gemma3-12b with f32 weights (the
port's seeded init), on meshes (2, 4) and (4, 2) over ("data", "model"),
under the default rules and under ``seq_shard_cache``:
  * from the sharded prefill's cache: prompt B 4 x P 30, cache 64, 6
    numpy-seeded forced tokens (the same crossings as
    tests/test_torch_mesh_decode.py), every step's logits within 5e-5
    absolute of the unsharded decode's (the f32 rule of the sharded prefill,
    tests/test_torch_mesh.py; the reference's sharded decode sits ~2e-6 from
    its unsharded one with an f32 cache);
  * from ``Model.init_cache(..., mesh=...)``, each rank making only its
    shard: 2 steps from position 0, the same rule, the cache placed as the
    prefill's is after the first step;
  * from the unsharded prefill's whole cache placed by
    ``sharding.shard_cache``: the first step, the same rule;
  * under the default rules on (2, 4), ``generate`` under the mesh gives the
    unsharded greedy tokens.

One subprocess an arch and a rule, the four of a half of the archs
(``PARTS``) at once: a process group and LocalTensorMode are global to a
process. This file holds gemma3-4b and qwen3-8b;
tests/test_torch_mesh_decode_f32_2.py holds granite-3-8b and gemma3-12b by
the same tests, so that pytest-xdist's workers take the two halves in
parallel.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ("gemma3-4b", "qwen3-8b", "granite-3-8b", "gemma3-12b")
PARTS = (ARCHS[:2], ARCHS[2:])         # the halves whose processes run together
MESHES = ((2, 4), (4, 2))
RULES = ("default", "seq_shard_cache")
F32_ATOL = 5e-5

F32 = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.models import Model, attention
    from repro_torch.parallel import sharding
    from repro_torch.parallel.mesh import make_mesh, simulated_ranks
    from repro_torch.train.serve_step import generate, make_decode_step, make_prefill_step

    torch.set_num_threads(1)
    attention.CACHE_DTYPE = torch.float32
    arch, rule = sys.argv[1], sys.argv[2]
    par = ParallelConfig(seq_shard_cache=rule == "seq_shard_cache")
    B, P, N, C, N0 = 4, 30, 6, 64, 2
    cfg = get_config(arch, smoke=True)
    rng = np.random.RandomState(1)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, P)))
    forced = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, N)))
    model = Model(cfg, device="cpu", seed=0).float()
    weights = {k: v.clone() for k, v in model.state_dict().items()}

    def decode(step, cache, n):
        out = []
        for i in range(n):
            lg, cache = step(forced[:, i:i + 1], cache)
            out.append(lg.full_tensor().reconcile() if hasattr(lg, "full_tensor") else lg)
        return out, cache

    step = make_decode_step(model)
    whole = make_prefill_step(model, C)(tokens)[1]       # shard_cache copies it
    want, _ = decode(step, make_prefill_step(model, C)(tokens)[1], N)
    want0, _ = decode(step, model.init_cache(B, C), N0)
    want_gen = generate(model, tokens, 3)

    def err(a, b):
        return float(max((x - y).abs().max() for x, y in zip(a, b)))

    out = {}
    for mesh_shape in ((2, 4), (4, 2)):
        m = Model(cfg, device="cpu").float()
        m.load_state_dict(weights)
        with simulated_ranks(8):
            mesh = make_mesh(mesh_shape, ("data", "model"), "cpu")
            sharding.shard_model(m, mesh, par)
            ins = sharding.shard_inputs({"tokens": tokens},
                                        sharding.batch_specs(m, "prefill", B, P), mesh, par)
            step = make_decode_step(m, parallel=par, mesh=mesh)
            _, cache = make_prefill_step(m, C, parallel=par, mesh=mesh)(ins["tokens"])
            got, cache = decode(step, cache, N)
            placed = str(cache["layers"][0]["attn"]["k"].placements)
            empty = m.init_cache(B, C, mesh=mesh, parallel=par)
            empty_placed = str(empty["layers"][0]["attn"]["k"].placements)
            got0, empty = decode(step, empty, N0)
            placed_whole = sharding.shard_cache(m, whole, mesh, par)
            got1, _ = decode(step, placed_whole, 1)
            r = {"prefill": err(got, want), "init": err(got0, want0),
                 "shard_cache": err(got1, want[:1]), "placed": placed,
                 "init_placed": empty_placed,
                 "after_step": str(empty["layers"][0]["attn"]["k"].placements),
                 "max": float(max(x.abs().max() for x in want)), "pos": empty["pos"]}
            if rule == "default" and mesh_shape == (2, 4):
                gen = generate(m, ins["tokens"], 3, parallel=par, mesh=mesh)
                r["generate"] = [gen.reconcile().tolist(), want_gen.tolist()]
        out["x".join(map(str, mesh_shape))] = r
    print(json.dumps(out))
""")


def _run(arch, rule):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, os.environ.get("PYTHONPATH", "")]))
    return subprocess.Popen([sys.executable, "-c", F32, arch, rule], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


_results = {}


def result(arch, rule, mesh):
    """The results of ``arch`` under ``rule`` on ``mesh``; the processes of
    its half of the archs start together at its first call."""
    if (arch, rule) not in _results:
        part = next(p for p in PARTS if arch in p)
        procs = {(a, r): _run(a, r) for a in part for r in RULES}
        for key, proc in procs.items():
            out, err = proc.communicate(timeout=900)
            assert proc.returncode == 0, err[-4000:]
            _results[key] = json.loads(out.strip().splitlines()[-1])
    return _results[arch, rule]["x".join(map(str, mesh))]


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("arch", PARTS[0])
def test_sharded_decode_matches_the_unsharded_decode_with_an_f32_cache(arch, mesh, rule):
    r = result(arch, rule, mesh)
    print(arch, mesh, rule, "max |logit| error over 6 steps from the prefill", r["prefill"],
          ", 2 from init_cache", r["init"], "and 1 from shard_cache of a whole cache",
          r["shard_cache"], "of", r["max"])
    assert max(r["prefill"], r["init"], r["shard_cache"]) <= F32_ATOL, r


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("arch", PARTS[0])
def test_sharded_init_cache_is_placed_as_the_prefill_cache(arch, mesh, rule):
    """Each rank made its shard only, placed by the cache rules: after a
    step, where the placements would show a redistribute, they are the
    same; the prefill's cache is placed so after its first step too."""
    r = result(arch, rule, mesh)
    data = "Shard(dim=1)" if rule == "seq_shard_cache" else "Shard(dim=0)"
    model = "Shard(dim=2)" if mesh == (4, 2) else "Replicate()"
    assert r["placed"] == r["init_placed"] == r["after_step"] == f"({data}, {model})", r
    assert r["pos"] == 2


@pytest.mark.parametrize("arch", PARTS[0])
def test_generate_under_a_mesh_gives_the_unsharded_greedy_tokens(arch):
    got, want = result(arch, "default", (2, 4))["generate"]
    assert got == want and len(want[0]) == 3
