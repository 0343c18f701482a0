"""Rank 0's capture of the decode step under a mesh
(``core.capture_sharded_step``) against the JAX package's capture of its
sharded decode step on 8 fake devices, jitted with ``launch/specs.py``'s
decode in_shardings (smoke configs, B 4, cache 64 at position 32;
gemma3-4b and qwen3-8b on meshes (2, 4) and (4, 2) over ("data", "model"),
under the default rules and under ``seq_shard_cache``).

Rank 0's ``parsed_flops`` equal the JAX per-device ``parsed_flops`` less one
gap, held exactly: under the default rules on (2, 4), where the smoke
archs' 2 kv heads do not divide the 4-wide model axis, each rank's k and v
products take the whole kv heads of its batch rows (one token a row: no
sequence to split them by, as the prefill does), 4 B D KV hd L / dp FLOPs,
where GSPMD splits them evenly over all 8 ranks; the gap is the difference
(``kv_gap``). Under ``seq_shard_cache`` GSPMD computes them as the port does,
and on (4, 2) both split them evenly: no gap. The attention products (scores
and P.V over each layer's cache or ring) are the even split in both.

Rank 0's graph has no kernel node (decode runs no Pallas kernel in the
reference, and none in the port). Under ``seq_shard_cache`` no collective
moves the cache: every collective kind's count and bytes are the same with
the cache twice as long (flash-decoding all-reduces the scores' max and sum
and the P.V partials, whose sizes do not depend on the length), and rank 0
holds its shard of the length only. The collective counts by kind are
printed beside JAX's (DTensor gathers where GSPMD also uses all-to-all and
collective-permute).
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
ARCHS = ("gemma3-4b", "qwen3-8b")
MESHES = ((2, 4), (4, 2))
RULES = ("default", "seq_shard_cache")
B, C, POS = 4, 64, 32


def kv_gap(cfg, mesh, rule):
    """The FLOPs by which rank 0's k and v products exceed GSPMD's (module
    docstring)."""
    dp, m = mesh
    if rule != "default" or cfg.num_kv_heads % m == 0:
        return 0
    port = 4 * B * cfg.d_model * cfg.num_kv_heads * cfg.head_dim * cfg.num_layers // dp
    return port - port // m


JAX_CAPTURE = textwrap.dedent("""
    import json, sys
    from repro.configs.base import ParallelConfig, ShapeConfig
    from repro.configs.registry import get_config
    from repro.core import capture_step
    from repro.launch.specs import input_specs
    from repro.parallel.mesh import make_mesh
    from repro.train.serve_step import make_decode_step

    arch, B, C = sys.argv[1], %d, %d
    cfg = get_config(arch, smoke=True)
    out = {}
    for rule in ("default", "seq_shard_cache"):
        for mesh_shape in ((2, 4), (4, 2)):
            mesh = make_mesh(mesh_shape, ("data", "model"))
            par = ParallelConfig(seq_shard_cache=rule == "seq_shard_cache")
            args, sh, jm, par, _ = input_specs(cfg, ShapeConfig("decode", "decode", C, B),
                                               mesh, par)
            cap = capture_step(make_decode_step(jm, par, mesh), args, sh, mesh)
            out[f"{rule}/{mesh_shape}"] = {
                "flops": cap.summary["parsed_flops"], "partitions": cap.meta["num_partitions"],
                "comm": {k: v["count"] for k, v in cap.summary["comm"].items()}}
    print(json.dumps(out))
""") % (B, C)

PORT_CAPTURE = textwrap.dedent("""
    import json, sys
    import torch
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core import capture_sharded_step, fake_mode
    from repro_torch.models import Model
    from repro_torch.parallel import sharding
    from repro_torch.parallel.mesh import fake_process_group, make_mesh
    from repro_torch.train.serve_step import make_decode_step

    torch.set_num_threads(1)
    arch, B, C, POS = sys.argv[1], %d, %d, %d
    cfg = get_config(arch, smoke=True)

    def capture(mesh_shape, rule, cache_len):
        par = ParallelConfig(seq_shard_cache=rule == "seq_shard_cache")
        with fake_process_group(8):
            mesh = make_mesh(mesh_shape, ("data", "model"), "cpu")
            with fake_mode():
                model = Model(cfg, device="cpu", abstract=True)
                sharding.shard_model(model, mesh, par)
                token = sharding.shard_inputs(
                    {"token": torch.empty(B, 1, dtype=torch.long)},
                    sharding.batch_specs(model, "decode", B, 1), mesh, par)["token"]
                cache = model.init_cache(B, cache_len, mesh=mesh, parallel=par)
                cache["pos"] = POS
                local = [tuple(c["attn"]["k"].to_local().shape) for c in cache["layers"]]
                cap = capture_sharded_step(make_decode_step(model, parallel=par, mesh=mesh),
                                           model, [token, cache])
        s = cap.summary
        return {"flops": s["parsed_flops"], "kernel_nodes": s["kernel_nodes"],
                "comm": {k: v["count"] for k, v in s["comm"].items()},
                "comm_bytes": {k: v["bytes"] for k, v in s["comm"].items()},
                "world": cap.meta["world_size"], "local_k": local}

    out = {}
    for rule in ("default", "seq_shard_cache"):
        for mesh_shape in ((2, 4), (4, 2)):
            out[f"{rule}/{mesh_shape}"] = capture(mesh_shape, rule, C)
        out[f"{rule}/{(2, 4)} x2"] = capture((2, 4), rule, 2 * C)
    print(json.dumps(out))
""") % (B, C, POS)


def _run(code, arch, devices=None):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, os.environ.get("PYTHONPATH", "")]))
    if devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    return subprocess.Popen([sys.executable, "-c", code, arch], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


_cache = {}


def _captures(arch):
    """(JAX captures, port captures) of ``arch``; the four processes start
    together at the first call."""
    if not _cache:
        procs = {(a, side): _run(code, a, devices)
                 for a in ARCHS for side, code, devices in (("jax", JAX_CAPTURE, 8),
                                                            ("port", PORT_CAPTURE, None))}
        for key, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-4000:]
            _cache[key] = json.loads(out.strip().splitlines()[-1])
    return _cache[arch, "jax"], _cache[arch, "port"]


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("arch", ARCHS)
def test_rank0_decode_capture_flops_match_the_jax_capture(arch, mesh, rule):
    jax_caps, port_caps = _captures(arch)
    j, p = jax_caps[f"{rule}/{mesh}"], port_caps[f"{rule}/{mesh}"]
    assert j["partitions"] == p["world"] == 8
    gap = kv_gap(get_config(arch, smoke=True), mesh, rule)
    print(arch, mesh, rule, "rank 0's decode FLOPs: JAX", j["flops"], "port", p["flops"],
          "k/v gap", gap, "| collectives: JAX", j["comm"], "port", p["comm"])
    assert p["flops"] - j["flops"] == gap


@pytest.mark.parametrize("arch", ARCHS)
def test_rank0_decode_capture_has_no_kernel_node(arch):
    _, port_caps = _captures(arch)
    for key, c in port_caps.items():
        assert c["kernel_nodes"] == {}, key


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("arch", ARCHS)
def test_no_collective_moves_the_cache(arch, rule):
    """Under seq_shard_cache rank 0 holds half the length of each layer's
    cache on (2, 4), and every collective's count and bytes are the same
    with the cache twice as long; under the default rules it holds its
    batch rows of the whole length, and the same holds."""
    _, port_caps = _captures(arch)
    one, two = port_caps[f"{rule}/{(2, 4)}"], port_caps[f"{rule}/{(2, 4)} x2"]
    cfg = get_config(arch, smoke=True)
    for k, kind in zip(one["local_k"], cfg.layer_kinds):
        length = min(cfg.local_window, C) if kind == "local" else C
        assert k[:2] == ([B, length // 2] if rule == "seq_shard_cache" else [B // 2, length])
    print(arch, rule, "collectives at cache", C, one["comm_bytes"], "and", 2 * C,
          two["comm_bytes"])
    assert one["comm"] == two["comm"] and one["comm_bytes"] == two["comm_bytes"]
    if rule == "seq_shard_cache":
        assert one["comm"]["all-reduce"] > port_caps[f"default/{(2, 4)}"]["comm"]["all-reduce"]
