"""Rank 0's capture of recurrentgemma-9b's sharded steps against the JAX
capture of the same sharded step (smoke config, CPU, 8 ranks).

The eval step (B 4 x S 16, tests/test_torch_sharding.py's shape) on meshes
(2, 4) and (4, 2) under the default rules: the JAX package's
``capture_step`` of its jitted step on 8 fake devices (GSPMD's per-device
program) against the port's ``capture_sharded_step`` over rank 0's shards
under a fake process group of 8. The gaps are held exactly, in
``MESH_GAPS`` (tests/test_torch_sharding.py), as (total, outside attention):

  * K3's node against the reference's associative scan: neither counts
    FLOPs for the scan (K3's operator registers none, and the reference's
    scan has no dot), so the RG-LRU layers add no gap, as unsharded
    (tests/test_torch_capture.py's ``JAX_GAPS``); held on the smoke config
    with its local layer taken out (4 RG-LRU layers): no gap on either mesh;
  * the local layer's attention: GSPMD runs the reference's blocked local
    attention at 262,144 FLOPs a device, the port K1 at 32,768 on its
    rank's two (batch, head) pairs of 16 x 16 queries and keys (gemma3's
    gap of the same kind);
  * the local layer's projections: its one kv head divides neither model
    axis, and GSPMD's per-device products take 49,152 FLOPs more than the
    port's on (2, 4) and 16,384 more on (4, 2).

Also held: rank 0's forward has one K3 node a RG-LRU layer, each on the
rank's local (B/dp, S, dr/m) channels, and one K1 node for the local layer;
its decode step has no kernel node.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from test_torch_sharding import MESH_GAPS  # noqa: E402

from repro_torch.configs.registry import get_config  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCH = "recurrentgemma-9b"
MESHES = ((2, 4), (4, 2))
B, S, C = 4, 16, 64
IDS = {"ids": lambda m: "x".join(map(str, m))}
# the smoke config without its local layer: two superblocks of two RG-LRU
# layers
RGLRU_ONLY = {"superblock": ("rglru", "rglru"), "num_layers": 4, "sb_repeat": 2,
              "remainder": ()}

JAX_CAPTURE = textwrap.dedent("""
    import json, types
    from repro.configs.base import ParallelConfig
    from repro.configs.registry import get_config
    from repro.core import capture_step
    from repro.core.hlo_parse import instruction_flops, parse_hlo, walk_instructions
    from repro.models import build_model
    from repro.parallel.mesh import make_mesh
    from repro.parallel import sharding as js
    from repro.train.train_step import make_eval_step

    smoke = get_config(%r, smoke=True)
    out = {}
    for name, mesh_shape in [(n, m) for n in ("smoke", "rglru") for m in %r]:
        cfg = smoke.replace(**(%r if name == "rglru" else {}))
        jm = build_model(cfg)
        mesh = make_mesh(mesh_shape, ("data", "model"))
        par = ParallelConfig()
        bs = js.batch_specs(cfg, types.SimpleNamespace(global_batch=%d, seq_len=%d,
                                                       kind="train"), jm)
        args = (jm.abstract_params(), {k: s.abstract() for k, s in bs.items()})
        sh = (js.tree_shardings(mesh, jm.param_specs(), js.param_rules(par)),
              js.tree_shardings(mesh, bs, js.activation_rules(par)))
        cap = capture_step(make_eval_step(jm, par, mesh), args, sh, mesh)
        mod = parse_hlo(cap.compiled_text)
        attn = sum(instruction_flops(mod, ins, comp) * mult
                   for ins, mult, comp in walk_instructions(mod) if not ins.metadata_op)
        out[name + "/" + "x".join(map(str, mesh_shape))] = {
            "flops": cap.summary["parsed_flops"], "attention": attn,
            "comm": {k: v["count"] for k, v in cap.summary["comm"].items()},
            "partitions": cap.meta["num_partitions"]}
    print(json.dumps(out))
""") % (ARCH, MESHES, RGLRU_ONLY, B, S)

PORT_CAPTURE = textwrap.dedent("""
    import json
    import torch
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core import capture_sharded_step, fake_mode
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.parallel import sharding
    from repro_torch.parallel.mesh import fake_process_group, make_mesh
    from repro_torch.train.serve_step import make_decode_step, make_forward_step
    from repro_torch.train.train_step import make_eval_step

    B, S, C = %d, %d, %d
    cfg = get_config(%r, smoke=True)
    shapes, kernel = [], ops.rglru_scan

    def recorded(a, b):
        shapes.append(list(a.shape))
        return kernel(a, b)

    ops.rglru_scan = recorded

    def capture(cfg, mesh_shape, step):
        par = ParallelConfig()
        with fake_process_group(8):
            mesh = make_mesh(mesh_shape, ("data", "model"), "cpu")
            with fake_mode():
                model = Model(cfg, device="cpu", abstract=True)
                sharding.shard_model(model, mesh, par)
                if step == "decode":
                    tok = torch.empty(B, 1, dtype=torch.long)
                    args = [sharding.shard_inputs({"token": tok}, sharding.batch_specs(
                        model, "decode", B, 1), mesh, par)["token"],
                        model.init_cache(B, C, mesh=mesh, parallel=par)]
                    args[1]["pos"] = C - 1
                    fn = make_decode_step(model, parallel=par, mesh=mesh)
                else:
                    tok = torch.empty(B, S, dtype=torch.long)
                    batch = sharding.shard_inputs({"tokens": tok, "labels": tok},
                                                  sharding.batch_specs(model, "train", B, S),
                                                  mesh, par)
                    fn = (make_eval_step(model, par, mesh) if step == "eval"
                          else make_forward_step(model, parallel=par, mesh=mesh))
                    args = [batch] if step == "eval" else [batch["tokens"]]
                del shapes[:]
                cap = capture_sharded_step(fn, model, args)
        g, s = cap.graph, cap.summary
        g.validate()
        k1 = sum(n.attrs["flops"] for n in g.nodes
                 if n.attrs.get("op", "").startswith("repro_torch.flash_attention"))
        k3 = sum(n.attrs["flops"] for n in g.nodes
                 if n.attrs.get("op", "").startswith("repro_torch.rglru"))
        return {"flops": s["parsed_flops"], "attention": k1, "k3_flops": k3,
                "kernel_nodes": s["kernel_nodes"], "k3_shapes": list(shapes),
                "comm": {k: v["count"] for k, v in s["comm"].items()},
                "world": cap.meta["world_size"]}

    out = {}
    for mesh_shape in %r:
        key = "x".join(map(str, mesh_shape))
        out["smoke/" + key] = {step: capture(cfg, mesh_shape, step)
                               for step in ("eval", "forward", "decode")}
        out["rglru/" + key] = {"eval": capture(cfg.replace(**%r), mesh_shape, "eval")}
    print(json.dumps(out))
""") % (B, S, C, ARCH, MESHES, RGLRU_ONLY)

_cache = {}


def _captures():
    if "captures" not in _cache:
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, os.environ.get("PYTHONPATH", "")]))
        procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True, env=dict(env, **extra))
                 for code, extra in ((JAX_CAPTURE, {"XLA_FLAGS":
                                                    "--xla_force_host_platform_device_count=8"}),
                                     (PORT_CAPTURE, {}))]
        res = []
        for proc in procs:
            out, err = proc.communicate(timeout=900)
            assert proc.returncode == 0, err[-4000:]
            res.append(json.loads(out.strip().splitlines()[-1]))
        _cache["captures"] = res
    return _cache["captures"]


def _gap(mesh, config="smoke"):
    jax_caps, port_caps = _captures()
    key = f"{config}/" + "x".join(map(str, mesh))
    j, p = jax_caps[key], port_caps[key]["eval"]
    assert j["partitions"] == p["world"] == 8
    gap = (j["flops"] - p["flops"], (j["flops"] - j["attention"]) - (p["flops"] - p["attention"]))
    print(ARCH, config, mesh, "per-rank FLOPs: JAX", j["flops"], "port", p["flops"], "gap", gap,
          "K3 FLOPs", p["k3_flops"], "| collectives: JAX", j["comm"], "port", p["comm"])
    return gap


@pytest.mark.parametrize("mesh", MESHES, **IDS)
def test_rank0_rglru_capture_flops_match_the_jax_capture(mesh):
    assert _gap(mesh) == MESH_GAPS[(ARCH, mesh)]


@pytest.mark.parametrize("mesh", MESHES, **IDS)
def test_rank0_capture_of_rglru_layers_alone_has_no_gap(mesh):
    """Without the local layer the port's rank 0 and GSPMD's device 0 run
    the same FLOPs: the whole gap is the local layer's."""
    assert _gap(mesh, "rglru") == (0, 0)


@pytest.mark.parametrize("mesh", MESHES, **IDS)
def test_rank0_rglru_capture_has_one_k3_node_a_layer_on_local_channels(mesh):
    """Forward and eval: one K3 node a RG-LRU layer on rank 0's (B/dp, S,
    dr/m) channels and one K1 node for the local layer; decode: none."""
    _, port_caps = _captures()
    cfg = get_config(ARCH, smoke=True)
    caps = port_caps["smoke/" + "x".join(map(str, mesh))]
    rg, local = cfg.layer_kinds.count("rglru"), cfg.layer_kinds.count("local")
    dp, m = mesh
    for step in ("eval", "forward"):
        assert caps[step]["kernel_nodes"] == {"flash_attention_fwd": local,
                                              "rglru_scan_fwd": rg}, caps[step]
        assert caps[step]["k3_shapes"] == [[B // dp, S, cfg.d_rnn // m]] * rg, caps[step]
    assert caps["decode"]["kernel_nodes"] == {} and caps["decode"]["k3_shapes"] == []
    assert caps["forward"]["world"] == caps["decode"]["world"] == 8
