"""The port's sharding rules (``repro_torch.parallel.sharding``) against the
JAX package's, and the rank-0 capture of a sharded step against the JAX
capture (CPU).

Held here:
  (a) each parameter's logical axes against the JAX spec's, the leading
      ``layers`` axis of a stacked layer dropped, paired through
      ``bridge.py``'s names, for all ten archs at full and smoke size;
  (b) each parameter's ``resolve_spec`` against the JAX ``resolve_spec``,
      for all ten archs at full and smoke size, under tp (fsdp off), fsdp
      and zero3, on (16, 16), (2, 16, 16), (2, 4) and (4, 2); the inputs'
      ``batch_specs`` likewise; and on 8 fake devices each parameter's local
      shard (its shape and which rows and columns each rank holds) against
      ``NamedSharding``'s;
  (c) the eight cases of tests/test_sharding.py, as cases of one test;
  (e) rank 0's capture of the sharded eval step at smoke size on (2, 4) and
      (4, 2), beside the JAX capture of the same step on 8 fake devices:
      per-rank ``parsed_flops`` equal but for the gaps measured and held in
      ``MESH_GAPS``; one K1 node a layer; each collective kind's count
      printed beside the JAX capture's and linear in depth; and a trace
      over DTensor arguments refused.

The subprocesses stand up JAX's 8 fake devices or a fake process group,
which are global to a process.
"""
import json
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs.base import ParallelConfig as JParallel  # noqa: E402
from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.parallel import sharding as js  # noqa: E402
from repro_torch.bridge import _unstack  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.configs.registry import ARCH_NAMES, get_config  # noqa: E402
from repro_torch.core import fake_mode  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x4": {"data": 2, "model": 4}, "4x2": {"data": 4, "model": 2}}
PARALLEL = {"tp": {"fsdp": False}, "fsdp": {}, "zero3": {"model_axis": "zero3"}}
SIZES = ("full", "smoke")

_cache = {}


def _specs(arch, size):
    """({port name: (logical axes, shape)} of the JAX spec tree, unstacked
    by bridge.py's rule, {port name: ParamSpec} of the port's model)."""
    key = (arch, size)
    if key not in _cache:
        smoke = size == "smoke"
        jm = jax_build(jax_config(arch, smoke=smoke))
        cfg = get_config(arch, smoke=smoke)

        def leaf(s):
            if s.logical_axes[:1] != ("layers",):
                return (tuple(s.logical_axes), tuple(s.shape))
            stack = np.empty(s.shape[0], dtype=object)
            for r in range(s.shape[0]):
                stack[r] = (tuple(s.logical_axes[1:]), tuple(s.shape[1:]))
            return stack

        def convert(tree):
            return {k: convert(v) if isinstance(v, dict) else leaf(v) for k, v in tree.items()}

        jax_named = _unstack(convert(jm.param_specs()), cfg)
        with fake_mode():
            port = Model(cfg, device="cpu", abstract=True).param_specs()
        _cache[key] = jax_named, port
    return _cache[key]


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


# ---------------------------------------------------------------------------
# (a) logical axes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_logical_axes_are_the_jax_specs(arch, size):
    jax_named, port = _specs(arch, size)
    assert sorted(jax_named) == sorted(port)
    for name, spec in port.items():
        axes, shape = jax_named[name]
        assert (spec.logical_axes, tuple(spec.shape)) == (axes, shape), name


def test_every_logical_axis_is_a_rule_or_unsharded():
    """The names the specs use are the rules' names, plus head_dim, which
    no rule shards (as in the JAX package)."""
    names = {a for arch in ARCH_NAMES for s in _specs(arch, "smoke")[1].values()
             for a in s.logical_axes if a}
    rules = sharding.param_rules(ParallelConfig())
    assert names - set(rules) == {"head_dim"}
    assert names <= set(sharding._PRIORITY) | {"head_dim"}


# ---------------------------------------------------------------------------
# (b) resolved specs and shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("parallel", PARALLEL)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_resolve_as_the_jax_rules(arch, parallel):
    prules = sharding.param_rules(ParallelConfig(**PARALLEL[parallel]))
    jrules = js.param_rules(JParallel(**PARALLEL[parallel]))
    n = 0
    for size in SIZES:
        jax_named, port = _specs(arch, size)
        for mesh in MESHES.values():
            for name, spec in port.items():
                want = js.resolve_spec(*jax_named[name], jrules, FakeMesh(mesh))
                got = sharding.resolve_spec(spec.logical_axes, spec.shape, prules, mesh)
                assert got == tuple(want), (name, mesh, got, want)
                n += 1
    assert n == len(MESHES) * sum(len(_specs(arch, s)[1]) for s in SIZES)


@pytest.mark.parametrize("kind", ("train", "prefill", "decode"))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_batch_specs_resolve_as_the_jax_rules(arch, kind):
    B, S = 256, 4096
    jm = jax_build(jax_config(arch))
    want = js.batch_specs(jm.cfg, types.SimpleNamespace(global_batch=B, seq_len=S,
                                                        kind=kind), jm)
    with fake_mode():
        got = sharding.batch_specs(Model(get_config(arch), device="cpu", abstract=True),
                                   kind, B, S)
    assert sorted(got) == sorted(want)
    for p in (ParallelConfig(), ParallelConfig(seq_shard=False),
              ParallelConfig(model_axis="zero3")):
        jp = JParallel(seq_shard=p.seq_shard, model_axis=p.model_axis)
        for mesh in MESHES.values():
            for k, s in got.items():
                assert (s.logical_axes, s.shape) == (want[k].logical_axes, want[k].shape)
                assert sharding.resolve_spec(s.logical_axes, s.shape,
                                             sharding.activation_rules(p), mesh) == \
                    tuple(js.resolve_spec(s.logical_axes, s.shape,
                                          js.activation_rules(jp), FakeMesh(mesh)))


SHARDS = textwrap.dedent("""
    import json, types
    import numpy as np
    import jax
    from jax.sharding import NamedSharding
    import torch
    from repro.configs.base import ParallelConfig as JParallel
    from repro.configs.registry import get_config as jax_config
    from repro.models import build_model as jax_build
    from repro.parallel import sharding as js
    from repro.parallel.mesh import make_mesh as jax_mesh
    from repro_torch.bridge import _unstack
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.configs.registry import ARCH_NAMES, get_config
    from repro_torch.core import fake_mode
    from repro_torch.models import Model
    from repro_torch.parallel import sharding
    from repro_torch.parallel.mesh import coordinate, fake_process_group, make_mesh

    PARALLEL = {"tp": {"fsdp": False}, "fsdp": {}, "zero3": {"model_axis": "zero3"}}
    out = {}
    with fake_process_group(8):
        for mesh_shape in ((2, 4), (4, 2)):
            jmesh = jax_mesh(mesh_shape, ("data", "model"))
            mesh = make_mesh(mesh_shape, ("data", "model"), "cpu")
            devices = np.asarray(jmesh.devices)
            for arch in ARCH_NAMES:
                for smoke in (True, False):
                    jm = jax_build(jax_config(arch, smoke=smoke))
                    cfg = get_config(arch, smoke=smoke)
                    with fake_mode():
                        port = Model(cfg, device="cpu", abstract=True).param_specs()
                    bad, n = [], 0
                    for pname, kw in PARALLEL.items():
                        jspecs = js.tree_shardings(jmesh, jm.param_specs(),
                                                   js.param_rules(JParallel(**kw)))
                        named = {}
                        def walk(tree, specs, prefix=""):
                            for k in tree:
                                if isinstance(tree[k], dict):
                                    walk(tree[k], specs[k], prefix + k + ".")
                                else:
                                    named[prefix + k] = (tree[k], specs[k])
                        walk(jspecs, jm.param_specs())
                        prules = sharding.param_rules(ParallelConfig(**kw))
                        for name, spec in port.items():
                            # the JAX leaf this port parameter came from
                            parts = name.split(".")
                            if parts[0] == "layers":
                                i = int(parts[1]); nsb = len(cfg.superblock)
                                if i < nsb * cfg.sb_repeat:
                                    jname = f"blocks.sb.slot{i % nsb}." + ".".join(parts[2:])
                                else:
                                    jname = f"blocks.rem{i - nsb * cfg.sb_repeat}." + ".".join(parts[2:])
                            elif parts[:2] == ["encoder", "layers"]:
                                jname = "encoder.sb.slot0." + ".".join(parts[3:])
                            else:
                                jname = name
                            jsh, jspec = named[jname]
                            stacked = jspec.logical_axes[:1] == ("layers",)
                            pl = sharding.resolve_placements(spec.logical_axes, spec.shape,
                                                             prules, mesh)
                            idx = jsh.devices_indices_map(tuple(jspec.shape))
                            full = torch.empty(spec.shape, device="meta")
                            for r in range(8):
                                c = coordinate(mesh, r)
                                want = idx[devices[tuple(c)]]
                                if stacked:
                                    assert want[0] == slice(None) or want[0] == slice(0, jspec.shape[0], None), want
                                    want = want[1:]
                                want = [(s.start or 0, s.stop if s.stop is not None else d)
                                        for s, d in zip(want, spec.shape)]
                                # the port's shard: its shape and its offsets
                                shape = list(sharding.local_shard(full, mesh, pl, c).shape)
                                got = []
                                for d, size in enumerate(spec.shape):
                                    lo = 0
                                    for i, p in enumerate(pl):
                                        if p.is_shard() and p.dim == d:
                                            size //= mesh.size(i)
                                            lo += c[i] * size
                                    got.append((lo, lo + size))
                                n += 1
                                if got != want or shape != [b - a for a, b in want]:
                                    bad.append([pname, name, r, got, want, shape])
                    out[f"{arch}/{'smoke' if smoke else 'full'}/{mesh_shape}"] = {"n": n, "bad": bad[:5]}
    print(json.dumps(out))
""")


def _shards():
    if "shards" not in _cache:
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, os.environ.get("PYTHONPATH", "")]),
                   XLA_FLAGS="--xla_force_host_platform_device_count=8")
        proc = subprocess.run([sys.executable, "-c", SHARDS], capture_output=True, text=True,
                              env=env, timeout=600)
        assert proc.returncode == 0, proc.stderr[-4000:]
        _cache["shards"] = json.loads(proc.stdout.strip().splitlines()[-1])
    return _cache["shards"]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_each_rank_holds_the_shard_named_sharding_gives_it(arch):
    res = _shards()
    for size in SIZES:
        for mesh in ("(2, 4)", "(4, 2)"):
            r = res[f"{arch}/{size}/{mesh}"]
            assert r["n"] == 3 * 8 * len(_specs(arch, size)[1]) and not r["bad"], r


# ---------------------------------------------------------------------------
# (c) the reference's rule cases
# ---------------------------------------------------------------------------

MESH, MESH3 = MESHES["16x16"], MESHES["2x16x16"]
RULE_CASES = {
    # batch prefers (pod, data); seq takes the model axis
    "batch_prefers_pod_data": [
        ("act", {}, ("batch", "seq"), (256, 4096), MESH3, P(("pod", "data"), "model")),
        ("act", {}, ("batch", "seq"), (256, 4096), MESH, P("data", "model"))],
    # batch=1 (long_500k): nothing divides -> replicated
    "batch_divisibility_fallback": [
        ("act", {}, ("batch", None), (1, 1), MESH, P())],
    # residual: seq gets model; q: heads wins model, seq left unsharded
    "seq_is_low_priority": [
        ("act", {"seq_shard": True}, ("batch", "seq", "embed"), (256, 4096, 4096), MESH,
         P("data", "model")),
        ("act", {"seq_shard": True}, ("batch", "seq", "heads", None), (256, 4096, 32, 128),
         MESH, P("data", None, "model"))],
    # gemma3-4b: 8 q-heads on a 16-way model axis -> replicated heads
    "heads_divisibility_fallback": [
        ("act", {"seq_shard": False}, ("batch", None, "heads", None), (256, 1, 8, 256), MESH,
         P("data"))],
    # dbrx's 16 experts take the model axis (EP); mixtral's 8 fall to ff (TP)
    "ep_vs_tp_falls_out_of_divisibility": [
        ("param", {"fsdp": False}, ("experts", "embed", "ff"), (16, 6144, 10752), MESH,
         P("model")),
        ("param", {"fsdp": False}, ("experts", "embed", "ff"), (8, 4096, 14336), MESH,
         P(None, None, "model"))],
    # params FSDP-shard embed; activations never do
    "fsdp_shards_embed_dim_of_params": [
        ("param", {"fsdp": True}, ("embed", "ff"), (4096, 12288), MESH, P("data", "model")),
        ("act", {"seq_shard": False}, ("batch", "seq", "embed"), (32, 128, 4096), MESH,
         P("data"))],
    "no_duplicate_axis_in_one_tensor": [
        ("act", {"seq_shard": True}, ("vocab", "embed", "ff"), (256 * 16, 4096, 12288), MESH,
         None)],
    "cache_sharding_only_when_enabled": [
        ("act", {"seq_shard_cache": True}, ("batch", "cache", "kv_heads", None),
         (1, 524288, 8, 256), MESH, P(None, "data")),
        ("act", {"seq_shard_cache": False}, ("batch", "cache", "kv_heads", None),
         (1, 524288, 8, 256), MESH, P())],
}


@pytest.mark.parametrize("case", RULE_CASES)
def test_reference_rule_cases(case):
    for which, kw, axes, shape, mesh, want in RULE_CASES[case]:
        rules = (sharding.activation_rules if which == "act" else sharding.param_rules)(
            ParallelConfig(**kw))
        got = sharding.resolve_spec(axes, shape, rules, mesh)
        jrules = (js.activation_rules if which == "act" else js.param_rules)(JParallel(**kw))
        assert got == tuple(js.resolve_spec(axes, shape, jrules, FakeMesh(mesh)))
        if want is None:
            flat = [a for e in got if e for a in (e if isinstance(e, tuple) else (e,))]
            assert len(flat) == len(set(flat)), got
        else:
            assert got == tuple(want), (case, got, want)


# ---------------------------------------------------------------------------
# (e) the rank-0 capture of a sharded step against the JAX capture
# ---------------------------------------------------------------------------

CAPTURE_ARCHS = ("gemma3-4b", "qwen3-8b", "granite-3-8b", "gemma3-12b")
B, S = 4, 16

# JAX's per-device parsed_flops minus the port's rank 0's, measured:
# (total, outside attention). Outside attention it is the JAX dots that carry
# op metadata against the port's nodes other than K1; in attention, the JAX
# dots without metadata (its attention's) against the port's K1 nodes.
#  * on (2, 4) the smoke archs' 2 kv heads do not divide the 4-wide model
#    axis: the port computes k and v from the rank's rows of the
#    seq-sharded residual and gathers them (2 x 32,768 FLOPs a layer on
#    rank 0), where GSPMD's k and v products take 163,840 a layer on each
#    device; the global layers' attention matches;
#  * gemma3-4b and gemma3-12b's local (windowed) attention: GSPMD runs the
#    reference's blocked local attention at 819,200 FLOPs a device for
#    gemma3-4b's 4 layers on both meshes, the port's K1 at 32,768 a layer on
#    (2, 4) and (4, 2) (its rank's 2 x 1 or 1 x 2 (batch, head) pairs of 16
#    x 16 queries and keys).
#  * recurrentgemma-9b (tests/test_torch_mesh_rglru_capture.py): its RG-LRU
#    layers match exactly; its local layer's blocked attention takes 262,144
#    FLOPs a device against K1's 32,768, and its projections (one kv head)
#    49,152 more on (2, 4) and 16,384 more on (4, 2).
MESH_GAPS = {
    ("gemma3-4b", (2, 4)): (1_081_344, 393_216), ("gemma3-4b", (4, 2)): (688_128, 0),
    ("qwen3-8b", (2, 4)): (294_912, 294_912), ("qwen3-8b", (4, 2)): (0, 0),
    ("granite-3-8b", (2, 4)): (294_912, 294_912), ("granite-3-8b", (4, 2)): (0, 0),
    ("gemma3-12b", (2, 4)): (1_507_328, 589_824), ("gemma3-12b", (4, 2)): (917_504, 0),
    ("recurrentgemma-9b", (2, 4)): (278_528, 49_152),
    ("recurrentgemma-9b", (4, 2)): (245_760, 16_384),
}

JAX_CAPTURE = textwrap.dedent("""
    import json, types
    import jax
    from repro.configs.base import ParallelConfig
    from repro.configs.registry import get_config
    from repro.core import capture_step
    from repro.core.hlo_parse import instruction_flops, parse_hlo, walk_instructions
    from repro.models import build_model
    from repro.parallel.mesh import make_mesh
    from repro.parallel import sharding as js
    from repro.train.train_step import make_eval_step

    out = {}
    for arch in %r:
        cfg = get_config(arch, smoke=True)
        jm = build_model(cfg)
        for mesh_shape in ((2, 4), (4, 2)):
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
            out[f"{arch}/{mesh_shape}"] = {
                "flops": cap.summary["parsed_flops"], "attention": attn,
                "comm": {k: v["count"] for k, v in cap.summary["comm"].items()},
                "partitions": cap.meta["num_partitions"]}
    print(json.dumps(out))
""") % (CAPTURE_ARCHS, B, S)

PORT_CAPTURE = textwrap.dedent("""
    import json
    import torch
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core import capture_sharded_step, capture_step, fake_mode
    from repro_torch.models import Model
    from repro_torch.parallel import sharding
    from repro_torch.parallel.mesh import fake_process_group, make_mesh
    from repro_torch.train.train_step import make_eval_step

    def capture(cfg, mesh_shape, par=ParallelConfig()):
        with fake_process_group(8):
            mesh = make_mesh(mesh_shape, ("data", "model"), "cpu")
            with fake_mode():
                model = Model(cfg, device="cpu", abstract=True)
                sharding.shard_model(model, mesh, par)
                tok = torch.empty(%d, %d, dtype=torch.long)
                batch = sharding.shard_inputs({"tokens": tok, "labels": tok},
                                              sharding.batch_specs(model, "train", %d, %d),
                                              mesh, par)
                step = make_eval_step(model, par, mesh)
                cap = capture_sharded_step(step, model, [batch])
                try:
                    capture_step(step, (batch,))
                    refused = ""
                except ValueError as e:
                    refused = str(e)
        g, s = cap.graph, cap.summary
        k1 = sum(n.attrs["flops"] for n in g.nodes
                 if n.attrs.get("op", "").startswith("repro_torch.flash_attention"))
        g.validate()
        return {"flops": s["parsed_flops"], "attention": k1, "kernel_nodes": s["kernel_nodes"],
                "comm": {k: v["count"] for k, v in s["comm"].items()},
                "groups": sorted({len(c["group"]) for c in s["collectives"]}),
                "world": cap.meta["world_size"], "refused": refused}

    out = {}
    for arch in %r:
        cfg = get_config(arch, smoke=True)
        for mesh_shape in ((2, 4), (4, 2)):
            out[f"{arch}/{mesh_shape}"] = capture(cfg, mesh_shape)
        # depth: 1, 2 and 4 repeats of the superblock, no remainder
        nsb = len(cfg.superblock)
        for r in (1, 2, 4):
            c = cfg.replace(num_layers=r * nsb, sb_repeat=r, remainder=())
            out[f"{arch}/{r * nsb}"] = capture(c, (2, 4))
    print(json.dumps(out))
""") % (B, S, B, S, CAPTURE_ARCHS)


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


@pytest.mark.parametrize("mesh", ((2, 4), (4, 2)), ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("arch", CAPTURE_ARCHS)
def test_rank0_capture_flops_match_the_jax_capture(arch, mesh):
    jax_caps, port_caps = _captures()
    j, p = jax_caps[f"{arch}/{mesh}"], port_caps[f"{arch}/{mesh}"]
    assert j["partitions"] == p["world"] == 8
    gap = (j["flops"] - p["flops"], (j["flops"] - j["attention"]) - (p["flops"] - p["attention"]))
    print(arch, mesh, "per-rank FLOPs: JAX", j["flops"], "port", p["flops"], "gap", gap,
          "| collectives: JAX", j["comm"], "port", p["comm"])
    assert gap == MESH_GAPS[(arch, mesh)], (arch, mesh, j, p)


@pytest.mark.parametrize("arch", CAPTURE_ARCHS)
def test_rank0_capture_has_one_k1_node_a_layer_and_collectives_linear_in_depth(arch):
    _, port_caps = _captures()
    cfg = get_config(arch, smoke=True)
    nsb = len(cfg.superblock)
    for mesh in ((2, 4), (4, 2)):
        assert port_caps[f"{arch}/{mesh}"]["kernel_nodes"] == {
            "flash_attention_fwd": cfg.num_layers}
    caps = [port_caps[f"{arch}/{r * nsb}"] for r in (1, 2, 4)]
    for c, r in zip(caps, (1, 2, 4)):
        assert c["kernel_nodes"] == {"flash_attention_fwd": r * nsb}
        assert c["groups"] == [2, 4]            # over the data and the model axis
    for kind in caps[2]["comm"]:
        n1, n2, n4 = (c["comm"].get(kind, 0) for c in caps)
        assert n4 - n2 == 2 * (n2 - n1), (kind, n1, n2, n4)
    f1, f2, f4 = (c["flops"] for c in caps)
    assert f4 - f2 == 2 * (f2 - f1)


def test_a_trace_over_dtensor_arguments_is_refused():
    _, port_caps = _captures()
    for c in port_caps.values():
        assert "counts the FLOPs of every rank" in c["refused"]
