"""Rank 0's capture of the train step under a mesh
(``core.capture_sharded_step``) against the JAX package's capture of its
sharded train step on 8 fake devices (smoke configs, B 4 x S 48, default
``ParallelConfig()`` and ``OptConfig()``; gemma3-4b and qwen3-8b on meshes
(2, 4) and (4, 2) over ("data", "model")).

Rank 0's ``parsed_flops`` equal the JAX per-device ``parsed_flops`` less
these gaps, each held exactly:
  * attention. The JAX step's attention products (its dots without op
    metadata) are its forward's (E, measured on the JAX eval step), twice
    that in the backward, and R more: remat dots recomputes the attention
    products of the rematted superblock repeats, which have batch
    dimensions (R = the train step's attention at remat dots less that at
    remat none). The port's are K1's forward (K), K1's backward, which
    computes the scores again (2.5 K), and K1's forward again in each layer
    of a rematted repeat (Kr: the dots policy saves the weight products
    only). Gap: 3 (E - K) + R - Kr - K / 2. E - K is the forward's gap
    (tests/test_torch_sharding.py's MESH_GAPS): gemma3-4b's local layers,
    where GSPMD runs the reference's blocked local attention and K1 its
    whole causal tile; 0 for qwen3-8b's global layers, where R = Kr = K.
  * weight products. The port's are three times its eval step's, the
    forward's and their two backward products each (held exactly: AdamW,
    the norms and the collectives add no FLOPs; parsed_flops counts
    products only, in both packages, so AdamW's elementwise update counts 0
    in both). The JAX step's are as many on (4, 2); on (2, 4), where the
    smoke archs' 2 kv heads do not divide the 4-wide model axis, GSPMD's q,
    k and v products (its dots whose op metadata is the einsum
    ``bsd,dhk->bshk``, summed from the HLO) take ``kv_gap`` more than the
    even split over the 8 ranks that the port computes (q by heads, k and v
    from the rank's rows of the sequence-sharded residual, then gathered).
    The HLO shows where: the backward of each layer in the rematted scan
    takes one unit more, a unit being one k product's even share (2 B S D
    KV hd / 8: 98,304 FLOPs at this size), and a layer outside the scan
    (gemma3-4b's remainder) three more in its forward, as every layer of
    GSPMD's eval program does, and one more in its backward. On (4, 2),
    where KV divides the model axis, GSPMD's are the even split. The
    formula is held at the smoke depth and at one superblock repeat more.
The collective counts by kind are printed beside JAX's: DTensor gathers
where GSPMD uses all-to-all and collective-permute (PERF.md section 7), so
the port's are held linear in depth at 1, 2 and 4 superblock repeats, not
equal to JAX's. Rank 0's graph has exactly one K1-forward node and one
K1-backward node a layer at remat none, and at remat dots and full one
K1-forward node more for each layer of a rematted repeat: the recompute that
the launches on the card count (chip_smoke.py phase 8).
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
B, S = 4, 48
DEPTHS = (1, 2, 4)
# the op metadata of the q, k and v products in the JAX HLO
QKV = "bsd,dhk->bshk"


def deeper(cfg):
    """``cfg`` with one superblock repeat more, its remainder kept."""
    return cfg.replace(num_layers=cfg.num_layers + len(cfg.superblock),
                       sb_repeat=cfg.sb_repeat + 1)


def qkv_even(cfg, mesh):
    """The q, k and v products' FLOPs a rank of a train step (forward and
    its two backward products), split evenly over the ranks."""
    return (3 * 2 * B * S * cfg.d_model * (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
            * cfg.num_layers // (mesh[0] * mesh[1]))


def kv_gap(cfg, mesh):
    """The FLOPs a rank that GSPMD's q, k and v products of the train step
    take beyond ``qkv_even`` (see the module docstring)."""
    if cfg.num_kv_heads % mesh[1] == 0:
        return 0
    unit = 2 * B * S * cfg.d_model * cfg.num_kv_heads * cfg.head_dim // (mesh[0] * mesh[1])
    return unit * (len(cfg.superblock) * cfg.sb_repeat + 4 * len(cfg.remainder))

JAX_CAPTURE = textwrap.dedent("""
    import json, sys, types
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs.base import ParallelConfig
    from repro.configs.registry import get_config
    from repro.core import capture_step
    from repro.core.hlo_parse import instruction_flops, parse_hlo, walk_instructions
    from repro.models import build_model
    from repro.parallel import sharding as js
    from repro.parallel.mesh import make_mesh
    from repro.train.optimizer import OptConfig, OptState
    from repro.train.train_step import (TrainState, init_train_state, make_eval_step,
                                        make_train_step)

    arch, B, S, QKV = sys.argv[1], %d, %d, %r
    base = get_config(arch, smoke=True)
    # one superblock repeat more, the remainder kept (the test's deeper())
    deeper = base.replace(num_layers=base.num_layers + len(base.superblock),
                          sb_repeat=base.sb_repeat + 1)
    out = {}
    runs = [(base, m, w, "") for m in ((2, 4), (4, 2)) for w in ("eval", "dots", "none")]
    for cfg, mesh_shape, what, tag in runs + [(deeper, (2, 4), "dots", " deeper")]:
        jm = build_model(cfg)
        mesh = make_mesh(mesh_shape, ("data", "model"))
        par = ParallelConfig(remat="none" if what == "none" else "dots")
        bs = js.batch_specs(cfg, types.SimpleNamespace(global_batch=B, seq_len=S,
                                                       kind="train"), jm)
        batch = {k: s.abstract() for k, s in bs.items()}
        bsh = js.tree_shardings(mesh, bs, js.activation_rules(par))
        psh = js.tree_shardings(mesh, jm.param_specs(), js.param_rules(par))
        if what == "eval":
            cap = capture_step(make_eval_step(jm, par, mesh),
                               (jm.abstract_params(), batch), (psh, bsh), mesh)
        else:
            state = jax.eval_shape(lambda: init_train_state(jm, jax.random.PRNGKey(0), par))
            ssh = TrainState(psh, OptState(NamedSharding(mesh, P()), psh, psh), {})
            cap = capture_step(make_train_step(jm, OptConfig(), par, mesh), (state, batch),
                               (ssh, bsh), mesh)
        mod = parse_hlo(cap.compiled_text)
        flops = [(instruction_flops(mod, ins, comp) * mult, ins.metadata_op)
                 for ins, mult, comp in walk_instructions(mod)]
        out[f"{mesh_shape}/{what}{tag}"] = {
            "flops": cap.summary["parsed_flops"],
            "attention": sum(f for f, op in flops if not op),
            "qkv": sum(f for f, op in flops if QKV in op and op.endswith("dot_general")),
            "comm": {k: v["count"] for k, v in cap.summary["comm"].items()},
            "partitions": cap.meta["num_partitions"]}
    print(json.dumps(out))
""") % (B, S, QKV)

PORT_CAPTURE = textwrap.dedent("""
    import json, sys
    from collections import Counter
    import torch
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core import capture_sharded_step, capture_step, fake_mode
    from repro_torch.models import Model
    from repro_torch.parallel import sharding
    from repro_torch.parallel.mesh import fake_process_group, make_mesh
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import init_train_state, make_eval_step, make_train_step

    torch.set_num_threads(1)
    arch, B, S = sys.argv[1], %d, %d

    def capture(cfg, mesh_shape, what):
        par = ParallelConfig(remat="dots" if what == "eval" else what)
        with fake_process_group(8):
            mesh = make_mesh(mesh_shape, ("data", "model"), "cpu")
            with fake_mode():
                model = Model(cfg, device="cpu", trainable=what != "eval", abstract=True)
                sharding.shard_model(model, mesh, par)
                tok = torch.empty(B, S, dtype=torch.long)
                batch = sharding.shard_inputs({"tokens": tok, "labels": tok},
                                              sharding.batch_specs(model, "train", B, S),
                                              mesh, par)
                if what == "eval":
                    cap = capture_sharded_step(make_eval_step(model, par, mesh), model, [batch])
                    refused = ""
                else:
                    state = init_train_state(model)
                    step = make_train_step(model, OptConfig(), par, mesh)
                    cap = capture_sharded_step(step, model, [state, batch])
                    try:
                        capture_step(step, (state, batch))
                        refused = ""
                    except ValueError as e:
                        refused = str(e)
        g, s = cap.graph, cap.summary
        g.validate()
        by_op = Counter()
        for n in g.nodes:
            if n.attrs.get("flops"):
                by_op[n.attrs["op"].split(".")[1]] += int(n.attrs["flops"])
        return {"flops": s["parsed_flops"], "by_op": dict(by_op),
                "kernel_nodes": s["kernel_nodes"],
                "comm": {k: v["count"] for k, v in s["comm"].items()},
                "comm_bytes": {k: v["bytes"] for k, v in s["comm"].items()},
                "groups": sorted({len(c["group"]) for c in s["collectives"]}),
                "world": cap.meta["world_size"], "refused": refused}

    cfg = get_config(arch, smoke=True)
    out = {}
    for mesh_shape in ((2, 4), (4, 2)):
        for what in ("eval", "dots", "none"):
            out[f"{mesh_shape}/{what}"] = capture(cfg, mesh_shape, what)
    out["(2, 4)/full"] = capture(cfg, (2, 4), "full")
    # depth: 1, 2 and 4 repeats of the superblock, no remainder
    nsb = len(cfg.superblock)
    for r in %r:
        c = cfg.replace(num_layers=r * nsb, sb_repeat=r, remainder=())
        out[f"depth {r}"] = capture(c, (2, 4), "dots")
    print(json.dumps(out))
""") % (B, S, DEPTHS)


def _run(code, arch, devices=None):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, os.environ.get("PYTHONPATH", "")]))
    if devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    return subprocess.Popen([sys.executable, "-c", code, arch], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


_cache = {}


def _captures(arch):
    """(JAX captures, port captures) of ``arch``; the four processes, JAX's
    and the port's for each arch, start together at the first call."""
    if not _cache:
        procs = {(a, side): _run(code, a, devices)
                 for a in ARCHS for side, code, devices in (("jax", JAX_CAPTURE, 8),
                                                            ("port", PORT_CAPTURE, None))}
        for key, proc in procs.items():
            out, err = proc.communicate(timeout=900)
            assert proc.returncode == 0, err[-4000:]
            _cache[key] = json.loads(out.strip().splitlines()[-1])
    return _cache[arch, "jax"], _cache[arch, "port"]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("arch", ARCHS)
def test_rank0_train_capture_flops_match_the_jax_capture(arch, mesh):
    jax_caps, port_caps = _captures(arch)
    je, jt, jn = (jax_caps[f"{mesh}/{w}"] for w in ("eval", "dots", "none"))
    pe, pt = port_caps[f"{mesh}/eval"], port_caps[f"{mesh}/dots"]
    assert je["partitions"] == jt["partitions"] == pt["world"] == 8
    cfg = get_config(arch, smoke=True)
    k1 = pe["by_op"]["flash_attention_fwd"]
    k1_remat = k1 * len(cfg.superblock) * cfg.sb_repeat // cfg.num_layers
    # the port: three times its forward's weight products, K1's forward, its
    # recompute in the rematted layers and its backward (2.5 times the
    # forward), nothing else
    assert pt["by_op"] == {"bmm": 3 * pe["by_op"]["bmm"],
                           "flash_attention_fwd_lse": k1 + k1_remat,
                           "flash_attention_bwd": 5 * k1 // 2}, pt["by_op"]
    # the JAX step: its backward's attention products twice the forward's
    assert jn["attention"] == 3 * je["attention"]
    recompute = jt["attention"] - jn["attention"]
    attention = 3 * (je["attention"] - k1) + recompute - k1_remat - k1 // 2
    # the JAX step's q, k and v products: the even split and kv_gap more
    products = jt["qkv"] - qkv_even(cfg, mesh)
    assert products == kv_gap(cfg, mesh), (products, kv_gap(cfg, mesh))
    assert jt["flops"] - jt["attention"] == 3 * pe["by_op"]["bmm"] + products
    print(arch, mesh, "rank 0's train step FLOPs: JAX", jt["flops"], "port", pt["flops"],
          "gap: attention", attention, "(forward's", je["attention"] - k1, "x 3, remat",
          recompute, "- K1's", k1_remat, ", K1's backward", -k1 // 2, ") + k/v products",
          products,
          "| collectives: JAX", jt["comm"], "port", pt["comm"])
    assert jt["flops"] - pt["flops"] == attention + products


@pytest.mark.parametrize("arch", ARCHS)
def test_the_jax_k_v_product_gap_holds_its_formula_at_a_second_depth(arch):
    jax_caps, _ = _captures(arch)
    cfg = deeper(get_config(arch, smoke=True))
    j = jax_caps["(2, 4)/dots deeper"]
    assert j["partitions"] == 8
    print(arch, cfg.num_layers, "layers on (2, 4): the JAX step's q, k and v products",
          j["qkv"], "= the even split", qkv_even(cfg, (2, 4)), "+", kv_gap(cfg, (2, 4)))
    assert j["qkv"] - qkv_even(cfg, (2, 4)) == kv_gap(cfg, (2, 4)) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_rank0_train_capture_has_one_k1_and_one_k1_backward_node_a_layer(arch):
    _, port_caps = _captures(arch)
    cfg = get_config(arch, smoke=True)
    L = cfg.num_layers
    rematted = len(cfg.superblock) * cfg.sb_repeat
    for mesh in MESHES:
        for remat in ("none", "dots"):
            assert port_caps[f"{mesh}/{remat}"]["kernel_nodes"] == {
                "flash_attention_bwd": L,
                "flash_attention_fwd_lse": L + (rematted if remat == "dots" else 0)}, (mesh, remat)
    assert port_caps["(2, 4)/full"]["kernel_nodes"] == {
        "flash_attention_bwd": L, "flash_attention_fwd_lse": L + rematted}


@pytest.mark.parametrize("arch", ARCHS)
def test_rank0_train_capture_collectives_are_linear_in_depth(arch):
    _, port_caps = _captures(arch)
    nsb = len(get_config(arch, smoke=True).superblock)
    caps = [port_caps[f"depth {r}"] for r in DEPTHS]
    for c, r in zip(caps, DEPTHS):
        assert c["kernel_nodes"] == {"flash_attention_bwd": r * nsb,
                                     "flash_attention_fwd_lse": 2 * r * nsb}
        assert c["groups"] == [2, 4]            # over the data and the model axis
        assert c["world"] == 8
    for kind in caps[2]["comm"]:
        for key in ("comm", "comm_bytes"):
            n1, n2, n4 = (c[key].get(kind, 0) for c in caps)
            assert n4 - n2 == 2 * (n2 - n1), (kind, key, n1, n2, n4)
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= set(caps[0]["comm"])
    f1, f2, f4 = (c["flops"] for c in caps)
    assert f4 - f2 == 2 * (f2 - f1)
    print(arch, "rank 0's collectives at", DEPTHS, "superblock repeats:",
          [c["comm"] for c in caps])


@pytest.mark.parametrize("arch", ARCHS)
def test_a_trace_of_the_train_step_over_dtensors_is_refused(arch):
    _, port_caps = _captures(arch)
    for key, c in port_caps.items():
        if not key.endswith("eval"):
            assert "counts the FLOPs of every rank" in c["refused"], key
