"""Rank 0's capture of the MoE train step under a mesh
(``core.capture_sharded_step``) against the JAX package's capture of its
sharded train step on 8 fake devices: dbrx-132b's smoke config (4 experts
top-2, every layer global) on (2, 4) over ("data", "model"), B 4 x S 48,
default ``ParallelConfig()`` (expert parallelism: one expert and one
dispatch group a rank) and ``OptConfig()``, at the smoke depth and at one
layer more.

Rank 0's ``parsed_flops`` equal the JAX per-device ``parsed_flops`` less
these gaps, each held exactly at both depths:
  * attention (tests/test_torch_mesh_capture_train.py's gap
    3 (E - K) + R - Kr - K / 2): every layer is global, so GSPMD's
    attention products are K1's forward (E = K) and remat dots recomputes
    them once (R = Kr = K): the gap is K1's backward, which computes the
    scores again, -K / 2;
  * the q, k and v products, ``kv_gap`` (the smoke config's 2 kv heads do
    not divide the 4-wide model axis): one k product's even share a
    rematted layer;
  * the router's weight gradient: each rank computes its groups' (D, E)
    partial sum whole and reduce-scatters it into the router's FSDP shards,
    where GSPMD computes only its D / dp rows of it. Gap, a layer:
    -(1 - 1 / dp) 2 (B S / dp) D E. The router's forward and its input
    gradient are the same in both: each rank computes them whole for its
    group.
The expert products are the same in both programs: the forward's (its
group's tokens through its one expert), recomputed by remat dots (their
expert dim is a batch dim in both policies), and the two backward products
of each: four times the forward's, where the port's other weight products
are three times its eval step's.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models.moe import capacity  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCH, MESH, B, S = "dbrx-132b", (2, 4), 4, 48
DEPTHS = ("smoke", "deeper")


def config(depth):
    cfg = get_config(ARCH, smoke=True)
    return cfg if depth == "smoke" else cfg.replace(num_layers=cfg.num_layers + 1,
                                                    sb_repeat=cfg.sb_repeat + 1)


def kv_gap(cfg):
    """GSPMD's q, k and v products beyond the even split over the 8 ranks
    (tests/test_torch_mesh_capture_train.py): one unit a rematted layer."""
    dp, m = MESH
    assert cfg.num_kv_heads % m and not cfg.remainder
    return 2 * B * S * cfg.d_model * cfg.num_kv_heads * cfg.head_dim // (dp * m) * cfg.num_layers


def router_gap(cfg):
    """The FLOPs by which rank 0's router weight gradient exceeds GSPMD's."""
    dp = MESH[0]
    router = 2 * (B * S // dp) * cfg.d_model * cfg.num_experts * cfg.num_layers
    return router - router // dp


def expert_forward(cfg):
    """A rank's expert products in one forward: its G / dp groups through
    its E / m experts, C slots each, three products."""
    dp, m = MESH
    E, G = cfg.num_experts, dp
    C = capacity(B * S // G, E, cfg.experts_per_token, cfg.capacity_factor)
    return 3 * 2 * (G // dp) * (E // m) * C * cfg.d_model * cfg.d_ff * cfg.num_layers


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

    arch, mesh_shape, B, S = %r, %r, %d, %d
    base = get_config(arch, smoke=True)
    deeper = base.replace(num_layers=base.num_layers + 1, sb_repeat=base.sb_repeat + 1)
    out = {}
    for cfg, depth in ((base, "smoke"), (deeper, "deeper")):
        for what in ("eval", "dots", "none")[:3 if depth == "smoke" else 2]:
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
            # the dots without op metadata: attention's (batched by heads, a
            # rank-3 result) and the experts' (one expert and one group a
            # device: rank 2)
            unnamed = {2: 0, 3: 0}
            for ins, mult, comp in walk_instructions(mod):
                f = instruction_flops(mod, ins, comp) * mult
                if f and not ins.metadata_op:
                    unnamed[len(ins.shapes[0].dims)] += f
            out[f"{depth}/{what}"] = {"flops": cap.summary["parsed_flops"],
                                      "attention": unnamed[3], "experts": unnamed[2],
                                      "partitions": cap.meta["num_partitions"]}
    print(json.dumps(out))
""") % (ARCH, MESH, B, S)

PORT_CAPTURE = textwrap.dedent("""
    import json, sys
    from collections import Counter
    import torch
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core import capture_sharded_step, fake_mode
    from repro_torch.models import Model
    from repro_torch.parallel import sharding
    from repro_torch.parallel.mesh import fake_process_group, make_mesh
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import init_train_state, make_eval_step, make_train_step

    torch.set_num_threads(1)
    arch, mesh_shape, B, S = %r, %r, %d, %d

    def capture(cfg, what):
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
                else:
                    cap = capture_sharded_step(make_train_step(model, OptConfig(), par, mesh),
                                               model, [init_train_state(model), batch])
        cap.graph.validate()
        by_op = Counter()
        for n in cap.graph.nodes:
            if n.attrs.get("flops"):
                by_op[n.attrs["op"].split(".")[1]] += int(n.attrs["flops"])
        return {"flops": cap.summary["parsed_flops"], "by_op": dict(by_op),
                "kernel_nodes": cap.summary["kernel_nodes"], "world": cap.meta["world_size"]}

    base = get_config(arch, smoke=True)
    deeper = base.replace(num_layers=base.num_layers + 1, sb_repeat=base.sb_repeat + 1)
    out = {}
    for cfg, depth in ((base, "smoke"), (deeper, "deeper")):
        for what in ("eval", "dots", "none")[:3 if depth == "smoke" else 2]:
            out[f"{depth}/{what}"] = capture(cfg, what)
    print(json.dumps(out))
""") % (ARCH, MESH, B, S)

_cache = {}


def _captures():
    """(JAX captures, port captures); both processes start at the first call."""
    if not _cache:
        env = dict(os.environ,
                   PYTHONPATH=os.pathsep.join([SRC, os.environ.get("PYTHONPATH", "")]))
        procs = {side: subprocess.Popen(
            [sys.executable, "-c", code], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=dict(env, **extra))
            for side, code, extra in (
                ("jax", JAX_CAPTURE, {"XLA_FLAGS": "--xla_force_host_platform_device_count=8"}),
                ("port", PORT_CAPTURE, {}))}
        for side, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-4000:]
            _cache[side] = json.loads(out.strip().splitlines()[-1])
    return _cache["jax"], _cache["port"]


@pytest.mark.parametrize("depth", DEPTHS)
def test_rank0_moe_train_capture_flops_match_the_jax_capture(depth):
    jax_caps, port_caps = _captures()
    cfg = config(depth)
    je, jt = (jax_caps[f"{depth}/{w}"] for w in ("eval", "dots"))
    pe, pt = (port_caps[f"{depth}/{w}"] for w in ("eval", "dots"))
    assert je["partitions"] == jt["partitions"] == pt["world"] == 8
    k1 = pe["by_op"]["flash_attention_fwd"]
    experts = expert_forward(cfg)
    # the port: its eval step's weight products three times (the forward and
    # two backward products), the experts' once more (remat dots recomputes
    # them); K1's forward and its recompute, K1's backward (2.5 x)
    assert pt["by_op"] == {"bmm": 3 * pe["by_op"]["bmm"] + experts,
                           "flash_attention_fwd_lse": 2 * k1,
                           "flash_attention_bwd": 5 * k1 // 2}, pt["by_op"]
    # the JAX step: attention as K1's forward, recomputed once, twice that
    # in the backward; the experts' products as the port's
    assert je["attention"] == k1 and jt["attention"] == 4 * k1
    assert je["experts"] == experts and jt["experts"] == 4 * experts
    gaps = {"attention": -k1 // 2, "kv": kv_gap(cfg), "router": -router_gap(cfg)}
    print(ARCH, MESH, cfg.num_layers, "layers: rank 0's train step FLOPs: JAX", jt["flops"],
          "port", pt["flops"], "gaps", gaps)
    assert jt["flops"] - pt["flops"] == sum(gaps.values())


def test_at_remat_none_nothing_is_recomputed():
    """Both programs without remat: the port's weight products three times
    its eval step's, the experts' too; GSPMD's attention and experts three
    times their forward's."""
    jax_caps, port_caps = _captures()
    pe, pn, jn = port_caps["smoke/eval"], port_caps["smoke/none"], jax_caps["smoke/none"]
    k1 = pe["by_op"]["flash_attention_fwd"]
    assert pn["by_op"] == {"bmm": 3 * pe["by_op"]["bmm"], "flash_attention_fwd_lse": k1,
                           "flash_attention_bwd": 5 * k1 // 2}, pn["by_op"]
    assert jn["attention"] == 3 * k1 and jn["experts"] == 3 * expert_forward(config("smoke"))


@pytest.mark.parametrize("depth", DEPTHS)
def test_rank0_moe_train_capture_has_one_k1_and_one_k1_backward_node_a_layer(depth):
    _, port_caps = _captures()
    L = config(depth).num_layers
    assert port_caps[f"{depth}/dots"]["kernel_nodes"] == {"flash_attention_bwd": L,
                                                          "flash_attention_fwd_lse": 2 * L}
    if depth == "smoke":
        assert port_caps["smoke/none"]["kernel_nodes"] == {"flash_attention_bwd": L,
                                                           "flash_attention_fwd_lse": L}
