"""recurrentgemma-9b's serving path under a mesh against the JAX package's
sharded steps (smoke config, CPU, 8 ranks).

The smoke config (d_model 64, rnn_width 64, 4 q heads over 1 kv head, 5
layers: one superblock (RG-LRU, RG-LRU, local) and the (RG-LRU, RG-LRU)
remainder) on meshes (2, 4), (4, 2) and (1, 8) over ("data", "model") under
the default rules (tp, fsdp, sequence parallel); zero3 on (2, 4) and a
``seq_shard_cache`` run at B 1 on (2, 4) are
tests/test_torch_mesh_rglru_modes.py's. The same f32 weights (``Model.init``
through ``bridge.from_jax_params``) and numpy-seeded tokens and labels (B 4
x S 48) go through the JAX forward, eval, prefill (cache of 64) and decode
steps jitted with the rules' shardings on 8 fake CPU devices (decode with
``launch/specs.py``'s decode in_shardings), and through the port's sharded
steps, every rank simulated in one process (``simulated_ranks``).

Held here:
  * the forward's last-position logits, the prefill's logits and the eval
    loss against JAX at the RG-LRU rule (ROADMAP queue 3: 1e-3 of max
    |logit| in f32, relative for the loss; torch's exp and XLA's differ by
    one ulp near a = 1);
  * 3 forced decode steps after the sharded prefill against the JAX sharded
    decode at 4e-3 absolute (the bf16 cache's reach,
    tests/test_torch_mesh_decode.py's rule);
  * the prefill cache's h (1e-3 of its max) and conv history (one bf16 ulp
    plus 1e-3 of its max) of every RG-LRU layer against JAX's
    (tests/test_torch_model.py's rules);
  * the port's sharded forward, loss, prefill and decode against its own
    unsharded steps within 5e-5 of the largest value, with f32 caches: only
    the partial sums of the products change order;
  * the placements of u, a, b and h (K3's operands, placed as u, and its
    output; the block's ``ctx.shard`` constraint of h) and of both cache
    tensors against the JAX
    ``resolve_spec`` of the same logical axes and shape, and the cache's
    against the JAX decode step's cache shardings;
  * K3's plain version called once a rank a layer, on the rank's local
    (B/dp, S, dr/m) channels.

One subprocess a (mesh, mode), all of a file's started together: a process
group, LocalTensorMode and JAX's fake devices are global to a process.
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
ARCH = "recurrentgemma-9b"
CFG = get_config(ARCH, smoke=True)
B, S, C, N = 4, 48, 64, 3
RG_RTOL, DECODE_ATOL, SELF_RTOL = 1e-3, 4e-3, 5e-5
BF16_ULP = 2.0 ** -7
MESHES = ((2, 4), (4, 2), (1, 8))
IDS = {"ids": lambda m: "x".join(map(str, m))}

PARITY = textwrap.dedent("""
    import json, sys, types
    import numpy as np
    import jax, jax.numpy as jnp
    import torch
    from repro.configs.base import ParallelConfig as JParallel, ShapeConfig
    from repro.configs.registry import get_config as jax_config
    from repro.launch.specs import input_specs
    from repro.parallel import sharding as js
    from repro.parallel.mesh import make_mesh as jax_mesh, mesh_context
    from repro.train.serve_step import (make_decode_step as jax_decode,
                                        make_forward_step as jax_forward,
                                        make_prefill_step as jax_prefill)
    from repro.train.train_step import make_eval_step as jax_eval
    from repro_torch.bridge import from_jax_cache, from_jax_params
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import Model, attention, rglru
    from repro_torch.parallel import sharding
    from repro_torch.parallel.mesh import make_mesh, simulated_ranks
    from repro_torch.train.serve_step import (make_decode_step, make_forward_step,
                                              make_prefill_step)
    from repro_torch.train.train_step import make_eval_step

    torch.set_num_threads(1)
    arch = "recurrentgemma-9b"
    mesh_shape = tuple(int(n) for n in sys.argv[1].split("x"))
    mode = sys.argv[2]
    S, C, N = %d, %d, %d
    B = 1 if mode == "seq" else %d
    kw = {"zero3": {"model_axis": "zero3"}, "seq": {"seq_shard_cache": True}}.get(mode, {})
    jcfg = jax_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, jcfg.vocab_size, (B, S))
    labels = rng.randint(0, jcfg.vocab_size, (B, S))
    labels[:, -3:] = -1                                   # padding
    forced = rng.randint(0, jcfg.vocab_size, (B, N))
    RG = [i for i, k in enumerate(cfg.layer_kinds) if k == "rglru"]

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

    # -- JAX: forward, eval, prefill and decode under the mesh -------------
    jmesh = jax_mesh(mesh_shape, ("data", "model"))
    par = JParallel(**kw)
    _, (psh, tsh, csh), jm, par, _ = input_specs(jcfg, ShapeConfig("d", "decode", C, B),
                                                 jmesh, par)
    params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32),
                                    jm.init(jax.random.PRNGKey(0)))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    jp = jax.device_put(params, psh)
    rules = js.activation_rules(par)
    bsh = js.tree_shardings(jmesh, js.batch_specs(
        jcfg, types.SimpleNamespace(global_batch=B, seq_len=S, kind="train"), jm), rules)
    batch = jax.device_put({"tokens": jnp.asarray(tokens, jnp.int32),
                            "labels": jnp.asarray(labels, jnp.int32)}, bsh)
    with mesh_context(jmesh):
        want_fwd = np.asarray(jax.jit(jax_forward(jm, par, jmesh))(jp, batch["tokens"]))
        want_loss = float(jax.jit(jax_eval(jm, par, jmesh))(jp, batch)["loss"])
        lg, jcache = jax.jit(jax_prefill(jm, par, jmesh, C))(jp, batch["tokens"])
        want_pre = np.asarray(lg)
        want_cache = from_jax_cache(jax.tree_util.tree_map(np.asarray, jcache), cfg,
                                    device="cpu")["layers"]
        decode = jax.jit(jax_decode(jm, par, jmesh), in_shardings=(psh, tsh, csh))
        want_dec = []
        for i in range(N):
            lg, jcache = decode(jp, jax.device_put(jnp.asarray(forced[:, i:i + 1], jnp.int32),
                                                   tsh), jax.device_put(jcache, csh))
            want_dec.append(np.asarray(lg))
    slot = csh["blocks"]["sb"]["slot0"]["mixer"]
    jax_cache_spec = {n: trimmed(tuple(slot[n].spec)[1:]) for n in ("h", "conv")}
    dr, W = cfg.d_rnn, cfg.rglru_conv_width
    want_spec = {
        "u": trimmed(js.resolve_spec(("batch", "seq", "inner"), (B, S, dr), rules, jmesh)),
        "h": trimmed(js.resolve_spec(("batch", "inner"), (B, dr), rules, jmesh)),
        "conv": trimmed(js.resolve_spec(("batch", None, "inner"), (B, W - 1, dr), rules,
                                        jmesh)),
        "decode_u": trimmed(js.resolve_spec(("batch", "seq", "inner"), (B, 1, dr), rules,
                                            jmesh))}

    # -- the port: sharded, with its constraints and K3's calls recorded ----
    def model_of():
        model = Model(cfg, device="cpu")
        model.load_state_dict(from_jax_params(np_params, cfg, device="cpu"), strict=True,
                              assign=True)
        return model

    inner, scans, k3 = {}, [], []
    port_make, port_scan, port_k3 = sharding.make_shard_fn, rglru._local_scan, ops.rglru_scan

    def recording(mesh, parallel):
        f = port_make(mesh, parallel)

        def g(x, axes):
            out = f(x, axes)
            if axes[0] == "batch" and "inner" in axes:
                inner.setdefault(json.dumps([list(axes), list(x.shape)]), []).append(
                    port_spec(out))
            return out
        return g

    def scan(a, b):
        h = port_scan(a, b)
        scans.append([port_spec(a), port_spec(b), port_spec(h)])
        return h

    def kernel(a, b):
        k3.append([list(a.shape), len(getattr(a, "_local_tensors", {0: a}))])
        return port_k3(a, b)

    def feed(i):
        return torch.from_numpy(forced[:, i:i + 1])

    def whole(t, mode):
        t = t.full_tensor()
        with mode.disable():
            return t.reconcile().float().numpy()

    def port_sharded(record, full=True):
        # (forward, loss, prefill logits, the RG-LRU layers' prefill caches,
        # each decode step's logits, the placements of layer 0's cache, K3's
        # calls in the forward, layer 0's h after decode); without ``full``
        # the forward and the loss are left out (None)
        model = model_of()
        p = ParallelConfig(**kw)
        if record:
            sharding.make_shard_fn, rglru._local_scan, ops.rglru_scan = recording, scan, kernel
        with simulated_ranks(8) as mode:
            mesh = make_mesh(mesh_shape, ("data", "model"), "cpu")
            sharding.shard_model(model, mesh, p)
            ins = sharding.shard_inputs(
                {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)},
                sharding.batch_specs(model, "train", B, S), mesh, p)
            fwd = loss = n_fwd = None
            if full:
                fwd = whole(make_forward_step(model, parallel=p, mesh=mesh)(ins["tokens"]),
                            mode)
                n_fwd = len(k3)
                loss = float(whole(make_eval_step(model, p, mesh)(ins)["loss"], mode))
            lg, cache = make_prefill_step(model, C, parallel=p, mesh=mesh)(ins["tokens"])
            pre = whole(lg, mode)
            caches = [{n: whole(cache["layers"][i]["mixer"][n], mode) for n in ("h", "conv")}
                      for i in RG]
            sharding.make_shard_fn, rglru._local_scan, ops.rglru_scan = (
                port_make, port_scan, port_k3)
            step = make_decode_step(model, parallel=p, mesh=mesh)
            specs = sharding.batch_specs(model, "decode", B, 1)
            dec = []
            for i in range(N):
                tok = sharding.shard_inputs({"token": feed(i)}, specs, mesh, p)["token"]
                lg, cache = step(tok, cache)
                dec.append(whole(lg, mode))
            placed = {n: port_spec(cache["layers"][0]["mixer"][n]) for n in ("h", "conv")}
            decoded_h = whole(cache["layers"][0]["mixer"]["h"], mode)
        return fwd, loss, pre, caches, dec, placed, n_fwd, decoded_h

    def port_unsharded():
        model = model_of()
        with torch.no_grad():
            fwd = model.apply(torch.from_numpy(tokens))[:, -1].numpy()
            loss = float(model.loss({"tokens": torch.from_numpy(tokens),
                                     "labels": torch.from_numpy(labels)})[0])
            lg, cache = model.prefill(torch.from_numpy(tokens), C)
            pre = lg.numpy()
            # copies: decode updates the cache in place
            caches = [{n: cache["layers"][i]["mixer"][n].float().numpy().copy()
                       for n in ("h", "conv")} for i in RG]
            dec = []
            for i in range(N):
                lg, cache = model.decode_step(feed(i), cache)
                dec.append(lg.numpy())
        return fwd, loss, pre, caches, dec, cache["layers"][0]["mixer"]["h"].numpy()

    def err(a, b):
        return float(np.abs(np.asarray(a) - np.asarray(b)).max())

    def errs(a, b):
        return float(max(err(x, y) for x, y in zip(a, b)))

    def top(a):
        return float(max(np.abs(x).max() for x in a))

    fwd, loss, pre, caches, dec, placed, n_fwd, _ = port_sharded(True)
    out = {"B": B, "fwd": err(fwd, want_fwd), "fwd_max": top([want_fwd]),
           "shape": list(fwd.shape), "want_shape": list(want_fwd.shape),
           "finite": bool(all(np.isfinite(x).all() for x in [fwd, pre] + dec)),
           "loss": loss, "want_loss": want_loss,
           "pre": err(pre, want_pre), "pre_max": top([want_pre]),
           "dec": errs(dec, want_dec), "dec_max": top(want_dec),
           "cache": [{n: [err(c[n], want_cache[i]["mixer"][n].float().numpy()),
                          float(np.abs(want_cache[i]["mixer"][n].float().numpy()).max())]
                      for n in ("h", "conv")} for c, i in zip(caches, RG)],
           "cache_dtypes": [str(want_cache[i]["mixer"][n].dtype) for i in RG[:1]
                            for n in ("h", "conv")],
           "placed": placed, "jax_cache_spec": jax_cache_spec, "want_spec": want_spec,
           "inner": inner, "scans": scans, "k3": k3, "k3_forward": n_fwd,
           "layers": len(RG)}

    # the port sharded against its own unsharded steps: the forward and the
    # loss as above, the prefill and decode again with f32 caches
    attention.CACHE_DTYPE = rglru.CACHE_CONV_DTYPE = torch.float32
    ref = port_unsharded()
    got = port_sharded(False, full=False)
    out["self"] = {"fwd": err(fwd, ref[0]), "fwd_max": top([ref[0]]),
                   "loss": abs(loss - ref[1]), "loss_max": abs(ref[1]),
                   "pre": err(got[2], ref[2]), "pre_max": top([ref[2]]),
                   "cache": max(err(g[n], r[n]) for g, r in zip(got[3], ref[3]) for n in g),
                   "cache_max": max(float(np.abs(r[n]).max()) for r in ref[3] for n in r),
                   "dec": errs(got[4], ref[4]), "dec_max": top(ref[4]),
                   "decoded_h": err(got[7], ref[5]), "decoded_h_max": top([ref[5]])}
    print(json.dumps(out))
""") % (S, C, N, B)


def _run(code, *args, devices=None):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, os.environ.get("PYTHONPATH", "")]))
    if devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    return subprocess.Popen([sys.executable, "-c", code, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def run_all(cases):
    """{(mesh, mode): PARITY's results}, the cases' processes started
    together."""
    procs = {c: _run(PARITY, "x".join(map(str, c[0])), c[1], devices=8) for c in cases}
    out = {}
    for c, proc in procs.items():
        stdout, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, err[-4000:]
        out[c] = json.loads(stdout.strip().splitlines()[-1])
    return out


_results = {}


def result(mesh):
    if not _results:
        _results.update(run_all([(m, "default") for m in MESHES]))
    return _results[mesh, "default"]


# -- the checks, shared with tests/test_torch_mesh_rglru_modes.py ------------

def check_forward_and_loss(r):
    assert r["shape"] == r["want_shape"] == [r["B"], CFG.vocab_size] and r["finite"], r
    print("forward max |logit| error", r["fwd"], "of", r["fwd_max"], "; loss", r["loss"],
          "JAX", r["want_loss"])
    assert r["fwd"] <= RG_RTOL * r["fwd_max"], r
    assert abs(r["loss"] - r["want_loss"]) <= RG_RTOL * abs(r["want_loss"]), r


def check_prefill_and_cache(r):
    print("prefill max |logit| error", r["pre"], "of", r["pre_max"], "; cache", r["cache"])
    assert r["pre"] <= RG_RTOL * r["pre_max"], r
    assert r["cache_dtypes"] == ["torch.float32", "torch.bfloat16"], r
    assert len(r["cache"]) == r["layers"] == CFG.layer_kinds.count("rglru")
    for c in r["cache"]:
        (h, h_top), (conv, conv_top) = c["h"], c["conv"]
        assert h <= RG_RTOL * h_top, c
        assert conv <= (BF16_ULP + RG_RTOL) * conv_top, c


def check_decode(r):
    print("decode max |logit| error over", N, "steps", r["dec"], "of", r["dec_max"])
    assert r["dec"] <= DECODE_ATOL, r


def check_against_unsharded(r):
    s = r["self"]
    print("sharded against unsharded (f32 caches):", s)
    for k in ("fwd", "loss", "pre", "cache", "dec", "decoded_h"):
        assert s[k] <= SELF_RTOL * s[f"{k}_max"], (k, s)


def check_placements(r, mesh):
    """Every constraint of an activation the port makes with "inner" among
    its axes (h at (batch, seq, inner), the prefill cache's h and conv),
    K3's operands a and b (placed as u) and its output h, and layer 0's
    cache after decode, against the JAX resolve_spec of the same axes and
    shape; the cache against the JAX decode step's cache shardings too."""
    w = r["want_spec"]
    want = {json.dumps([["batch", "seq", "inner"], [r["B"], S, CFG.d_rnn]]): w["u"],
            json.dumps([["batch", "inner"], [r["B"], CFG.d_rnn]]): w["h"],
            json.dumps([["batch", None, "inner"], [r["B"], CFG.rglru_conv_width - 1,
                                                    CFG.d_rnn]]): w["conv"]}
    assert r["inner"].keys() == want.keys(), r["inner"].keys()
    for k, specs in r["inner"].items():
        assert all(s == want[k] for s in specs), (k, specs, want[k])
    # h, and h again as w_o's operand, each RG-LRU layer of the forward,
    # eval and prefill
    assert len(r["inner"][next(iter(want))]) == 2 * 3 * r["layers"]
    assert r["scans"] and all(s == [w["u"]] * 3 for s in r["scans"]), r["scans"]
    assert r["placed"] == {"h": w["h"], "conv": w["conv"]} == r["jax_cache_spec"], r
    print(mesh, "u, a, b, h", w["u"], "cache", r["placed"])


def check_k3_calls(r, mesh, want_u):
    """K3's plain version once a layer for all 8 ranks at once (one
    LocalTensor), on each rank's (B/dp, S, dr/m) shard; none in decode."""
    rows, chans = want_u
    assert r["k3_forward"] == r["layers"], r["k3"]
    assert len(r["k3"]) == 3 * r["layers"], r["k3"]            # forward, eval, prefill
    assert all(c == [[rows, S, chans], 8] for c in r["k3"]), r["k3"]
    print(mesh, "K3 calls", len(r["k3"]), "each on", r["k3"][0])


# what a rank holds of u (B/dp rows, dr/m channels): channels over the model
# axis, rows over the data axis
LOCAL_U = {(2, 4): (2, 16), (4, 2): (1, 32), (1, 8): (4, 8)}


@pytest.mark.parametrize("mesh", MESHES, **IDS)
def test_sharded_rglru_forward_and_loss_match_the_jax_sharded_steps(mesh):
    check_forward_and_loss(result(mesh))


@pytest.mark.parametrize("mesh", MESHES, **IDS)
def test_sharded_rglru_prefill_and_its_cache_match_the_jax_sharded_prefill(mesh):
    check_prefill_and_cache(result(mesh))


@pytest.mark.parametrize("mesh", MESHES, **IDS)
def test_sharded_rglru_decode_matches_the_jax_sharded_decode(mesh):
    check_decode(result(mesh))


@pytest.mark.parametrize("mesh", MESHES, **IDS)
def test_sharded_rglru_steps_match_the_unsharded_steps(mesh):
    check_against_unsharded(result(mesh))


@pytest.mark.parametrize("mesh", MESHES, **IDS)
def test_rglru_placements_are_the_jax_specs(mesh):
    r = result(mesh)
    check_placements(r, mesh)
    assert r["want_spec"]["u"] == (["data", None, "model"] if mesh[0] > 1
                                   else [None, None, "model"]), r["want_spec"]


@pytest.mark.parametrize("mesh", MESHES, **IDS)
def test_k3_runs_once_a_layer_on_each_ranks_local_channels(mesh):
    check_k3_calls(result(mesh), mesh, LOCAL_U[mesh])
