"""The port's MoE layer and its archs mixtral-8x7b and dbrx-132b against the
JAX package (smoke configs, CPU).

Weights come from JAX ``Model.init`` through ``bridge.from_jax_params``;
tokens and activations from a numpy seed; loss batches are the reference's
(``repro.train.make_batch``). Routing is piecewise constant, so every test
that compares outputs also holds the routing: the top-k expert ids (and in
``moe_apply`` the kept assignments) of the two packages must be equal, and a
difference fails with the layer, the token and its gate margin (the gap
between the k-th and the (k+1)-th gate). No tolerance below absorbs a flip:
a flipped choice moves an output by the size of an expert's output.

Tolerances, with their reasons (measured with one torch thread, in
brackets):
  * ``moe_apply`` in f32: out 1e-5 of max |out| (f32 summation order of the
    expert products; 5.1e-7), aux 1e-6 relative (2.3e-7), the gates 1e-6
    absolute;
  * f32 apply / prefill logits: 1e-4 absolute, against JAX with
    ``attn_impl="interpret"``. Logits are O(1), but the random init takes
    an expert weight's fan-in from its expert axis (std 1/sqrt(E), as in
    the reference), so each MoE layer adds outputs of up to ~3e2 to the
    residual stream and the final norm scales their f32 summation-order
    differences back (2.2e-5 to 3.0e-5; the dense archs' 5e-5 would leave
    too little room). The port's prefill against its own apply[:, -1]:
    1e-6 (only the last position is unembedded; 2.4e-7);
  * f32 decode logits against JAX decode: 2e-3 absolute, as for the dense
    archs: both packages keep the decode cache in bf16 and round decode's
    softmax weights to bf16, so a value on a bf16 rounding boundary can
    land one bf16 ulp apart (6.3e-4);
  * loss, ce, zloss and aux: 1e-6 relative (f32 summation order; up to
    2.4e-7), against ``jax.value_and_grad`` of ``Model.loss`` with
    ``attn_impl="xla"``;
  * every gradient leaf, relative to that leaf's max |grad|: 3e-4, because
    the smoke gradient is ill-conditioned in f32 (the large MoE outputs
    above): the port's own f32 gradient is up to 1.5e-4 from its f64
    gradient and JAX's up to 1.2e-4 from it, as far as the two packages
    are from each other (up to 1.5e-4);
  * remat none, dots and full: tests/test_torch_train_parity.py (1e-6).
Decode is held against the JAX package's decode, not against a full
forward: a prefill of 96 tokens routes them into C = 60 slots an expert and
drops assignments, while decode's 2 tokens never drop (C = 8), so the two
compute different functions by design (the reference skips mixtral's
decode-vs-forward test, tests/test_models.py:65-68).
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.models import Ctx as JCtx, build_model as jax_build  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.train import DataConfig as JDataConfig, make_batch as jax_batch  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs.registry import ARCH_NAMES, get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import Ctx, Model  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models import moe  # noqa: E402

ARCHS = ("mixtral-8x7b", "dbrx-132b")
S, N_DEC, CACHE_LEN = 48, 8, 64      # S > mixtral's smoke window 32: the ring is live
SEQ, BATCH = 48, 2                   # the loss batch
JINT = JCtx(attn_impl="interpret")
OUT_RTOL, AUX_RTOL = 1e-5, 1e-6
F32_ATOL, DECODE_ATOL = 1e-4, 2e-3
LOSS_RTOL, GRAD_RTOL = 1e-6, 3e-4

_cache = {}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the suite runs in several worker processes
    at once (restored after, for the other files a worker runs)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree, dtype=None):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x if dtype is None else x.astype(dtype)), tree)


def _jax_side(arch):
    """(JAX config, model, bf16 params from Model.init, tokens), once per arch."""
    key = ("jax", arch)
    if key not in _cache:
        jcfg = jax_config(arch, smoke=True)
        jm = jax_build(jcfg)
        params = jm.init(jax.random.PRNGKey(0))
        tokens = np.random.RandomState(1).randint(0, jcfg.vocab_size, (2, S + N_DEC))
        _cache[key] = jcfg, jm, params, tokens
    return _cache[key]


def _port(arch, params, dtype, trainable=False):
    cfg = get_config(arch, smoke=True)
    m = Model(cfg, device="cpu", trainable=trainable)
    m.load_state_dict(from_jax_params(_np(params, dtype), cfg, device="cpu"),
                      strict=True, assign=True)
    return m


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# routing: the reference's tables, and a flip's report
# ---------------------------------------------------------------------------

def _jax_routing(x, router, cfg):
    """(gates, top-k ids, keep) of the reference's moe_apply on x (B,S,D) in
    one group: its lines that compute them (repro/models/moe.py:44-66),
    restated to read the tables that it does not return."""
    B, S_, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    T = B * S_
    C = jax_moe.capacity(T, E, K, cfg.capacity_factor)
    xt = jnp.asarray(x).reshape(1, T, D)
    gates = jax.nn.softmax(jnp.einsum("gtd,de->gte", xt.astype(jnp.float32),
                                      jnp.asarray(router)), axis=-1)
    _, top_i = jax.lax.top_k(gates, K)
    flat_e = top_i.reshape(1, -1)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=1) - onehot
    pos = jnp.take_along_axis(pos, flat_e[..., None], axis=2)[..., 0]
    return np.asarray(gates), np.asarray(top_i), np.asarray(pos < C)


def _assert_same_choices(got, want, gates, k, what):
    """Top-k ids equal; else fail with each differing token's gate margin."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bad = np.argwhere((got != want).any(-1))
    if len(bad):
        lines = []
        for idx in bad[:5]:
            g = np.sort(np.asarray(gates)[tuple(idx)])[::-1]
            lines.append(f"token {tuple(int(i) for i in idx)}: port {got[tuple(idx)]}, "
                         f"JAX {want[tuple(idx)]}, gate margin {g[k - 1] - g[k]:.3g}")
        pytest.fail(f"{what}: {len(bad)} routing flips; " + "; ".join(lines))


@contextlib.contextmanager
def _recorded_moe_inputs():
    """Record the input x of every MoE layer the JAX model runs (through
    jax.debug.callback, in order, also inside its scan over layers) and
    every routing the port computes: yields (JAX inputs, port routings)."""
    jax_in, port = [], []
    jax_apply, port_route = jax_moe.moe_apply, moe.route

    def jax_wrapped(p, x, cfg, ctx):
        jax.debug.callback(lambda v, r: jax_in.append((np.asarray(v), np.asarray(r))),
                           x, p["router"], ordered=True)
        return jax_apply(p, x, cfg, ctx)

    def port_wrapped(router, xt, cfg, cap):
        r = port_route(router, xt, cfg, cap)
        port.append(r)
        return r

    jax_moe.moe_apply, moe.route = jax_wrapped, port_wrapped
    try:
        yield jax_in, port
    finally:
        jax_moe.moe_apply, moe.route = jax_apply, port_route


def _assert_model_routing_equal(jax_in, port, cfg, what):
    """Each layer's top-k ids in the port against the reference's on the
    input its own model gave that layer."""
    assert len(jax_in) == len(port) > 0, (what, len(jax_in), len(port))
    for layer, ((x, router), r) in enumerate(zip(jax_in, port)):
        gates, top_i, _ = _jax_routing(x, router, cfg)
        _assert_same_choices(r.top_i.numpy(), top_i, gates, cfg.experts_per_token,
                             f"{what}, MoE call {layer}")


# ---------------------------------------------------------------------------
# the configs and the bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_jax(arch, smoke):
    """Every field of the port's copy holds the reference's value, and the
    analytic parameter count agrees."""
    assert arch in ARCH_NAMES
    got, want = get_config(arch, smoke=smoke), jax_config(arch, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_loads_every_moe_leaf_bit_exact(arch):
    """Every JAX leaf lands once, bit for bit, as layers.N.moe.{router, wi,
    wg, wo} for the MoE leaves: the router in f32, the experts in bf16."""
    jcfg, _, params, _ = _jax_side(arch)
    m = _port(arch, params, None)
    state = m.state_dict()
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    assert sum(t.numel() for t in state.values()) == sum(x.size for _, x in leaves)
    assert sum(p.numel() for p in m.parameters()) == jcfg.param_count()
    n_moe = 0
    for path, leaf in leaves:
        keys = [k.key for k in path]
        if "moe" not in keys:
            continue
        assert keys[:3] == ["blocks", "sb", "slot0"], keys
        for r in range(jcfg.sb_repeat):
            name = f"layers.{r}." + ".".join(keys[3:])
            t, want = state[name], np.asarray(leaf)[r]
            assert t.shape == want.shape, name
            if keys[-1] == "router":
                assert t.dtype == torch.float32 and want.dtype == np.float32, name
                np.testing.assert_array_equal(t.numpy(), want, err_msg=name)
            else:
                assert t.dtype == torch.bfloat16, name
                np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                              want.view(np.uint16), err_msg=name)
            n_moe += 1
    assert n_moe == 4 * jcfg.num_layers


def test_capacity_matches_reference():
    for tokens in (1, 2, 4, 7, 96, 100, 2048, 8192, 8196, 16384):
        for e in (4, 8, 16):
            for k in (1, 2, 4):
                for cf in (0.5, 1.0, 1.25, 2.0, e / k):
                    assert moe.capacity(tokens, e, k, cf) == \
                        jax_moe.capacity(tokens, e, k, cf), (tokens, e, k, cf)


def test_moe_specs_match_reference():
    cfg = get_config("dbrx-132b")
    got, want = moe.moe_specs(cfg), jax_moe.moe_specs(jax_config("dbrx-132b"))
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert str(got[k].dtype).split(".")[-1] == np.dtype(want[k].dtype).name, k


# ---------------------------------------------------------------------------
# moe_apply against the JAX moe_apply, f32
# ---------------------------------------------------------------------------

# (arch, config change). The smoke configs of both archs route 4 experts
# top-2; dbrx's own 16 top-4 is a case of its own. The port routes a call's
# tokens as one group, as the JAX package does with moe_groups 1 (its
# default, and its value on one device)
MOE_CASES = {
    "mixtral-cf1.25": ("mixtral-8x7b", {}),
    "dbrx-E16-k4": ("dbrx-132b", {"num_experts": 16, "experts_per_token": 4}),
    "mixtral-cf0.5-drops": ("mixtral-8x7b", {"capacity_factor": 0.5}),
    "dbrx-cf0.5-drops": ("dbrx-132b", {"capacity_factor": 0.5}),
    "mixtral-gelu": ("mixtral-8x7b", {"act": "gelu"}),
}


def _moe_layer_params(arch, change):
    """f32 MoE weights: layer 0 of the JAX Model.init, or, where the change
    resizes the experts, drawn from a numpy seed at the init's scale
    (1/sqrt(fan-in), the fan-in of an expert weight being E)."""
    if "num_experts" not in change:
        _, _, params, _ = _jax_side(arch)
        return jax.tree_util.tree_map(lambda a: a[0].astype(jnp.float32),
                                      params["blocks"]["sb"]["slot0"]["moe"])
    cfg = get_config(arch, smoke=True).replace(**change)
    rng = np.random.RandomState(5)
    return {k: jnp.asarray(rng.randn(*s.shape).astype(np.float32) / np.sqrt(s.shape[0]))
            for k, s in moe.moe_specs(cfg).items()}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_matches_jax(case):
    """Top-k ids and kept assignments equal; out within 1e-5 of max |out|
    and aux within 1e-6, in f32 on an activation from a numpy seed. At cf
    0.5 some assignments must drop."""
    arch, change = MOE_CASES[case]
    jcfg = jax_config(arch, smoke=True).replace(**change)
    cfg = get_config(arch, smoke=True).replace(**change)
    jp = _moe_layer_params(arch, change)
    x = np.random.RandomState(3).randn(2, S, cfg.d_model).astype(np.float32)
    want, want_aux = jax_moe.moe_apply(jp, jnp.asarray(x), jcfg, JCtx())
    gates, top_i, keep = _jax_routing(x, jp["router"], jcfg)

    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    routes = []
    port_route = moe.route

    def recording(*a):
        routes.append(port_route(*a))
        return routes[-1]

    moe.route = recording
    try:
        got, got_aux = moe.moe_apply(tp, torch.from_numpy(x), cfg)
    finally:
        moe.route = port_route
    (r,) = routes
    _assert_same_choices(r.top_i.numpy(), top_i, gates, cfg.experts_per_token, case)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_allclose(r.gates.numpy(), gates, rtol=0, atol=1e-6)
    assert r.top_i.shape[:2] == (1, 2 * S)
    if "drops" in case:
        assert not keep.all() and keep.any()
    assert got.shape == x.shape and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= OUT_RTOL
    assert abs(got_aux.item() - float(want_aux)) <= AUX_RTOL * abs(float(want_aux))


# ---------------------------------------------------------------------------
# dispatch groups: moe_apply with Ctx(moe_groups=G) against the JAX layer
# ---------------------------------------------------------------------------

# T = 2 x 48 = 96 tokens: 1, 2 and 4 groups of 96, 48 and 24 tokens, each
# with its own capacity (at cf 0.5: 24, 16 and 8 slots an expert, so other
# assignments drop); 5 groups do not divide 96, and the layer routes one
GROUPED_CASES = ("mixtral-cf0.5-drops", "dbrx-E16-k4")
GROUPS = (1, 2, 4, 5)


def _parent_moe_apply(p, x, cfg):
    """The port's moe_apply as it was before dispatch groups (every call's
    tokens one group), restated line for line: the layer that moe_groups 1
    must reproduce bit for bit."""
    B, S_, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    G, Tg = 1, B * S_
    C = moe.capacity(Tg, E, K, cfg.capacity_factor)
    xt = x.reshape(G, Tg, D)
    r = moe.route(p["router"], xt, cfg, C)
    density = torch.nn.functional.one_hot(r.top_i[..., 0], E).float().mean(dim=(0, 1))
    aux = E * (density * r.gates.mean(dim=(0, 1))).sum()
    tok_of = (torch.arange(Tg * K, device=x.device) // K).expand(G, -1)
    slot_safe = torch.where(r.keep, r.slot, E * C)
    idx = torch.zeros((G, E * C + 1), dtype=torch.int64, device=x.device)
    idx = idx.scatter_(1, slot_safe, tok_of)[:, :-1]
    valid = torch.zeros((G, E * C + 1), dtype=torch.bool, device=x.device)
    valid = valid.scatter_(1, slot_safe, r.keep)[:, :-1]
    xg = xt.gather(1, idx[..., None].expand(-1, -1, D)).reshape(G, E, C, D)
    xg = xg * valid.reshape(G, E, C, 1).to(xg.dtype)
    h = torch.einsum("gecd,edf->gecf", xg, p["wi"])
    g = torch.einsum("gecd,edf->gecf", xg, p["wg"])
    g = (torch.nn.functional.silu(g) if cfg.act == "silu"
         else torch.nn.functional.gelu(g, approximate="tanh"))
    y = torch.einsum("gecf,efd->gecd", h * g, p["wo"])
    read = torch.where(r.keep, r.slot, 0)
    yt = y.reshape(G, E * C, D).gather(1, read[..., None].expand(-1, -1, D))
    yt = yt * r.keep[..., None].to(yt.dtype)
    out = (yt.reshape(G, Tg, K, D) * r.top_w.reshape(G, Tg, K, 1).to(yt.dtype)).sum(dim=2)
    return out.reshape(B, S_, D), aux


@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("case", GROUPED_CASES)
def test_grouped_moe_apply_matches_jax(case, groups):
    """The port's moe_apply with Ctx(moe_groups=G) against the JAX moe_apply
    with Ctx(moe_groups=G), f32: each group routed with its own capacity
    (top-k ids and kept assignments equal to the reference's lines run on
    that group alone), out within 1e-5 of max |out| and aux within 1e-6;
    where G does not divide the tokens, one group."""
    arch, change = MOE_CASES[case]
    jcfg = jax_config(arch, smoke=True).replace(**change)
    cfg = get_config(arch, smoke=True).replace(**change)
    jp = _moe_layer_params(arch, change)
    x = np.random.RandomState(3).randn(2, S, cfg.d_model).astype(np.float32)
    want, want_aux = jax_moe.moe_apply(jp, jnp.asarray(x), jcfg, JCtx(moe_groups=groups))
    G = groups if (2 * S) % groups == 0 else 1
    per_group = [_jax_routing(xg[None], jp["router"], jcfg)
                 for xg in x.reshape(G, -1, cfg.d_model)]

    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    routes = []
    port_route = moe.route

    def recording(*a):
        routes.append(port_route(*a))
        return routes[-1]

    moe.route = recording
    try:
        got, got_aux = moe.moe_apply(tp, torch.from_numpy(x), cfg, Ctx(moe_groups=groups))
    finally:
        moe.route = port_route
    (r,) = routes
    Tg = 2 * S // G
    assert r.top_i.shape[:2] == (G, Tg) and r.keep.shape == (G, Tg * cfg.experts_per_token)
    for i, (gates, top_i, keep) in enumerate(per_group):
        _assert_same_choices(r.top_i[i:i + 1].numpy(), top_i, gates, cfg.experts_per_token,
                             f"{case}, group {i} of {G}")
        np.testing.assert_array_equal(r.keep[i:i + 1].numpy(), keep)
    if "drops" in case:
        assert not r.keep.all()
    assert got.shape == x.shape and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= OUT_RTOL
    assert abs(got_aux.item() - float(want_aux)) <= AUX_RTOL * abs(float(want_aux))


def test_dispatch_groups_route_with_their_own_capacity():
    """At cf 0.5 one, two and four groups keep different assignments: each
    group counts the positions in an expert from its own first token."""
    arch, change = MOE_CASES["mixtral-cf0.5-drops"]
    cfg = get_config(arch, smoke=True).replace(**change)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in _moe_layer_params(arch, change).items()}
    x = torch.from_numpy(np.random.RandomState(3).randn(2, S, cfg.d_model).astype(np.float32))
    kept = {}
    port_route = moe.route

    def recording(router, xt, cfg_, cap):
        r = port_route(router, xt, cfg_, cap)
        kept[xt.shape[0]] = (cap, r.keep.reshape(-1))
        return r

    moe.route = recording
    try:
        outs = {g: moe.moe_apply(tp, x, cfg, Ctx(moe_groups=g))[0] for g in (1, 2, 4)}
    finally:
        moe.route = port_route
    assert [kept[g][0] for g in (1, 2, 4)] == [24, 16, 8]
    assert not torch.equal(kept[1][1], kept[2][1]) and not torch.equal(kept[2][1], kept[4][1])
    assert not torch.equal(outs[1], outs[2]) and not torch.equal(outs[2], outs[4])


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_one_group_is_bit_equal_to_the_ungrouped_layer(case):
    """moe_apply with moe_groups 1 (and with no ctx) computes exactly what
    the layer computed before dispatch groups: out, aux and the gradients of
    x and of every weight bit for bit."""
    arch, change = MOE_CASES[case]
    cfg = get_config(arch, smoke=True).replace(**change)
    jp = _moe_layer_params(arch, change)
    x0 = torch.from_numpy(np.random.RandomState(3).randn(2, S, cfg.d_model).astype(np.float32))
    dy = torch.from_numpy(np.random.RandomState(4).randn(2, S, cfg.d_model).astype(np.float32))

    def run(fn):
        p = {k: torch.from_numpy(np.array(v)).requires_grad_() for k, v in jp.items()}
        x = x0.clone().requires_grad_()
        out, aux = fn(p, x)
        ((out * dy).sum() + aux).backward()
        return [out, aux, x.grad] + [p[k].grad for k in sorted(p)]

    want = run(lambda p, x: _parent_moe_apply(p, x, cfg))
    for ctx in (Ctx(), Ctx(moe_groups=1), None):
        got = run(lambda p, x: moe.moe_apply(p, x, cfg, ctx))
        for g, w in zip(got, want):
            assert torch.equal(g, w), (case, ctx)


def test_moe_apply_bf16_keeps_activation_dtype():
    """bf16 experts and activations: the router still runs in f32 (its
    gates are f32), and out is bf16 like x; aux is f32."""
    cfg = get_config("mixtral-8x7b", smoke=True)
    _, _, params, _ = _jax_side("mixtral-8x7b")
    p = {k: torch.from_numpy(np.array(v[0].astype(jnp.float32))).to(
        torch.float32 if k == "router" else torch.bfloat16)
        for k, v in params["blocks"]["sb"]["slot0"]["moe"].items()}
    x = torch.from_numpy(np.random.RandomState(4).randn(2, S, cfg.d_model)).to(torch.bfloat16)
    out, aux = moe.moe_apply(p, x, cfg)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    assert aux.dtype == torch.float32 and aux.dim() == 0 and torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# serving against JAX, f32
# ---------------------------------------------------------------------------

def _runs(arch):
    """{apply, prefill, decode0..}: f32 logits of JAX and of the port on the
    same weights, each with the routing of every MoE call it made."""
    key = ("runs", arch)
    if key not in _cache:
        jcfg, jm, params, tokens = _jax_side(arch)
        jp = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), params)
        jt = jnp.asarray(tokens)
        m = _port(arch, params, np.float32)
        t = torch.from_numpy(tokens)
        want, got, routing = {}, {}, {}
        with torch.inference_mode():
            with _recorded_moe_inputs() as (ji, pr):
                want["apply"] = jm.apply(jp, jt[:, :S], JINT)[0]
                got["apply"] = m.apply(t[:, :S])
            routing["apply"] = ji, pr
            with _recorded_moe_inputs() as (ji, pr):
                want["prefill"], jcache = jm.prefill(jp, jt[:, :S], JINT, CACHE_LEN)
                got["prefill"], cache = m.prefill(t[:, :S], CACHE_LEN)
            routing["prefill"] = ji, pr
            got["apply_last"] = got["apply"][:, -1]
            for i in range(N_DEC):
                with _recorded_moe_inputs() as (ji, pr):
                    want[f"decode{i}"], jcache = jm.decode_step(
                        jp, jt[:, S + i:S + i + 1], jcache, JINT)
                    got[f"decode{i}"], cache = m.decode_step(t[:, S + i:S + i + 1], cache)
                routing[f"decode{i}"] = ji, pr
        assert cache["pos"] == S + N_DEC
        _cache[key] = ({k: np.asarray(v, np.float32) for k, v in want.items()},
                       {k: v.float().numpy() for k, v in got.items()}, routing)
    return _cache[key]


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_apply_and_prefill_match_jax(arch):
    want, got, routing = _runs(arch)
    cfg = get_config(arch, smoke=True)
    for what in ("apply", "prefill"):
        _assert_model_routing_equal(*routing[what], cfg, what)
    np.testing.assert_allclose(got["apply"], want["apply"], atol=F32_ATOL)
    np.testing.assert_allclose(got["prefill"], want["prefill"], atol=F32_ATOL)
    np.testing.assert_allclose(got["prefill"], got["apply_last"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_decode_matches_jax_decode(arch):
    """Each decode step's logits against the reference's decode_step from
    its own prefill, and the top-k ids of every MoE layer at each decode
    token equal."""
    want, got, routing = _runs(arch)
    cfg = get_config(arch, smoke=True)
    for i in range(N_DEC):
        _assert_model_routing_equal(*routing[f"decode{i}"], cfg, f"decode step {i}")
        assert len(routing[f"decode{i}"][1]) == cfg.num_layers
        np.testing.assert_allclose(got[f"decode{i}"], want[f"decode{i}"], atol=DECODE_ATOL,
                                   err_msg=f"decode step {i}")


# ---------------------------------------------------------------------------
# training against JAX
# ---------------------------------------------------------------------------

def _loss_and_grads(arch):
    """(JAX loss and metrics, its gradient as the port's flat dict, the
    port's loss and metrics, the port's model after backward) in f32 on the
    reference's batch, with the routing of both forwards."""
    key = ("loss", arch)
    if key not in _cache:
        jcfg, jm, params, _ = _jax_side(arch)
        p32 = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), params)
        batch = jax_batch(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=SEQ,
                                      global_batch=BATCH), 0)
        m = _port(arch, params, np.float32, trainable=True)
        with _recorded_moe_inputs() as (ji, pr):
            (jl, jmet), jg = jax.value_and_grad(
                lambda p, b: jm.loss(p, b, JCtx(attn_impl="xla")), has_aux=True)(p32, batch)
            tl, tmet = m.loss({k: torch.from_numpy(np.array(v)).long()
                               for k, v in batch.items()})
        tl.backward()
        cfg = get_config(arch, smoke=True)
        _cache[key] = (float(jl), {k: float(v) for k, v in jmet.items()},
                       from_jax_params(_np(jg), cfg, device="cpu"), tl.item(),
                       {k: v.item() for k, v in tmet.items()}, m, (ji, pr))
    return _cache[key]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_jax(arch):
    """total = ce + zloss + 0.01 aux, each against the reference's, with
    the routing of every layer equal."""
    jl, jmet, _, tl, tmet, _, routing = _loss_and_grads(arch)
    _assert_model_routing_equal(*routing, get_config(arch, smoke=True), "loss forward")
    assert abs(tl - jl) <= LOSS_RTOL * abs(jl)
    for key in ("ce", "zloss", "ntok", "aux"):
        assert abs(tmet[key] - jmet[key]) <= LOSS_RTOL * abs(jmet[key]), key
    assert tmet["aux"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_every_gradient_leaf_matches_jax(arch):
    """Every leaf, the router's and the experts' included, within 3e-4 of
    its max |grad|."""
    _, _, jg, _, _, m, _ = _loss_and_grads(arch)
    names = dict(m.named_parameters())
    assert names.keys() == jg.keys()
    assert any(k.endswith(".moe.router") for k in names)
    for k, p in names.items():
        assert p.grad is not None and p.grad.shape == jg[k].shape, k
        assert torch.isfinite(p.grad).all(), k
        err = _rel(p.grad.numpy(), jg[k].numpy())
        assert err <= GRAD_RTOL, (k, err)


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_adds_aux_summed_over_layers(arch):
    """Model.loss's aux is the sum of every layer's moe_apply aux, and its
    total is ce + zloss + 0.01 aux."""
    cfg = get_config(arch, smoke=True)
    m = Model(cfg, device="cpu", seed=0)
    t = torch.from_numpy(np.random.RandomState(2).randint(0, cfg.vocab_size, (2, 40)))
    per_layer, apply = [], moe.moe_apply

    def recording(*a):
        out, aux = apply(*a)
        per_layer.append(aux.item())
        return out, aux

    moe.moe_apply = recording
    try:
        total, met = m.loss({"tokens": t, "labels": t})
    finally:
        moe.moe_apply = apply
    assert len(per_layer) == cfg.num_layers
    assert met["aux"].item() == pytest.approx(sum(per_layer), rel=1e-6)
    assert total.item() == pytest.approx(
        (met["ce"] + met["zloss"] + 0.01 * met["aux"]).item(), rel=1e-6)
    logits, aux = m.apply(t, return_aux=True)
    assert aux.item() == pytest.approx(sum(per_layer), rel=1e-6)
    torch.testing.assert_close(logits, m.apply(t), rtol=0, atol=0)


def test_dots_policy_keeps_the_router_product_and_recomputes_the_experts(monkeypatch):
    """Under remat dots the router's product (a bmm with a batch of one, no
    batch dimension in JAX's terms) is kept and the expert products (bmm
    over the expert batch) are recomputed, as JAX's
    checkpoint_dots_with_no_batch_dims does."""
    cfg = get_config("mixtral-8x7b", smoke=True)
    E, D, F_ = cfg.num_experts, cfg.d_model, cfg.d_ff
    decisions = []
    policy = model_mod._save_weight_products

    def recording(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        if op is torch.ops.aten.bmm.default:
            decisions.append((tuple(args[0].shape), tuple(args[1].shape), out))
        return out

    monkeypatch.setattr(model_mod, "_save_weight_products", recording)
    m = Model(cfg, device="cpu", seed=0, trainable=True)
    t = torch.from_numpy(np.random.RandomState(2).randint(0, cfg.vocab_size, (2, 40)))
    loss, _ = m.loss({"tokens": t, "labels": t}, Ctx(remat="dots"))
    loss.backward()
    save, recompute = (torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE,
                       torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)
    router = [d for a, b, d in decisions if b == (1, D, E)]
    experts = [d for a, b, d in decisions if a[0] == E and b in ((E, D, F_), (E, F_, D))]
    assert router and set(router) == {save}
    assert len(experts) >= 3 * cfg.num_layers and set(experts) == {recompute}


# ---------------------------------------------------------------------------
# the entry points on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_runs_on_the_cpu(arch, capsys):
    toks = serve.main(["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "40",
                       "--steps", "5", "--device", "cpu"])
    assert toks.shape == (2, 5) and toks.dtype == torch.int64
    assert 0 <= int(toks.min()) and int(toks.max()) < get_config(arch, smoke=True).vocab_size
    assert "[serve] prefill 2x40 on cpu" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_runs_on_the_cpu(arch, tmp_path):
    """launch/train.py --smoke --device cpu: the MoE layers train, with the
    aux loss in the loss."""
    log = launch_train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "3",
                             "--seq-len", "40", "--batch", "2", "--log-every", "1",
                             "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"])
    assert [m["step"] for m in log] == [0, 1, 2]
    assert all(np.isfinite(m["loss"]) for m in log)
