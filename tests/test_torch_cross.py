"""The port's cross-attention archs, llama-3.2-vision-90b (a vlm: gated cross
layers over stub patch embeddings) and seamless-m4t-medium (an
encoder-decoder: bidirectional ``enc`` layers over stub frames, and a gated
``xattn`` sub-layer in each decoder layer), against the JAX package (smoke
configs, CPU).

Every cross gate starts at zero, where a cross layer adds exactly nothing:
the logits then do not depend on the memory and every cross and encoder
weight gets a zero gradient, so a parity test at the init passes with the
cross path wrong. Every test here sets every gate of both packages to GATE
first (``test_memory_moves_the_logits`` shows the difference).

Weights come from JAX ``Model.init`` through ``bridge.from_jax_params``;
tokens and memory from a numpy seed. The memory goes in the params' dtype
(the JAX encoder's scan carries it in that dtype).

Tolerances, those of tests/test_torch_dense.py, with their reasons:
  * attention layers: 2e-5 of the largest value of each output, against
    JAX in ``xla`` mode (non-causal attention as ``naive_attention``, which
    materialises the scores) and ``interpret`` mode (the Pallas kernel with
    ``causal=False``): f32 summation order only (3.9e-6 measured, against
    the interpret kernel's online softmax), on outputs that reach ~94
    through the JAX init's wo;
  * f32 apply / prefill logits: 5e-5 absolute, against ``interpret``;
  * f32 decode logits: 2e-3 absolute (bf16 caches, bf16 softmax weights);
  * bf16 logits: llama 0.3 (0.201 measured); seamless 0.6, because its
    smoke config is ill-conditioned in bf16 in both packages: the encoder's
    residual stream reaches ~500 on std-1 memory, one enc layer in bf16 is
    6% of its largest value from f32, and bf16 rounding alone moves the
    reference's logits by up to 0.581 from its f32 logits (0.36 in the
    port's with the gates at zero); the port's bf16 logits are up to 0.572
    from JAX's (all measured);
  * loss: 1e-6 relative, against ``jax.value_and_grad`` of ``Model.loss``
    in ``xla`` mode, the JAX trainer's path;
  * every gradient leaf: 1e-3 of that leaf's max |grad|, because with the
    gates at GATE the smoke gradient is ill-conditioned in f32: the port's
    f32 gradient is up to 1.11e-3 from its f64 gradient and JAX's up to
    1.06e-3 from it, and the two packages are up to 4.33e-4 apart
    (llama's layers.0.attn.wq; 3.01e-4 for seamless), all measured;
  * AdamW: 1e-6 of each leaf's max, as tests/test_torch_train_parity.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.models import Ctx as JCtx, attention as ja, build_model as jax_build  # noqa: E402
from repro.models.model import layer_specs as jax_layer_specs  # noqa: E402
from repro.train import DataConfig as JDataConfig, make_batch as jax_batch  # noqa: E402
from repro.train.optimizer import (OptConfig as JOptConfig,  # noqa: E402
                                   adamw_update as jax_adamw,
                                   init_opt_state as jax_init_opt)
from repro_torch.bridge import from_jax_cache, from_jax_opt_state, from_jax_params  # noqa: E402
from repro_torch.configs.registry import ARCH_NAMES, get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import Ctx, Model, attention as ta  # noqa: E402
from repro_torch.models.model import layer_specs  # noqa: E402
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.train.data import DataConfig, make_batch  # noqa: E402
from repro_torch.train.optimizer import OptConfig, adamw_update, init_opt_state  # noqa: E402
from repro_torch.train.train_step import init_train_state  # noqa: E402

LLAMA, SEAMLESS = "llama-3.2-vision-90b", "seamless-m4t-medium"
ARCHS = (LLAMA, SEAMLESS)
GATE = 0.5
S, N_DEC, CACHE_LEN = 48, 8, 64
SEQ, BATCH = 48, 2                   # the loss batch
JINT = JCtx(attn_impl="interpret")
F32_ATOL, DECODE_ATOL = 5e-5, 2e-3
BF16_ATOL = {LLAMA: 0.3, SEAMLESS: 0.6}
LOSS_RTOL, GRAD_RTOL = 1e-6, 1e-3

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


def _gated(params, value=GATE):
    """params with every cross gate set to `value`."""
    return jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.full_like(x, value) if path[-1].key == "gate" else x, params)


def _jax_side(arch, gate=GATE):
    """(JAX config, model, bf16 params from Model.init with the gates at
    `gate`, tokens, memory (f32, std 1)), once per arch and gate."""
    key = ("jax", arch, gate)
    if key not in _cache:
        jcfg = jax_config(arch, smoke=True)
        jm = jax_build(jcfg)
        params = _gated(jm.init(jax.random.PRNGKey(0)), gate)
        rng = np.random.RandomState(1)
        tokens = rng.randint(0, jcfg.vocab_size, (2, S + N_DEC))
        memory = rng.randn(2, jm.memory_len(), jcfg.d_model).astype(np.float32)
        _cache[key] = jcfg, jm, params, tokens, memory
    return _cache[key]


def _port(arch, params, dtype, trainable=False, cfg=None):
    cfg = cfg or get_config(arch, smoke=True)
    m = Model(cfg, device="cpu", trainable=trainable)
    m.load_state_dict(from_jax_params(_np(params, dtype), cfg, device="cpu"),
                      strict=True, assign=True)
    return m


def _f32(tree):
    return jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), tree)


def _runs(arch, dtype):
    """{apply, prefill, decode0..}: logits of JAX and of the port on the
    same weights and memory (f32, or bf16 as initialised for None), and the
    JAX prefill cache."""
    key = ("runs", arch, dtype)
    if key not in _cache:
        _, jm, params, tokens, memory = _jax_side(arch)
        jp = params if dtype is None else _f32(params)
        mem_dt = jnp.bfloat16 if dtype is None else jnp.float32
        jt, jmem = jnp.asarray(tokens), jnp.asarray(memory, mem_dt)
        want = {"apply": jax.jit(lambda p, t, m: jm.apply(p, t, JINT, memory=m)[0])(
            jp, jt[:, :S], jmem)}
        want["prefill"], cache = jax.jit(
            lambda p, t, m: jm.prefill(p, t, JINT, CACHE_LEN, memory=m))(jp, jt[:, :S], jmem)
        jcache = _np(cache)
        decode = jax.jit(lambda p, t, c: jm.decode_step(p, t, c, JINT))
        for i in range(N_DEC):
            want[f"decode{i}"], cache = decode(jp, jt[:, S + i:S + i + 1], cache)
        m = _port(arch, params, dtype)
        t = torch.from_numpy(tokens)
        tmem = torch.from_numpy(np.array(jmem.astype(jnp.float32))).to(
            torch.bfloat16 if dtype is None else torch.float32)
        with torch.inference_mode():
            got = {"apply": m.apply(t[:, :S], memory=tmem)}
            got["prefill"], tcache = m.prefill(t[:, :S], CACHE_LEN, memory=tmem)
            for i in range(N_DEC):
                got[f"decode{i}"], tcache = m.decode_step(t[:, S + i:S + i + 1], tcache)
        assert tcache["pos"] == S + N_DEC
        _cache[key] = ({k: np.asarray(v, np.float32) for k, v in want.items()},
                       {k: v.float().numpy() for k, v in got.items()}, jcache)
    return _cache[key]


def _loss_batch(arch):
    """The reference's batch (its memory bf16 x 0.02), the memory in f32."""
    jcfg, jm = jax_config(arch, smoke=True), jax_build(jax_config(arch, smoke=True))
    batch = jax_batch(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=SEQ, global_batch=BATCH,
                                  memory_len=jm.memory_len(), d_model=jcfg.d_model), 0)
    batch["memory"] = batch["memory"].astype(jnp.float32)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tb["tokens"], tb["labels"] = tb["tokens"].long(), tb["labels"].long()
    return batch, tb


def _loss_and_grads(arch):
    """(JAX loss, its gradient as the port's flat dict, the port's loss, the
    port's model after backward) in f32 on the reference's batch."""
    key = ("loss", arch)
    if key not in _cache:
        _, jm, params, _, _ = _jax_side(arch)
        p32 = _f32(params)
        batch, tb = _loss_batch(arch)
        (jl, _), jg = jax.jit(jax.value_and_grad(
            lambda p, b: jm.loss(p, b, JCtx(attn_impl="xla")), has_aux=True))(p32, batch)
        m = _port(arch, params, np.float32, trainable=True)
        tl, _ = m.loss(tb)
        tl.backward()
        cfg = get_config(arch, smoke=True)
        _cache[key] = float(jl), from_jax_params(_np(jg), cfg, device="cpu"), tl.item(), m
    return _cache[key]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _jax_ndims(params, cfg):
    """{port name: the leaf's ndim in the JAX layout} of a JAX params tree."""
    nsb, out = len(cfg.superblock), {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [k.key for k in path]
        if keys[:2] == ["blocks", "sb"]:
            i = int(keys[2][len("slot"):])
            names = [f"layers.{r * nsb + i}." + ".".join(keys[3:]) for r in range(cfg.sb_repeat)]
        elif keys[:3] == ["encoder", "sb", "slot0"]:
            names = [f"encoder.layers.{n}." + ".".join(keys[3:])
                     for n in range(cfg.encoder_layers)]
        else:
            assert keys[0] != "blocks", keys         # neither arch has a remainder
            names = [".".join(keys)]
        out.update({n: leaf.ndim for n in names})
    return out


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
def test_bridge_loads_every_leaf_bit_exact(arch):
    """Every JAX leaf lands once, bit for bit: the stacked decoder and
    encoder leaves in their layers, the bf16 weights as bf16 and the cross
    gates as f32 scalars in a bf16 model."""
    jcfg, _, params, _, _ = _jax_side(arch)
    state = _port(arch, params, None).state_dict()
    assert sum(t.numel() for t in state.values()) == \
        sum(x.size for x in jax.tree_util.tree_leaves(params))
    nsb, seen, gates = len(jcfg.superblock), set(), 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [k.key for k in path]
        if keys[:2] == ["blocks", "sb"]:
            i = int(keys[2][len("slot"):])
            pairs = [(f"layers.{r * nsb + i}." + ".".join(keys[3:]), np.asarray(leaf)[r])
                     for r in range(jcfg.sb_repeat)]
        elif keys[:3] == ["encoder", "sb", "slot0"]:
            pairs = [(f"encoder.layers.{n}." + ".".join(keys[3:]), np.asarray(leaf)[n])
                     for n in range(jcfg.encoder_layers)]
        else:
            pairs = [(".".join(keys), np.asarray(leaf))]
        for name, want in pairs:
            t = state[name]
            seen.add(name)
            if keys[-1] == "gate":
                gates += 1
                assert t.dtype == torch.float32 and t.shape == () and float(t) == GATE, name
                continue
            assert t.dtype == torch.bfloat16, name
            np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                          want.view(np.uint16), err_msg=name)
    assert seen == set(state)
    # a gate a cross layer (llama: one of five layers), one an xattn (every
    # seamless decoder layer)
    assert gates == (jcfg.num_layers // 5 if arch == LLAMA else jcfg.num_layers)
    if arch == SEAMLESS:
        assert sum(k.startswith("encoder.layers.") for k in state) > 0


def test_bridge_refuses_an_unknown_encoder_leaf():
    _, _, params, _, _ = _jax_side(SEAMLESS)
    tree = _np(params)
    tree["encoder"]["extra"] = {"w": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="encoder"):
        from_jax_params(tree, get_config(SEAMLESS, smoke=True), device="cpu")


# ---------------------------------------------------------------------------
# the attention kinds against JAX, both reference paths
# ---------------------------------------------------------------------------

# (arch, the JAX params subtree of one attention layer, its kind)
LAYERS = {"llama-cross": (LLAMA, ("blocks", "sb", "slot4", "attn"), "cross"),
          "seamless-xattn": (SEAMLESS, ("blocks", "sb", "slot0", "xattn"), "cross"),
          "seamless-enc": (SEAMLESS, ("encoder", "sb", "slot0", "attn"), "enc")}


@pytest.mark.parametrize("mode", ["xla", "interpret"])
@pytest.mark.parametrize("layer", list(LAYERS))
def test_attention_apply_matches_jax(layer, mode):
    """attention_apply of a cross layer (k/v from the memory, no rope,
    tanh-gated) and of an enc layer (roped, unmasked) in f32, output and
    k/v, against the JAX layer in both reference modes."""
    arch, path, kind = LAYERS[layer]
    jcfg, _, params, _, _ = _jax_side(arch)
    cfg = get_config(arch, smoke=True)
    p = _f32(params)
    for key in path:
        p = p[key]
    p = jax.tree_util.tree_map(lambda x: x[0], p)          # the first stacked layer
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}   # no qk-norm here
    rng = np.random.RandomState(3)
    M = cfg.context_tokens or cfg.encoder_len
    x = rng.randn(2, S if kind == "cross" else M, cfg.d_model).astype(np.float32)
    mem = rng.randn(2, M, cfg.d_model).astype(np.float32) if kind == "cross" else None
    oj, (kj, vj) = ja.attention_apply(p, jnp.asarray(x), jcfg, JCtx(attn_impl=mode), kind,
                                      memory=None if mem is None else jnp.asarray(mem))
    with torch.inference_mode():
        ot, (kt, vt) = ta.attention_apply(tp, torch.from_numpy(x), cfg, Ctx(), kind,
                                          memory=None if mem is None else torch.from_numpy(mem))
    assert ot.shape == x.shape and kt.shape[1] == M
    for got, want in ((ot, oj), (kt, kj), (vt, vj)):
        assert _rel(got.numpy(), np.asarray(want)) <= 2e-5


def test_cross_decode_reads_the_memory_cache_and_writes_nothing():
    """A cross layer's decode attends unmasked to its memory k/v, returns
    the cache untouched, and matches the JAX decode at 2e-3 (bf16 cache,
    bf16 softmax weights); packing keeps the memory's length."""
    jcfg, _, params, _, _ = _jax_side(LLAMA)
    cfg = get_config(LLAMA, smoke=True)
    p = jax.tree_util.tree_map(lambda x: x[0], _f32(params)["blocks"]["sb"]["slot4"]["attn"])
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    rng = np.random.RandomState(4)
    mem = rng.randn(2, cfg.context_tokens, cfg.d_model).astype(np.float32)
    x = rng.randn(2, 1, cfg.d_model).astype(np.float32)
    _, (k, v) = ta.attention_apply(tp, torch.zeros(2, 3, cfg.d_model), cfg, Ctx(), "cross",
                                   memory=torch.from_numpy(mem))
    cache = ta.pack_prefill_cache(k, v, "cross", cfg, CACHE_LEN)
    assert cache["k"].shape == (2, cfg.context_tokens, cfg.num_kv_heads, cfg.head_dim)
    assert cache["k"].dtype == torch.bfloat16
    before = {n: t.clone() for n, t in cache.items()}
    jc = {n: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for n, t in cache.items()}
    oj, _ = ja.attention_decode(p, jnp.asarray(x), jc, jnp.int32(S), jcfg, JCtx(), "cross")
    with torch.inference_mode():
        ot, out_cache = ta.attention_decode(tp, torch.from_numpy(x), cache, S, cfg, Ctx(),
                                            "cross")
    assert out_cache is cache and all(torch.equal(cache[n], before[n]) for n in cache)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=2e-3, rtol=1e-5)


# ---------------------------------------------------------------------------
# the models against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_f32_apply_and_prefill_match_jax(arch):
    want, got, _ = _runs(arch, np.float32)
    np.testing.assert_allclose(got["apply"], want["apply"], atol=F32_ATOL)
    np.testing.assert_allclose(got["prefill"], want["prefill"], atol=F32_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_decode_matches_jax(arch):
    want, got, _ = _runs(arch, np.float32)
    for i in range(N_DEC):
        np.testing.assert_allclose(got[f"decode{i}"], want[f"decode{i}"], atol=DECODE_ATOL,
                                   err_msg=f"decode step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_logits_match_jax(arch):
    want, got, _ = _runs(arch, None)
    for key in want:
        err = np.abs(got[key] - want[key]).max()
        assert err < BF16_ATOL[arch], f"{key}: {err}"


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_the_bridged_jax_cache(arch):
    """from_jax_cache maps the JAX prefill cache, the cross layers' and the
    xattn sub-layers' memory k/v included, into the port's layout: the
    port's decode from it matches the JAX decode."""
    want, _, jcache = _runs(arch, np.float32)
    _, _, params, tokens, _ = _jax_side(arch)
    cfg = get_config(arch, smoke=True)
    cache = from_jax_cache(jcache, cfg, device="cpu")
    M = cfg.context_tokens or cfg.encoder_len
    kinds = [set(c) for c in cache["layers"]]
    if arch == SEAMLESS:
        assert kinds == [{"attn", "xattn"}] * cfg.num_layers
        assert all(c["xattn"]["k"].shape[1] == M for c in cache["layers"])
    else:
        assert all(c["attn"]["k"].shape[1] == (M if k == "cross" else CACHE_LEN)
                   for c, k in zip(cache["layers"], cfg.layer_kinds))
    m = _port(arch, params, np.float32)
    t = torch.from_numpy(tokens)
    with torch.inference_mode():
        for i in range(N_DEC):
            got, cache = m.decode_step(t[:, S + i:S + i + 1], cache)
            np.testing.assert_allclose(got.numpy(), want[f"decode{i}"], atol=DECODE_ATOL,
                                       err_msg=f"decode step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_memory_moves_the_logits(arch):
    """The check a zero gate would pass wrongly: with every gate at GATE the
    port's logits move by more than 1e-2 of the largest logit (far above
    f32 rounding) when the memory is replaced by other noise, as the
    reference's do; with the gates at zero, as initialised, neither
    package's logits depend on the memory at all."""
    for gate in (GATE, 0.0):
        _, jm, params, tokens, memory = _jax_side(arch, gate)
        jp, t = _f32(params), torch.from_numpy(tokens[:, :S])
        m = _port(arch, params, np.float32)
        other = np.random.RandomState(9).randn(*memory.shape).astype(np.float32)
        with torch.inference_mode():
            a, b = (m.apply(t, memory=torch.from_numpy(x)).numpy() for x in (memory, other))
        japply = jax.jit(lambda p, t, mem: jm.apply(p, t, JCtx(), memory=mem)[0])
        ja_, jb = (np.asarray(japply(jp, jnp.asarray(tokens[:, :S]), jnp.asarray(x)))
                   for x in (memory, other))
        if gate:
            assert np.abs(a - b).max() > 1e-2 * np.abs(a).max()
            assert np.abs(ja_ - jb).max() > 1e-2 * np.abs(ja_).max()
        else:
            assert np.array_equal(a, b) and np.array_equal(ja_, jb)


@pytest.mark.parametrize("arch", ARCHS)
def test_memory_is_required_where_the_arch_attends_to_one(arch):
    _, _, params, tokens, memory = _jax_side(arch)
    m = _port(arch, params, np.float32)
    t = torch.from_numpy(tokens[:, :S])
    with pytest.raises(ValueError, match="memory"):
        m.apply(t)
    with pytest.raises(ValueError, match="memory"):
        m.prefill(t, CACHE_LEN, memory=torch.zeros(3, memory.shape[1], memory.shape[2]))
    g = Model(get_config("gemma3-4b", smoke=True), device="cpu")
    with pytest.raises(ValueError, match="no memory"):
        g.apply(t, memory=torch.from_numpy(memory))


# ---------------------------------------------------------------------------
# training against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_jax(arch):
    jl, _, tl, _ = _loss_and_grads(arch)
    assert abs(tl - jl) <= LOSS_RTOL * abs(jl)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_gradient_leaf_matches_jax(arch):
    """Every leaf, the encoder's, the cross layers' and the gates' among
    them, each of which gets a non-zero gradient with the gates set."""
    _, jg, _, m = _loss_and_grads(arch)
    names = dict(m.named_parameters())
    assert names.keys() == jg.keys()
    for k, p in names.items():
        assert p.grad is not None and p.grad.shape == jg[k].shape, k
        assert torch.isfinite(p.grad).all(), k
        if k.startswith("encoder.") or ".xattn." in k or k.endswith(".gate"):
            assert p.grad.abs().max() > 0, k
        err = _rel(p.grad.numpy(), jg[k].numpy())
        assert err <= GRAD_RTOL, (k, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_give_the_same_loss_and_grads(arch):
    """remat none, dots and full (the decoder's superblock repeats and the
    encoder's layers) give the same loss and gradients, 1e-6 relative."""
    _, _, params, _, _ = _jax_side(arch)
    _, tb = _loss_batch(arch)
    out = {}
    for remat in ("none", "dots", "full"):
        m = _port(arch, params, np.float32, trainable=True)
        loss, _ = m.loss(tb, Ctx(remat=remat))
        loss.backward()
        out[remat] = (loss.item(), {k: p.grad for k, p in m.named_parameters()})
    for remat in ("dots", "full"):
        assert abs(out[remat][0] - out["none"][0]) <= 1e-6 * abs(out["none"][0])
        for k, g in out["none"][1].items():
            assert _rel(out[remat][1][k].numpy(), g.numpy()) <= 1e-6, (remat, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_stacked_ndims_and_an_adamw_step_match_jax(arch):
    """stacked_ndims gives every leaf its ndim in the JAX layout (the
    encoder's stacked norm scales 2, so they decay; a stacked gate 1, so it
    does not), and one AdamW step of the port matches the reference's, its
    moments too as from_jax_opt_state maps them (the encoder's unstacked)."""
    jcfg, _, params, _, _ = _jax_side(arch)
    cfg = get_config(arch, smoke=True)
    p32 = _f32(params)
    ndims = Model(cfg, device="cpu").stacked_ndims()
    assert ndims == _jax_ndims(p32, jcfg)
    gates = [k for k in ndims if k.endswith(".gate")]
    assert gates and all(ndims[k] == 1 for k in gates)
    if arch == SEAMLESS:
        assert ndims["encoder.layers.0.ln1.scale"] == 2
        assert ndims["encoder.final_norm.scale"] == 1
    kw = dict(lr=1e-2, warmup_steps=0, total_steps=10, grad_clip=0.5, weight_decay=0.1)
    rng = np.random.RandomState(5)
    grads = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.05), p32)
    tparams = from_jax_params(_np(p32), cfg, device="cpu")
    want, jstate, _ = jax_adamw(JOptConfig(**kw), p32, grads, jax_init_opt(p32))
    got, tstate, _ = adamw_update(OptConfig(**kw), tparams,
                                  from_jax_params(_np(grads), cfg, device="cpu"),
                                  init_opt_state(tparams), ndims)
    want = from_jax_params(_np(want), cfg, device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        assert _rel(got[k].numpy(), want[k].numpy()) <= 1e-6, k
    jst = from_jax_opt_state(_np(jstate), cfg, device="cpu")
    assert jst.step == tstate.step == 1 and jst.mu.keys() == tstate.mu.keys() == got.keys()
    for k in got:
        for mine, theirs in ((tstate.mu[k], jst.mu[k]), (tstate.nu[k], jst.nu[k])):
            assert _rel(mine.numpy(), theirs.numpy()) <= 1e-6, k


def test_moe_config_with_a_cross_layer_matches_jax():
    """A cross layer keeps a plain MLP in an MoE config: the port's
    layer_specs give the reference's key trees for each kind, and the
    f32 logits of such a model (mixtral's smoke config with (local, cross)
    layers over a memory) match JAX's at the MoE archs' 1e-4."""
    base = dict(family="vlm", num_layers=4, superblock=("local", "cross"), sb_repeat=2,
                remainder=(), context_tokens=8)
    cfg = get_config("mixtral-8x7b", smoke=True).replace(**base)
    jcfg = jax_config("mixtral-8x7b", smoke=True).replace(**base)

    def keys(tree):
        return {k: keys(v) if isinstance(v, dict) else None for k, v in tree.items()}

    for kind in ("local", "cross"):
        assert keys(layer_specs(cfg, kind)) == keys(jax_layer_specs(jcfg, kind))
    assert "mlp" in layer_specs(cfg, "cross") and "moe" in layer_specs(cfg, "local")
    jm = jax_build(jcfg)
    params = _f32(_gated(jm.init(jax.random.PRNGKey(0))))
    rng = np.random.RandomState(6)
    tokens = rng.randint(0, cfg.vocab_size, (2, 24))
    mem = rng.randn(2, 8, cfg.d_model).astype(np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(tokens), JINT, memory=jnp.asarray(mem))[0])
    m = _port("mixtral-8x7b", params, np.float32, cfg=cfg)
    with torch.inference_mode():
        got = m.apply(torch.from_numpy(tokens), memory=torch.from_numpy(mem)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


# ---------------------------------------------------------------------------
# data, checkpoints and the entry points on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_data_draws_stub_memory(arch):
    """The port's batches carry the stub memory, bf16 x 0.02, (B, memory_len,
    D), a pure function of (seed, step) that leaves the token stream as it
    is without memory."""
    cfg = get_config(arch, smoke=True)
    ml = Model(cfg, device="cpu").memory_len()
    assert ml == jax_build(jax_config(arch, smoke=True)).memory_len() > 0
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH, memory_len=ml,
                    d_model=cfg.d_model)
    a, b = make_batch(dc, 3, device="cpu"), make_batch(dc, 3, device="cpu")
    plain = make_batch(dataclasses.replace(dc, memory_len=0), 3, device="cpu")
    assert a["memory"].shape == (BATCH, ml, cfg.d_model) and a["memory"].dtype == torch.bfloat16
    assert torch.equal(a["memory"], b["memory"]) and torch.equal(a["tokens"], plain["tokens"])
    assert not torch.equal(a["memory"], make_batch(dc, 4, device="cpu")["memory"])
    assert 0.015 < a["memory"].float().std().item() < 0.025
    assert "memory" not in plain


def test_checkpoint_holds_the_encoder_and_the_gates(tmp_path):
    """A checkpoint of seamless's train state holds every encoder leaf and
    every gate, and restores them bit for bit."""
    _, _, params, _, _ = _jax_side(SEAMLESS)
    m = _port(SEAMLESS, params, None, trainable=True)
    state = init_train_state(m)
    save_checkpoint(str(tmp_path), 1, state)
    names = [k for k in state.params if k.startswith("encoder.") or k.endswith(".gate")]
    with np.load(tmp_path / "step_00000001" / "arrays.npz") as z:
        assert all(f"params/{k}" in z.files for k in names)
    want = {k: state.params[k].detach().clone() for k in names}
    with torch.no_grad():
        for k in names:
            state.params[k].zero_()
    restore_checkpoint(str(tmp_path), 1, state)
    assert all(torch.equal(state.params[k], want[k]) for k in names)
    assert state.params["layers.0.xattn.gate"].item() == GATE


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_runs_on_the_cpu(arch, capsys):
    toks = serve.main(["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "40",
                       "--steps", "5", "--device", "cpu"])
    assert toks.shape == (2, 5) and toks.dtype == torch.int64
    assert 0 <= int(toks.min()) and int(toks.max()) < get_config(arch, smoke=True).vocab_size
    assert "[serve] prefill 2x40 on cpu" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_runs_on_the_cpu(arch, tmp_path):
    """launch/train.py --smoke --device cpu with the stub memory in every
    batch: the cross and enc layers train through ops.FlashAttention's plain
    backward."""
    log = launch_train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "3",
                             "--seq-len", "40", "--batch", "2", "--log-every", "1",
                             "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"])
    assert [m["step"] for m in log] == [0, 1, 2]
    assert all(np.isfinite(m["loss"]) for m in log)
