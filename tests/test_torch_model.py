"""The port's gemma3-4b serving slice against the JAX package (smoke config).

Weights come from JAX ``Model.init`` through ``bridge.from_jax_params``;
tokens from a numpy seed. The JAX side reaches its flash kernel in interpret
mode (``Ctx(attn_impl="interpret")``).

Tolerances, with their reasons:
  * f32 apply / prefill logits: 5e-5 absolute (f32 summation order only;
    logits are O(1)).
  * f32 decode logits: 2e-3 absolute. Both packages keep the decode cache in
    bf16 and round decode's softmax weights to bf16, so a value on a bf16
    rounding boundary can land one bf16 ulp (at most 2^-7 relative) apart.
  * bf16 logits: 0.3, the bound tests/test_models.py uses between two
    attention implementations in bf16.
  * the port's own prefill/decode contracts: those of tests/test_models.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ParallelConfig  # noqa: E402
from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.models import Ctx as JCtx, build_model as jax_build  # noqa: E402
from repro.models.model import layer_specs as jax_layer_specs  # noqa: E402
from repro.train.serve_step import generate as jax_generate  # noqa: E402
from repro_torch.bridge import from_jax_cache, from_jax_params  # noqa: E402
from repro_torch.configs.registry import ARCH_NAMES, get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.model import layer_specs  # noqa: E402
from repro_torch.train.serve_step import generate  # noqa: E402

S, N_DEC, CACHE_LEN = 48, 8, 64           # S > local window 32: the ring is live
JINT = JCtx(attn_impl="interpret")


def _np_tree(tree, dtype=None):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x if dtype is None else x.astype(dtype)), tree)


@pytest.fixture(scope="module")
def jax_side():
    jcfg = jax_config("gemma3-4b", smoke=True)
    jm = jax_build(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tokens = np.random.RandomState(1).randint(0, jcfg.vocab_size, (2, S + N_DEC))
    return jcfg, jm, params, tokens


def _port(params, dtype):
    cfg = get_config("gemma3-4b", smoke=True)
    m = Model(cfg, device="cpu")
    m.load_state_dict(from_jax_params(_np_tree(params, dtype), cfg, device="cpu"),
                      strict=True, assign=True)
    return m


def _run_jax(jm, params, tokens):
    """apply over S tokens, prefill, then N_DEC decode steps: logits of each."""
    out = {"apply": jm.apply(params, jnp.asarray(tokens[:, :S]), JINT)[0]}
    out["prefill"], cache = jm.prefill(params, jnp.asarray(tokens[:, :S]), JINT,
                                       CACHE_LEN)
    out["cache"] = _np_tree(cache)
    for i in range(N_DEC):
        out[f"decode{i}"], cache = jm.decode_step(
            params, jnp.asarray(tokens[:, S + i:S + i + 1]), cache, JINT)
    return {k: (v if k == "cache" else np.asarray(v, np.float32))
            for k, v in out.items()}


def _run_port(m, tokens):
    t = torch.from_numpy(tokens)
    with torch.inference_mode():
        out = {"apply": m.apply(t[:, :S])}
        out["prefill"], cache = m.prefill(t[:, :S], CACHE_LEN)
        out["cache"] = cache
        for i in range(N_DEC):
            out[f"decode{i}"], cache = m.decode_step(t[:, S + i:S + i + 1], cache)
    return {k: (v if k == "cache" else v.float().numpy()) for k, v in out.items()}


@pytest.fixture(scope="module")
def f32_runs(jax_side):
    jcfg, jm, params, tokens = jax_side
    p32 = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), params)
    return _run_jax(jm, p32, tokens), _run_port(_port(params, np.float32), tokens)


# ---------------------------------------------------------------------------
# bridge
# ---------------------------------------------------------------------------

def test_bridge_maps_every_leaf_once_bit_exact(jax_side):
    jcfg, _, params, _ = jax_side
    m = _port(params, None)
    state = m.state_dict()
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    n_sb = sum(1 for path, _ in leaves if "'sb'" in jax.tree_util.keystr(path))
    assert len(state) == len(leaves) - n_sb + n_sb * jcfg.sb_repeat
    assert sum(t.numel() for t in state.values()) == sum(x.size for _, x in leaves)
    nsb = len(jcfg.superblock)
    for path, leaf in leaves:
        keys = [k.key for k in path]
        bits = np.asarray(leaf).view(np.uint16)
        if keys[:2] == ["blocks", "sb"]:
            i = int(keys[2][len("slot"):])
            pairs = [(f"layers.{r * nsb + i}." + ".".join(keys[3:]), bits[r])
                     for r in range(jcfg.sb_repeat)]
        elif keys[0] == "blocks":
            j = int(keys[1][len("rem"):])
            pairs = [(f"layers.{nsb * jcfg.sb_repeat + j}." + ".".join(keys[2:]),
                      bits)]
        else:
            pairs = [(".".join(keys), bits)]
        for name, want in pairs:
            t = state[name]
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                          want, err_msg=name)


def test_prefill_cache_matches_jax_stacked_cache(jax_side, f32_runs):
    """JAX stacks the superblock's caches along a layers axis; the port keeps
    one per layer. The bridged JAX prefill cache equals the port's, up to one
    bf16 ulp where an f32 key/value sits on a rounding boundary."""
    jcfg, _, params, tokens = jax_side
    jax_run, _ = f32_runs
    cfg = get_config("gemma3-4b", smoke=True)
    want = from_jax_cache(jax_run["cache"], cfg, device="cpu")
    with torch.inference_mode():
        _, got = _port(params, np.float32).prefill(torch.from_numpy(tokens[:, :S]),
                                                   CACHE_LEN)
    assert want["pos"] == got["pos"] == S
    assert len(want["layers"]) == len(got["layers"]) == jcfg.num_layers
    # the ring of a local layer (32 slots) and the full cache of the global one
    assert [c["attn"]["k"].shape[1] for c in got["layers"]] == [32, 32, CACHE_LEN, 32]
    for n, (w, g) in enumerate(zip(want["layers"], got["layers"])):
        for name in ("k", "v"):
            assert g["attn"][name].dtype == w["attn"][name].dtype == torch.bfloat16
            np.testing.assert_allclose(g["attn"][name].float().numpy(),
                                       w["attn"][name].float().numpy(),
                                       rtol=2.0 ** -7, atol=1e-6,
                                       err_msg=f"layer {n} {name}")


def test_bridge_rejects_wrong_stack_depth(jax_side):
    _, _, params, _ = jax_side
    cfg = get_config("gemma3-4b", smoke=True).replace(
        num_layers=7, sb_repeat=2)
    with pytest.raises(ValueError, match="sb_repeat"):
        from_jax_params(_np_tree(params), cfg, device="cpu")


# ---------------------------------------------------------------------------
# whole slice against JAX
# ---------------------------------------------------------------------------

def test_f32_apply_and_prefill_match_jax(f32_runs):
    jax_run, port_run = f32_runs
    np.testing.assert_allclose(port_run["apply"], jax_run["apply"], atol=5e-5)
    np.testing.assert_allclose(port_run["prefill"], jax_run["prefill"], atol=5e-5)


def test_f32_decode_steps_match_jax(f32_runs):
    jax_run, port_run = f32_runs
    for i in range(N_DEC):
        np.testing.assert_allclose(port_run[f"decode{i}"], jax_run[f"decode{i}"],
                                   atol=2e-3, err_msg=f"decode step {i}")


def test_f32_greedy_tokens_identical(jax_side):
    jcfg, jm, params, tokens = jax_side
    p32 = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), params)
    want = jax_generate(jm, p32, jnp.asarray(tokens[:, :S]), N_DEC,
                        ParallelConfig(attn_impl="interpret"))
    got = generate(_port(params, np.float32), torch.from_numpy(tokens[:, :S]),
                   N_DEC)
    assert got.shape == (2, N_DEC)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bf16_logits_match_jax(jax_side):
    jcfg, jm, params, tokens = jax_side
    jax_run = _run_jax(jm, params, tokens)
    port_run = _run_port(_port(params, None), tokens)
    for key in ["apply", "prefill"] + [f"decode{i}" for i in range(N_DEC)]:
        err = np.abs(port_run[key] - jax_run[key]).max()
        assert err < 0.3, f"{key}: {err}"


# ---------------------------------------------------------------------------
# the port's own serving contracts (tests/test_models.py)
# ---------------------------------------------------------------------------

def test_prefill_and_decode_match_forward():
    cfg = get_config("gemma3-4b", smoke=True)
    m = Model(cfg, device="cpu", seed=0)
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, S + N_DEC), generator=g)
    with torch.inference_mode():
        full = m.apply(tokens)
        last, cache = m.prefill(tokens[:, :S], CACHE_LEN)
        np.testing.assert_allclose(last.numpy(), full[:, S - 1].numpy(),
                                   atol=1e-3, rtol=1e-2)
        for i in range(N_DEC):
            dl, cache = m.decode_step(tokens[:, S + i:S + i + 1], cache)
            err = float((dl - full[:, S + i]).abs().max())
            assert err < (0.15 if i == 0 else 0.2), f"step {i}: {err}"
    assert cache["pos"] == S + N_DEC


@pytest.mark.parametrize("change", [
    {"superblock": ("global", "cross"), "sb_repeat": 2, "remainder": ()},
    {"superblock": ("rglru", "cross"), "sb_repeat": 2, "remainder": ()},
    {"superblock": ("ssd", "enc"), "sb_repeat": 2, "remainder": ()},
    {"superblock": ("local", "cross"), "sb_repeat": 2, "remainder": ()},
    {"encoder_layers": 2},
])
def test_unported_layers_raise(change):
    """The name is from before cross-attention and the encoder were ported:
    these layer patterns raised then. Each now builds, and the port's
    layer_specs give the JAX package's key tree for every kind the config
    uses (an enc-dec global layer with its ln_x and gated xattn, and the
    encoder's enc layers), as does the model's parameter set."""
    cfg = get_config("gemma3-4b", smoke=True).replace(**change)
    jcfg = jax_config("gemma3-4b", smoke=True).replace(**change)

    def keys(tree):
        return {k: keys(v) if isinstance(v, dict) else None for k, v in tree.items()}

    kinds = set(cfg.layer_kinds) | ({"enc"} if cfg.is_encdec else set())
    for kind in kinds:
        assert keys(layer_specs(cfg, kind)) == keys(jax_layer_specs(jcfg, kind)), kind
    if cfg.is_encdec:
        assert {"ln_x", "xattn"} <= set(layer_specs(cfg, "global"))
    m = Model(cfg, device="cpu")
    n_jax = sum(x.size for x in jax.tree_util.tree_leaves(
        jax_build(jcfg).abstract_params(), is_leaf=lambda x: hasattr(x, "shape")))
    assert sum(p.numel() for p in m.parameters()) == n_jax


def test_registry_lists_ported_archs():
    """All ten archs of the zoo are ported; an unknown name raises KeyError
    listing them."""
    archs = ("gemma3-4b", "mamba2-780m", "recurrentgemma-9b", "qwen3-8b",
             "granite-3-8b", "gemma3-12b", "mixtral-8x7b", "dbrx-132b",
             "llama-3.2-vision-90b", "seamless-m4t-medium")
    assert set(ARCH_NAMES) == set(archs) and len(ARCH_NAMES) == 10
    for arch in archs:
        assert get_config(arch).param_count() == jax_config(arch).param_count()
    with pytest.raises(KeyError, match="gemma3-4b"):
        get_config("no-such-arch")


@pytest.mark.parametrize("smoke", [False, True])
def test_config_copy_matches_jax(smoke):
    """The port's copy of the config holds every field with the same value."""
    assert dataclasses.asdict(get_config("gemma3-4b", smoke=smoke)) == \
        dataclasses.asdict(jax_config("gemma3-4b", smoke=smoke))
    with pytest.raises(ValueError, match="layer pattern"):
        get_config("gemma3-4b", smoke=smoke).replace(num_layers=35)


def test_memory_len_matches_jax(jax_side):
    jcfg, jm, _, _ = jax_side
    assert Model(get_config("gemma3-4b", smoke=True), device="cpu").memory_len() \
        == jm.memory_len() == 0


# ---------------------------------------------------------------------------
# mamba2-780m (smoke): the SSD slice against JAX
# ---------------------------------------------------------------------------
# S = 48 with chunk 32: a chunk boundary and the padding of the last chunk
# are both live. Tolerances: f32 logits 1e-4 absolute (logits are O(1); the
# SSD sums run in another order and, in JAX, chunked); f32 decode 2e-3
# absolute, as for gemma3-4b: both packages keep the conv history in bf16,
# so a value on a bf16 rounding boundary can land one ulp apart; bf16 0.3,
# as above.

@pytest.fixture(scope="module")
def mamba_side():
    jcfg = jax_config("mamba2-780m", smoke=True)
    jm = jax_build(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tokens = np.random.RandomState(1).randint(0, jcfg.vocab_size, (2, S + N_DEC))
    return jcfg, jm, params, tokens


def _mamba_port(params, dtype):
    cfg = get_config("mamba2-780m", smoke=True)
    m = Model(cfg, device="cpu")
    m.load_state_dict(from_jax_params(_np_tree(params, dtype), cfg, device="cpu"),
                      strict=True, assign=True)
    return m


@pytest.fixture(scope="module")
def mamba_f32_runs(mamba_side):
    jcfg, jm, params, tokens = mamba_side
    p32 = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), params)
    return (_run_jax(jm, p32, tokens),
            _run_port(_mamba_port(params, np.float32), tokens))


def test_mamba2_bridge_loads_every_leaf_bit_exact(mamba_side):
    jcfg, _, params, _ = mamba_side
    state = _mamba_port(params, None).state_dict()
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    assert sum(t.numel() for t in state.values()) == sum(x.size for _, x in leaves)
    for path, leaf in leaves:
        keys = [k.key for k in path]
        if keys[:2] != ["blocks", "sb"]:
            continue
        for r in range(jcfg.sb_repeat):
            t = state[f"layers.{r}." + ".".join(keys[3:])]
            want = np.asarray(leaf[r])
            assert t.dtype == (torch.float32 if want.dtype == np.float32
                               else torch.bfloat16)
            np.testing.assert_array_equal(t.float().numpy(),
                                          want.astype(np.float32))


def test_mamba2_f32_apply_prefill_decode_match_jax(mamba_f32_runs):
    jax_run, port_run = mamba_f32_runs
    np.testing.assert_allclose(port_run["apply"], jax_run["apply"], atol=1e-4)
    np.testing.assert_allclose(port_run["prefill"], jax_run["prefill"], atol=1e-4)
    for i in range(N_DEC):
        np.testing.assert_allclose(port_run[f"decode{i}"], jax_run[f"decode{i}"],
                                   atol=2e-3, err_msg=f"decode step {i}")


def test_mamba2_prefill_cache_matches_jax(mamba_side, mamba_f32_runs):
    """The bridged JAX prefill cache (state f32, conv bf16) equals the port's."""
    jcfg, _, params, tokens = mamba_side
    jax_run, _ = mamba_f32_runs
    cfg = get_config("mamba2-780m", smoke=True)
    want = from_jax_cache(jax_run["cache"], cfg, device="cpu")
    assert want["pos"] == S and len(want["layers"]) == jcfg.num_layers
    # a fresh prefill: the port's run above has decoded into its cache in place
    with torch.inference_mode():
        _, got = _mamba_port(params, np.float32).prefill(
            torch.from_numpy(tokens[:, :S]), CACHE_LEN)
    for n, (w, g) in enumerate(zip(want["layers"], got["layers"])):
        assert g["mixer"]["state"].dtype == w["mixer"]["state"].dtype == torch.float32
        assert g["mixer"]["conv"].dtype == w["mixer"]["conv"].dtype == torch.bfloat16
        scale = float(w["mixer"]["state"].abs().max())
        np.testing.assert_allclose(g["mixer"]["state"].numpy(),
                                   w["mixer"]["state"].numpy(),
                                   atol=1e-5 * scale, err_msg=f"layer {n} state")
        np.testing.assert_allclose(g["mixer"]["conv"].float().numpy(),
                                   w["mixer"]["conv"].float().numpy(),
                                   rtol=2.0 ** -7, atol=1e-6,
                                   err_msg=f"layer {n} conv")


def test_mamba2_decode_from_bridged_jax_cache(mamba_side, mamba_f32_runs):
    """The port decodes from the JAX prefill cache as JAX does."""
    _, _, params, tokens = mamba_side
    jax_run, _ = mamba_f32_runs
    cfg = get_config("mamba2-780m", smoke=True)
    cache = from_jax_cache(jax_run["cache"], cfg, device="cpu")
    m = _mamba_port(params, np.float32)
    t = torch.from_numpy(tokens)
    with torch.inference_mode():
        for i in range(N_DEC):
            dl, cache = m.decode_step(t[:, S + i:S + i + 1], cache)
            np.testing.assert_allclose(dl.numpy(), jax_run[f"decode{i}"],
                                       atol=2e-3, err_msg=f"decode step {i}")
    assert cache["pos"] == S + N_DEC


def test_mamba2_f32_greedy_tokens_identical(mamba_side):
    jcfg, jm, params, tokens = mamba_side
    p32 = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), params)
    want = jax_generate(jm, p32, jnp.asarray(tokens[:, :S]), N_DEC,
                        ParallelConfig(attn_impl="interpret"))
    got = generate(_mamba_port(params, np.float32),
                   torch.from_numpy(tokens[:, :S]), N_DEC)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mamba2_bf16_logits_match_jax(mamba_side):
    jcfg, jm, params, tokens = mamba_side
    jax_run = _run_jax(jm, params, tokens)
    port_run = _run_port(_mamba_port(params, None), tokens)
    for key in ["apply", "prefill"] + [f"decode{i}" for i in range(N_DEC)]:
        err = np.abs(port_run[key] - jax_run[key]).max()
        assert err < 0.3, f"{key}: {err}"


def test_mamba2_prefill_and_decode_match_forward():
    """The contract of tests/test_models.py:63-81 on the port's own weights."""
    cfg = get_config("mamba2-780m", smoke=True)
    m = Model(cfg, device="cpu", seed=0)
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, S + N_DEC), generator=g)
    with torch.inference_mode():
        full = m.apply(tokens)
        last, cache = m.prefill(tokens[:, :S], CACHE_LEN)
        np.testing.assert_allclose(last.numpy(), full[:, S - 1].numpy(),
                                   atol=1e-3, rtol=1e-2)
        for i in range(N_DEC):
            dl, cache = m.decode_step(tokens[:, S + i:S + i + 1], cache)
            err = float((dl - full[:, S + i]).abs().max())
            assert err < (0.15 if i == 0 else 0.2), f"step {i}: {err}"
    assert cache["pos"] == S + N_DEC


@pytest.mark.parametrize("smoke", [False, True])
def test_mamba2_config_copy_matches_jax(smoke):
    port = get_config("mamba2-780m", smoke=smoke)
    assert dataclasses.asdict(port) == \
        dataclasses.asdict(jax_config("mamba2-780m", smoke=smoke))
    assert not port.d_ff and port.tie_embeddings
    if not smoke:
        assert (port.num_layers, port.d_model, port.d_inner, port.ssm_heads,
                port.ssm_head_dim, port.ssm_state, port.conv_width,
                port.ssm_chunk, port.vocab_size) == \
            (48, 1536, 3072, 48, 64, 128, 4, 256, 50_280)


def test_mamba2_layers_have_no_mlp():
    """d_ff == 0: a layer is ln1 + the mixer, nothing else."""
    m = Model(get_config("mamba2-780m", smoke=True), device="cpu")
    assert {name.split(".")[2] for name, _ in m.named_parameters()
            if name.startswith("layers.")} == {"ln1", "mixer"}


# ---------------------------------------------------------------------------
# recurrentgemma-9b (smoke): the RG-LRU slice against JAX
# ---------------------------------------------------------------------------
# Layers: RG-LRU, RG-LRU, local attention (window 32, MQA: 4 heads over one
# kv head), RG-LRU, RG-LRU. S = 48 > window: the window mask and the local
# ring are live, and decode wraps the ring. Logits are soft-capped at 30.
# Tolerances: f32 logits RG_F32 absolute. The stacked JAX smoke init drives
# a_t to within an f32 ulp of 1 on some channels, where 1 - exp(2 log a)
# cancels and the two libraries' exp, one ulp apart, move b by ~1e-4 |u|
# (tests/test_torch_rglru.py); the layers carry that to the logits. Prefill
# caches: one bf16 ulp plus RG_F32 of the largest value, since each layer's
# input carries that difference. f32 decode 2e-3, as above: both packages
# keep the conv history and the attention cache in bf16. bf16 0.3, as above.

RG_F32 = 1e-3


@pytest.fixture(scope="module")
def rg_side():
    jcfg = jax_config("recurrentgemma-9b", smoke=True)
    jm = jax_build(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tokens = np.random.RandomState(1).randint(0, jcfg.vocab_size, (2, S + N_DEC))
    return jcfg, jm, params, tokens


def _rg_port(params, dtype):
    cfg = get_config("recurrentgemma-9b", smoke=True)
    m = Model(cfg, device="cpu")
    m.load_state_dict(from_jax_params(_np_tree(params, dtype), cfg, device="cpu"),
                      strict=True, assign=True)
    return m


@pytest.fixture(scope="module")
def rg_f32_runs(rg_side):
    jcfg, jm, params, tokens = rg_side
    p32 = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), params)
    return (_run_jax(jm, p32, tokens),
            _run_port(_rg_port(params, np.float32), tokens))


def test_recurrentgemma_bridge_loads_every_leaf_bit_exact(rg_side):
    jcfg, _, params, _ = rg_side
    state = _rg_port(params, None).state_dict()
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    assert sum(t.numel() for t in state.values()) == sum(x.size for _, x in leaves)
    nsb = len(jcfg.superblock)
    seen = set()
    for path, leaf in leaves:
        keys = [k.key for k in path]
        if keys[:2] == ["blocks", "sb"]:
            i = int(keys[2][len("slot"):])
            pairs = [(f"layers.{r * nsb + i}." + ".".join(keys[3:]), leaf[r])
                     for r in range(jcfg.sb_repeat)]
        elif keys[0] == "blocks":
            j = int(keys[1][len("rem"):])
            pairs = [(f"layers.{nsb * jcfg.sb_repeat + j}." + ".".join(keys[2:]),
                      leaf)]
        else:
            pairs = [(".".join(keys), leaf)]
        for name, want in pairs:
            want = np.asarray(want)
            t = state[name]
            seen.add(name)
            assert t.dtype == (torch.float32 if want.dtype == np.float32
                               else torch.bfloat16), name
            np.testing.assert_array_equal(t.float().numpy(),
                                          want.astype(np.float32), err_msg=name)
    assert seen == set(state)
    # the RG-LRU leaves of the stack and of the remainder both land
    assert {"layers.0.mixer.lam", "layers.4.mixer.w_a", "layers.2.attn.wk"} <= seen


def test_recurrentgemma_f32_apply_prefill_decode_match_jax(rg_f32_runs):
    jax_run, port_run = rg_f32_runs
    np.testing.assert_allclose(port_run["apply"], jax_run["apply"], atol=RG_F32)
    np.testing.assert_allclose(port_run["prefill"], jax_run["prefill"], atol=RG_F32)
    for i in range(N_DEC):
        np.testing.assert_allclose(port_run[f"decode{i}"], jax_run[f"decode{i}"],
                                   atol=2e-3, err_msg=f"decode step {i}")


def test_recurrentgemma_logits_are_soft_capped(rg_side):
    """The first ported arch with a logit cap (30). The smoke logits are
    O(1), where the cap is nearly the identity, so the final norm's scale is
    raised to 300 in both packages: the logits reach the cap, and the
    port's agree with JAX's at RG_F32 relative to the uncapped ones."""
    jcfg, jm, params, tokens = rg_side
    p32 = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), params)
    p32["final_norm"]["scale"] = p32["final_norm"]["scale"] + 300.0
    want = np.asarray(jm.apply(p32, jnp.asarray(tokens[:, :S]), JINT)[0])
    m = _rg_port(p32, np.float32)
    with torch.inference_mode():
        got = m.apply(torch.from_numpy(tokens[:, :S])).numpy()
        m.cfg = m.cfg.replace(logits_soft_cap=0.0)
        z = m.apply(torch.from_numpy(tokens[:, :S])).numpy()
    assert 30.0 < np.abs(z).max() and 25.0 < np.abs(got).max() <= 30.0
    np.testing.assert_allclose(got, 30.0 * np.tanh(z / 30.0), atol=1e-5)
    np.testing.assert_allclose(got, want, atol=RG_F32 * np.abs(z).max())


def test_recurrentgemma_prefill_cache_matches_jax(rg_side, rg_f32_runs):
    """The bridged JAX prefill cache (h f32, conv bf16, the local layer's
    k/v ring) equals the port's."""
    jcfg, _, params, tokens = rg_side
    jax_run, _ = rg_f32_runs
    cfg = get_config("recurrentgemma-9b", smoke=True)
    want = from_jax_cache(jax_run["cache"], cfg, device="cpu")
    assert want["pos"] == S and len(want["layers"]) == jcfg.num_layers
    with torch.inference_mode():
        _, got = _rg_port(params, np.float32).prefill(
            torch.from_numpy(tokens[:, :S]), CACHE_LEN)
    for n, (kind, w, g) in enumerate(zip(cfg.layer_kinds, want["layers"],
                                         got["layers"])):
        if kind == "local":
            assert g["attn"]["k"].shape[1] == cfg.local_window
            # one bf16 ulp, plus the RG-LRU layers' difference in its input
            for name in ("k", "v"):
                assert g["attn"][name].dtype == w["attn"][name].dtype == torch.bfloat16
                kv = w["attn"][name].float().numpy()
                np.testing.assert_allclose(g["attn"][name].float().numpy(), kv,
                                           rtol=2.0 ** -7,
                                           atol=RG_F32 * np.abs(kv).max(),
                                           err_msg=f"layer {n} {name}")
            continue
        assert g["mixer"]["h"].dtype == w["mixer"]["h"].dtype == torch.float32
        assert g["mixer"]["conv"].dtype == w["mixer"]["conv"].dtype == torch.bfloat16
        scale = float(w["mixer"]["h"].abs().max())
        np.testing.assert_allclose(g["mixer"]["h"].numpy(), w["mixer"]["h"].numpy(),
                                   atol=RG_F32 * scale, err_msg=f"layer {n} h")
        conv = w["mixer"]["conv"].float().numpy()
        np.testing.assert_allclose(g["mixer"]["conv"].float().numpy(), conv,
                                   rtol=2.0 ** -7, atol=RG_F32 * np.abs(conv).max(),
                                   err_msg=f"layer {n} conv")


def test_recurrentgemma_decode_from_bridged_jax_cache(rg_side, rg_f32_runs):
    """The port decodes from the JAX prefill cache as JAX does, past the
    window: the ring wraps at position 48 + step."""
    _, _, params, tokens = rg_side
    jax_run, _ = rg_f32_runs
    cfg = get_config("recurrentgemma-9b", smoke=True)
    cache = from_jax_cache(jax_run["cache"], cfg, device="cpu")
    m = _rg_port(params, np.float32)
    t = torch.from_numpy(tokens)
    with torch.inference_mode():
        for i in range(N_DEC):
            dl, cache = m.decode_step(t[:, S + i:S + i + 1], cache)
            np.testing.assert_allclose(dl.numpy(), jax_run[f"decode{i}"],
                                       atol=2e-3, err_msg=f"decode step {i}")
    assert cache["pos"] == S + N_DEC


def test_recurrentgemma_f32_greedy_tokens_identical(rg_side):
    jcfg, jm, params, tokens = rg_side
    p32 = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), params)
    want = jax_generate(jm, p32, jnp.asarray(tokens[:, :S]), N_DEC,
                        ParallelConfig(attn_impl="interpret"))
    got = generate(_rg_port(params, np.float32),
                   torch.from_numpy(tokens[:, :S]), N_DEC)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_recurrentgemma_bf16_logits_match_jax(rg_side):
    jcfg, jm, params, tokens = rg_side
    jax_run = _run_jax(jm, params, tokens)
    port_run = _run_port(_rg_port(params, None), tokens)
    for key in ["apply", "prefill"] + [f"decode{i}" for i in range(N_DEC)]:
        err = np.abs(port_run[key] - jax_run[key]).max()
        assert err < 0.3, f"{key}: {err}"


@pytest.mark.parametrize("prompt", [S, 2])
def test_recurrentgemma_prefill_and_decode_match_forward(prompt):
    """The contract of tests/test_models.py:63-81 on the port's own weights;
    a 2-token prompt is shorter than the conv history."""
    cfg = get_config("recurrentgemma-9b", smoke=True)
    m = Model(cfg, device="cpu", seed=0)
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, prompt + N_DEC), generator=g)
    with torch.inference_mode():
        full = m.apply(tokens)
        last, cache = m.prefill(tokens[:, :prompt], CACHE_LEN)
        np.testing.assert_allclose(last.numpy(), full[:, prompt - 1].numpy(),
                                   atol=1e-3, rtol=1e-2)
        for i in range(N_DEC):
            dl, cache = m.decode_step(tokens[:, prompt + i:prompt + i + 1], cache)
            err = float((dl - full[:, prompt + i]).abs().max())
            assert err < (0.15 if i == 0 else 0.2), f"step {i}: {err}"
    assert cache["pos"] == prompt + N_DEC


@pytest.mark.parametrize("smoke", [False, True])
def test_recurrentgemma_config_copy_matches_jax(smoke):
    port = get_config("recurrentgemma-9b", smoke=smoke)
    assert dataclasses.asdict(port) == \
        dataclasses.asdict(jax_config("recurrentgemma-9b", smoke=smoke))
    if not smoke:
        assert port.layer_kinds == ("rglru", "rglru", "local") * 12 + ("rglru",) * 2
        assert (port.num_layers, port.d_model, port.d_rnn, port.num_heads,
                port.num_kv_heads, port.head_dim, port.local_window, port.d_ff,
                port.act, port.vocab_size, port.tie_embeddings,
                port.logits_soft_cap) == \
            (38, 4096, 4096, 16, 1, 256, 2048, 12288, "gelu", 256_000, True, 30.0)
        assert 8.4e9 < port.param_count() < 8.6e9


def test_recurrentgemma_layers_have_an_mlp():
    """Unlike mamba2's, every RG-LRU layer has ln2 and a GeGLU MLP."""
    m = Model(get_config("recurrentgemma-9b", smoke=True), device="cpu")
    for n, kind in enumerate(m.cfg.layer_kinds):
        names = {name.split(".")[2] for name, _ in m.named_parameters()
                 if name.startswith(f"layers.{n}.")}
        assert names == ({"ln1", "mixer", "ln2", "mlp"} if kind == "rglru"
                         else {"ln1", "attn", "ln2", "mlp"}), (n, names)
