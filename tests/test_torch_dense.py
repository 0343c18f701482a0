"""The port's dense archs qwen3-8b, granite-3-8b and gemma3-12b against the
JAX package (smoke configs, CPU).

The three add no layer of their own: global and local attention on K1,
qk-norm, a separate global rope theta, silu and tanh-gelu MLPs and tied
embeddings are gemma3-4b's and recurrentgemma-9b's. Weights come from JAX
``Model.init`` through ``bridge.from_jax_params``; tokens from a numpy seed;
batches are the reference's (``repro.train.make_batch``).

Tolerances, gemma3-4b's in tests/test_torch_model.py and
tests/test_torch_train_parity.py, with their reasons:
  * f32 apply / prefill logits: 5e-5 absolute, against JAX with
    ``attn_impl="interpret"`` (f32 summation order only; logits are O(1));
  * f32 decode logits: 2e-3 absolute: both packages keep the decode cache in
    bf16 and round decode's softmax weights to bf16, so a value on a bf16
    rounding boundary can land one bf16 ulp (2^-7 relative) apart;
  * bf16 logits: 0.3, the bound tests/test_models.py uses between two
    attention implementations in bf16;
  * loss: 1e-6 relative (f32 summation order), against ``jax.value_and_grad``
    of ``Model.loss`` with ``attn_impl="xla"``, the JAX trainer's path;
  * every gradient leaf, relative to that leaf's max |grad| (the smoke
    weights are large, ROADMAP queue 3): qwen3-8b and gemma3-12b 2e-5 (f32
    summation order; 3.2e-6 and 5.9e-6 measured); granite-3-8b 1e-4,
    because its smoke gradient, the one of the three without qk-norm, is
    ill-conditioned in f32: the port's own f32 gradient is 2.8e-5 from its
    f64 gradient and JAX's 3.3e-5 from it (measured), as far as the two
    packages are from each other (2.1e-5 to 3.3e-5 measured, by the number
    of torch threads).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.models import Ctx as JCtx, build_model as jax_build  # noqa: E402
from repro.train import DataConfig as JDataConfig, make_batch as jax_batch  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs.registry import ARCH_NAMES, get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import Model  # noqa: E402

ARCHS = ("qwen3-8b", "granite-3-8b", "gemma3-12b")
S, N_DEC, CACHE_LEN = 48, 8, 64      # S > gemma3-12b's smoke window 32: the ring is live
SEQ, BATCH = 48, 2                   # the loss batch
JINT = JCtx(attn_impl="interpret")
F32_ATOL, DECODE_ATOL, BF16_ATOL = 5e-5, 2e-3, 0.3
LOSS_RTOL = 1e-6
GRAD_RTOL = {"qwen3-8b": 2e-5, "granite-3-8b": 1e-4, "gemma3-12b": 2e-5}

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


def _jax_side(arch, **change):
    """(JAX config, model, bf16 params from Model.init, tokens), once per
    arch and change of config."""
    key = ("jax", arch, tuple(sorted(change.items())))
    if key not in _cache:
        jcfg = jax_config(arch, smoke=True).replace(**change)
        jm = jax_build(jcfg)
        params = jm.init(jax.random.PRNGKey(0))
        tokens = np.random.RandomState(1).randint(0, jcfg.vocab_size, (2, S + N_DEC))
        _cache[key] = jcfg, jm, params, tokens
    return _cache[key]


def _port(arch, params, dtype, trainable=False, **change):
    cfg = get_config(arch, smoke=True).replace(**change)
    m = Model(cfg, device="cpu", trainable=trainable)
    m.load_state_dict(from_jax_params(_np(params, dtype), cfg, device="cpu"),
                      strict=True, assign=True)
    return m


def _runs(arch, dtype):
    """{apply, prefill, decode0..}: logits of JAX and of the port on the
    same weights (cast to `dtype`, or bf16 as initialised for None)."""
    key = ("runs", arch, dtype)
    if key not in _cache:
        _, jm, params, tokens = _jax_side(arch)
        jp = params if dtype is None else jax.tree_util.tree_map(
            lambda x: x.astype(jnp.float32), params)
        jt = jnp.asarray(tokens)
        want = {"apply": jax.jit(lambda p, t: jm.apply(p, t, JINT)[0])(jp, jt[:, :S])}
        want["prefill"], cache = jax.jit(lambda p, t: jm.prefill(p, t, JINT, CACHE_LEN))(
            jp, jt[:, :S])
        decode = jax.jit(lambda p, t, c: jm.decode_step(p, t, c, JINT))
        for i in range(N_DEC):
            want[f"decode{i}"], cache = decode(jp, jt[:, S + i:S + i + 1], cache)
        m = _port(arch, params, dtype)
        t = torch.from_numpy(tokens)
        with torch.inference_mode():
            got = {"apply": m.apply(t[:, :S])}
            got["prefill"], cache = m.prefill(t[:, :S], CACHE_LEN)
            for i in range(N_DEC):
                got[f"decode{i}"], cache = m.decode_step(t[:, S + i:S + i + 1], cache)
        assert cache["pos"] == S + N_DEC
        _cache[key] = ({k: np.asarray(v, np.float32) for k, v in want.items()},
                       {k: v.float().numpy() for k, v in got.items()})
    return _cache[key]


def _loss_and_grads(arch, **change):
    """(JAX loss, its gradient as the port's flat dict, the port's loss, the
    port's model after backward) in f32 on the reference's batch."""
    key = ("loss", arch, tuple(sorted(change.items())))
    if key not in _cache:
        jcfg, jm, params, _ = _jax_side(arch, **change)
        p32 = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), params)
        batch = jax_batch(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=SEQ,
                                      global_batch=BATCH), 0)
        (jl, _), jg = jax.value_and_grad(
            lambda p, b: jm.loss(p, b, JCtx(attn_impl="xla")), has_aux=True)(p32, batch)
        m = _port(arch, params, np.float32, trainable=True, **change)
        tl, _ = m.loss({k: torch.from_numpy(np.array(v)).long() for k, v in batch.items()})
        tl.backward()
        cfg = get_config(arch, smoke=True).replace(**change)
        _cache[key] = float(jl), from_jax_params(_np(jg), cfg, device="cpu"), tl.item(), m
    return _cache[key]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# the configs
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
    """Every JAX leaf lands once, bit for bit, in bf16: the superblock's
    stacked leaves in their layers, the rest by name."""
    jcfg, _, params, _ = _jax_side(arch)
    state = _port(arch, params, None).state_dict()
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    assert sum(t.numel() for t in state.values()) == sum(x.size for _, x in leaves)
    nsb = len(jcfg.superblock)
    seen = set()
    for path, leaf in leaves:
        keys = [k.key for k in path]
        if keys[:2] == ["blocks", "sb"]:
            i = int(keys[2][len("slot"):])
            pairs = [(f"layers.{r * nsb + i}." + ".".join(keys[3:]), np.asarray(leaf)[r])
                     for r in range(jcfg.sb_repeat)]
        else:
            assert keys[0] != "blocks", keys        # none of the three has a remainder
            pairs = [(".".join(keys), np.asarray(leaf))]
        for name, want in pairs:
            t = state[name]
            seen.add(name)
            assert t.dtype == torch.bfloat16, name
            np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                          want.view(np.uint16), err_msg=name)
    assert seen == set(state)


# ---------------------------------------------------------------------------
# serving against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_f32_apply_matches_jax(arch):
    want, got = _runs(arch, np.float32)
    np.testing.assert_allclose(got["apply"], want["apply"], atol=F32_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_prefill_and_decode_match_jax(arch):
    want, got = _runs(arch, np.float32)
    np.testing.assert_allclose(got["prefill"], want["prefill"], atol=F32_ATOL)
    for i in range(N_DEC):
        np.testing.assert_allclose(got[f"decode{i}"], want[f"decode{i}"], atol=DECODE_ATOL,
                                   err_msg=f"decode step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_logits_match_jax(arch):
    want, got = _runs(arch, None)
    for key in want:
        err = np.abs(got[key] - want[key]).max()
        assert err < BF16_ATOL, f"{key}: {err}"


# ---------------------------------------------------------------------------
# training against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_jax(arch):
    jl, _, tl, _ = _loss_and_grads(arch)
    assert abs(tl - jl) <= LOSS_RTOL * abs(jl)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_gradient_leaf_matches_jax(arch):
    _, jg, _, m = _loss_and_grads(arch)
    names = dict(m.named_parameters())
    assert names.keys() == jg.keys()
    for k, p in names.items():
        assert p.grad is not None and p.grad.shape == jg[k].shape, k
        assert torch.isfinite(p.grad).all(), k
        err = _rel(p.grad.numpy(), jg[k].numpy())
        assert err <= GRAD_RTOL[arch], (k, err)


def test_odd_vocabulary_matches_jax():
    """granite-3-8b's vocabulary, 49,155, is odd: the tied unembedding writes
    logits with an odd last dimension, and the loss reduces over it. The
    smoke config with that vocabulary: f32 logits, loss and the embedding's
    gradient against JAX at the tolerances above."""
    arch, change = "granite-3-8b", {"vocab_size": get_config("granite-3-8b").vocab_size}
    assert change["vocab_size"] % 2 == 1
    _, jm, params, tokens = _jax_side(arch, **change)
    p32 = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), params)
    want = np.asarray(jm.apply(p32, jnp.asarray(tokens[:, :S]), JINT)[0], np.float32)
    with torch.inference_mode():
        got = _port(arch, params, np.float32, **change).apply(
            torch.from_numpy(tokens[:, :S])).numpy()
    assert got.shape == want.shape == (2, S, change["vocab_size"])
    np.testing.assert_allclose(got, want, atol=F32_ATOL)
    jl, jg, tl, m = _loss_and_grads(arch, **change)
    assert abs(tl - jl) <= LOSS_RTOL * abs(jl)
    table = dict(m.named_parameters())["embed.table"]
    assert table.shape[0] == change["vocab_size"]
    assert _rel(table.grad.numpy(), jg["embed.table"].numpy()) <= GRAD_RTOL[arch]


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
    """launch/train.py --smoke --device cpu: the attention layers train
    through ops.FlashAttention's plain backward."""
    log = launch_train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "3",
                             "--seq-len", "40", "--batch", "2", "--log-every", "1",
                             "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"])
    assert [m["step"] for m in log] == [0, 1, 2]
    assert all(np.isfinite(m["loss"]) for m in log)
