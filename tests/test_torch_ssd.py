"""The port's Mamba2 SSD against the JAX package: the kernel's plain version
and its ops entry, the chunked XLA-path scan, the causal conv, the mixer
block and its single-token decode.

Inputs come from a numpy seed; block weights are the JAX ``Model.init`` of
the mamba2-780m smoke config (layer 0), bridged bit-exactly. The JAX side
reaches its Pallas kernel in interpret mode. Tolerances, with their reasons:
  * ops.ssd / ssd_chunked against the JAX kernel and the oracle: 2e-3, the
    bound of tests/test_kernels.py between the chunked and the sequential
    forms (exponentials of cumulative sums taken in another order).
  * oracle against oracle: 1e-5, the same sequential recurrence in f32 with
    sums of n <= 8 terms in another order; |y| stays below ~12 here.
  * block and decode in f32: 1e-5 x max |ref|. The smoke weights are stacked
    in JAX, so their fan-in is the layer count and the outputs reach ~5e4;
    what differs is f32 summation order (projections over 64-128 terms, the
    SSD sums), relative ~1e-6.
  * block and decode in bf16: 3e-2 x max |ref|. Each projection, the conv
    and the gate round to bf16 (2^-8 relative); an element one ulp apart
    feeds the SSD sums of later positions.
  * the conv history: exact in f32 (a bf16 copy of the same f32 projections)
    and after a decode step (the history shifted by one token).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.models import Ctx as JCtx, build_model as jax_build  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.bridge import _tensor  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels.ssd import ssd_fwd  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

JINT = JCtx(attn_impl="interpret")


def _ssd_inputs(seed, b, s, h, p, n):
    """As tests/test_kernels.py builds them: x ~ N(0,1), dt = softplus(N),
    A = -exp(0.3 N), B/C = 0.5 N."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, h, p).astype(np.float32)
    dt = np.asarray(jax.nn.softplus(jnp.asarray(rng.randn(b, s, h), jnp.float32)))
    A = np.asarray(-jnp.exp(jnp.asarray(rng.randn(h), jnp.float32) * 0.3))
    B = (rng.randn(b, s, n) * 0.5).astype(np.float32)
    C = (rng.randn(b, s, n) * 0.5).astype(np.float32)
    return x, dt, A, B, C


def _t(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


SWEEP = [(80, 32), (64, 64), (96, 16)]        # tests/test_kernels.py:80


# ---------------------------------------------------------------------------
# the kernel's plain version and the ops entry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,chunk", SWEEP)
def test_ssd_oracle_matches_jax_oracle(s, chunk):
    args = _ssd_inputs(4, 2, s, 3, 16, 8)
    y, sf = ref.ssd_oracle(*_t(args))
    yj, sfj = jref.ssd_oracle(*_j(args))
    assert y.dtype == sf.dtype == torch.float32
    assert y.shape == (2, s, 3, 16) and sf.shape == (2, 3, 8, 16)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=1e-5)
    np.testing.assert_allclose(sf.numpy(), np.asarray(sfj), atol=1e-5)


@pytest.mark.parametrize("s,chunk", SWEEP)
def test_ops_ssd_cpu_matches_jax_kernel(s, chunk):
    args = _ssd_inputs(4, 2, s, 3, 16, 8)
    before = ssd_fwd.launches
    y, sf = ops.ssd(*_t(args), chunk=chunk)
    assert ssd_fwd.launches == before            # the CPU path launches nothing
    yj, sfj = jops.ssd(*_j(args), chunk=chunk, interpret=True)
    yr, sfr = jref.ssd_oracle(*_j(args))
    for got, want in ((y, yj), (sf, sfj), (y, yr), (sf, sfr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3)


def test_ops_ssd_casts_to_f32_like_the_tpu_kernel():
    args = _ssd_inputs(5, 1, 20, 2, 16, 8)
    y, sf = ops.ssd(*(t.bfloat16() for t in _t(args)), chunk=8)
    assert y.dtype == sf.dtype == torch.float32
    want = ref.ssd_oracle(*(t.bfloat16().float() for t in _t(args)))
    np.testing.assert_allclose(y.numpy(), want[0].numpy(), atol=1e-6)


def test_ssd_chunked_matches_jax_and_oracle():
    """The case of tests/test_kernels.py:95 (s 48, chunk 16)."""
    args = _ssd_inputs(5, 1, 48, 2, 8, 4)
    y, sf = ssm.ssd_chunked(*_t(args), 16)
    yj, sfj = jssm.ssd_chunked(*_j(args), 16)
    yr, sfr = ref.ssd_oracle(*_t(args))
    for got, want in ((y, np.asarray(yj)), (sf, np.asarray(sfj)),
                      (y, yr.numpy()), (sf, sfr.numpy())):
        np.testing.assert_allclose(got.numpy(), want, atol=2e-3)


def test_ssd_chunked_ragged_matches_oracle():
    """s not a multiple of the chunk: padded rows leave S_final unchanged."""
    args = _ssd_inputs(6, 2, 50, 3, 16, 8)
    y, sf = ssm.ssd_chunked(*_t(args), 16)
    yr, sfr = ref.ssd_oracle(*_t(args))
    assert y.shape == yr.shape
    np.testing.assert_allclose(y.numpy(), yr.numpy(), atol=2e-3)
    np.testing.assert_allclose(sf.numpy(), sfr.numpy(), atol=2e-3)


# ---------------------------------------------------------------------------
# the kernel wrapper's refusals (no card here)
# ---------------------------------------------------------------------------

def test_kernel_on_cpu_tensor_raises():
    x, dt, A, B, C = _t(_ssd_inputs(7, 1, 8, 2, 16, 8))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_fwd(x, dt, A, B, C)


def test_ops_ssd_rejects_other_devices():
    x = torch.zeros(1, 4, 2, 16, device="meta")
    dt = torch.zeros(1, 4, 2, device="meta")
    A = torch.zeros(2, device="meta")
    B = torch.zeros(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.ssd(x, dt, A, B, B)


def test_library_path_of_ssd():
    p = build.library_path("ssd")
    assert p.parent == build.BUILD_DIR and p.name.startswith("ssd-")
    assert (build.CSRC / "ssd.cu").exists()


# ---------------------------------------------------------------------------
# conv, block and decode against JAX on bridged weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mixer():
    """Layer 0's mixer weights of JAX Model.init (mamba2-780m smoke)."""
    jcfg = jax_config("mamba2-780m", smoke=True)
    params = jax_build(jcfg).init(jax.random.PRNGKey(0))
    p = jax.tree_util.tree_map(lambda a: a[0], params["blocks"]["sb"]["slot0"]["mixer"])
    return jcfg, get_config("mamba2-780m", smoke=True), p


def _cast(p, dtype):
    """bf16 leaves to `dtype` (the f32 scalars stay f32, as in the model)."""
    return jax.tree_util.tree_map(
        lambda a: a.astype(dtype) if a.dtype == jnp.bfloat16 else a, p)


def _port(tree):
    return {k: _tensor(np.asarray(v), "cpu") for k, v in tree.items()}


def _close(got, want, rtol_of_max, what):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape, what
    assert err <= rtol_of_max * scale, f"{what}: {err} > {rtol_of_max} x {scale}"


DTYPES = {"float32": (jnp.float32, 1e-5), "bfloat16": (jnp.bfloat16, 3e-2)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_causal_conv_matches_jax(mixer, dtype):
    jcfg, _, p = mixer
    jdt, _ = DTYPES[dtype]
    p = _cast(p, jdt)
    x = jnp.asarray(np.random.RandomState(2).randn(2, 9, p["conv_w"].shape[1]), jdt)
    want = jssm._causal_conv(x, p["conv_w"], p["conv_b"])
    got = ssm._causal_conv(_tensor(np.asarray(x), "cpu"), *_port(
        {"w": p["conv_w"], "b": p["conv_b"]}).values())
    assert got.dtype == getattr(torch, dtype)
    # shifted adds in the same order and dtype: the same roundings
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("S", [48, 2])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_block_apply_and_decode_match_jax(mixer, dtype, S):
    """Prefill over S tokens (48: one chunk boundary of 32 and padding;
    2: shorter than conv_width - 1, so the conv history is padded on the
    left), then one decode step from the JAX cache."""
    jcfg, cfg, p = mixer
    jdt, rtol = DTYPES[dtype]
    pj = _cast(p, jdt)
    pt = _port(pj)
    rng = np.random.RandomState(3)
    xj = jnp.asarray(rng.randn(2, S, cfg.d_model), jdt)
    x1j = jnp.asarray(rng.randn(2, 1, cfg.d_model), jdt)

    oj, cj = jssm.ssd_block_apply(pj, xj, jcfg, JINT, collect_cache=True)
    with torch.inference_mode():
        ot, ct = ssm.ssd_block_apply(pt, _tensor(np.asarray(xj), "cpu"), cfg,
                                     None, collect_cache=True)
    assert ot.dtype == getattr(torch, dtype)
    _close(ot, oj, rtol, "apply")
    assert ct["state"].dtype == torch.float32 and ct["conv"].dtype == torch.bfloat16
    assert ct["conv"].shape == (2, cfg.conv_width - 1, cfg.d_inner + 2 * cfg.ssm_state)
    _close(ct["state"], cj["state"], rtol, "state")
    if dtype == "float32":
        np.testing.assert_array_equal(ct["conv"].float().numpy(),
                                      np.asarray(cj["conv"], np.float32))
    if S < cfg.conv_width - 1:
        assert not ct["conv"][:, :cfg.conv_width - 1 - S].any()

    dj, ncj = jssm.ssd_block_decode(pj, x1j, cj, jcfg, JINT)
    cache = {k: _tensor(np.asarray(v), "cpu") for k, v in cj.items()}
    state_buf = cache["state"]
    with torch.inference_mode():
        dt_, nct = ssm.ssd_block_decode(pt, _tensor(np.asarray(x1j), "cpu"),
                                        cache, cfg, None)
    assert dt_.shape == (2, 1, cfg.d_model)
    assert nct["state"] is state_buf                    # updated in place
    _close(dt_, dj, rtol, "decode")
    _close(nct["state"], ncj["state"], rtol, "decode state")
    np.testing.assert_array_equal(nct["conv"].float().numpy(),
                                  np.asarray(ncj["conv"], np.float32))


def test_init_ssd_cache_matches_jax_specs():
    from repro.models.model import init_layer_cache_specs as jspecs
    from repro_torch.models.model import init_layer_cache_specs
    cfg = get_config("mamba2-780m", smoke=True)
    want = jspecs(jax_config("mamba2-780m", smoke=True), "ssd", 3, 64)["mixer"]
    got = init_layer_cache_specs(cfg, "ssd", 3, 64)["mixer"]
    for name in ("state", "conv"):
        assert got[name].shape == want[name].shape
        assert str(got[name].dtype).split(".")[-1] == jnp.dtype(want[name].dtype).name
        assert got[name].init == want[name].init == "zeros"
