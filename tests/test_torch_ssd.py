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


# (b, s, h, p, n, chunk) -> Q, nc, Qp: the serving shape (C B^T 8.4 MB), a
# chunk shorter than one tile, a ragged single chunk, a one-row tail
SCRATCH = [((4, 2048, 48, 64, 128, 256), (256, 8, 256)),
           ((1, 1, 4, 64, 128, 256), (1, 1, 64)),
           ((1, 100, 4, 64, 128, 256), (100, 1, 128)),
           ((1, 2049, 4, 64, 128, 256), (256, 9, 256))]


@pytest.mark.parametrize("dims,want", SCRATCH, ids=lambda v: str(v))
def test_scratch_shapes_follow_b_nc_q(dims, want):
    """Per head the chunk states, cum and decay; C B^T once per (b, chunk),
    not per head, in whole 64-row tiles."""
    from repro_torch.kernels import ssd as kssd
    b, s, h, p, n, chunk = dims
    Q, nc, Qp = want
    got = kssd.scratch_shapes(*dims)
    assert got == {"states": (b, h, nc, n, p), "cum": (b, h, nc, Q), "decay": (b, h, nc),
                   "cb": (b, nc, Qp, Qp)}
    if dims[1] == 2048:
        assert 4 * int(np.prod(got["cb"])) == 8_388_608     # 8.4 MB, in L2


def test_scratch_tile_is_the_kernels():
    from repro_torch.kernels import ssd as kssd
    src = (build.CSRC / "ssd.cu").read_text()
    assert f"constexpr int TQ = {kssd.TILE};" in src


# ---------------------------------------------------------------------------
# the kernel's numerics: 3xTF32 products, emulated on the CPU
# ---------------------------------------------------------------------------

def _tf32(a, mode):
    """Round f32 to TF32 (10 mantissa bits) through an int32 view: "rn" to
    nearest even (cvt.rn.tf32.f32, what the kernel uses), "rna" ties away."""
    i = a.contiguous().view(torch.int32)
    i = i + (0x1000 if mode == "rna" else 0xFFF + ((i >> 13) & 1))
    return (i & ~0x1FFF).view(torch.float32)


def _mm(spec, a, b, mode):
    """einsum in f32 of TF32 operands: plain TF32 (mode "tf32"), or 3xTF32
    (small.big + big.small + big.big, each operand split as big = tf32(a),
    small = tf32(a - big)) with "rn" or "rna" rounding."""
    if mode == "tf32":
        return torch.einsum(spec, _tf32(a, "rn"), _tf32(b, "rn"))
    ab, bb = _tf32(a, mode), _tf32(b, mode)
    as_, bs = _tf32(a - ab, mode), _tf32(b - bb, mode)
    return (torch.einsum(spec, as_, bb) + torch.einsum(spec, ab, bs)
            + torch.einsum(spec, ab, bb))


def _ssd_emulated(x, dt, A, B, C, chunk, mode):
    """ssd_chunked with every product on TF32 operands, in the kernel's
    factoring: cb = C B^T; y = scores . x + (exp(cum) C) . S_prev; the
    chunk state B^T (w x)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    pad = (-s) % chunk
    x, dt = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad)), \
        torch.nn.functional.pad(dt, (0, 0, 0, pad))
    B, C = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (B, C))
    nc = (s + pad) // chunk
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc, Cc = B.reshape(b, nc, chunk, n), C.reshape(b, nc, chunk, n)
    cum = torch.cumsum(dtc * A, dim=2)                                  # (b,nc,Q,h)
    cb = _mm("bcin,bcjn->bcij", Cc, Bc, mode)
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    scores = torch.where(causal[None, None, :, :, None],
                         cb[..., None] * torch.exp(seg) * dtc[:, :, None], 0.0)
    y = _mm("bcijh,bcjhp->bcihp", scores, xc, mode)
    w = dtc * torch.exp(cum[:, :, -1:] - cum)                          # (b,nc,Q,h)
    S_c = _mm("bcjn,bcjhp->bchnp", Bc, xc * w[..., None], mode)
    decay = torch.exp(cum[:, :, -1])
    S_run, S_prev = torch.zeros(b, h, n, p), []
    for c in range(nc):
        S_prev.append(S_run)
        S_run = S_run * decay[:, c, :, None, None] + S_c[:, c]
    S_prev = torch.stack(S_prev, dim=1)
    Cs = Cc[:, :, :, None, :] * torch.exp(cum)[..., None]              # (b,nc,Q,h,n)
    y = y + _mm("bcihn,bchnp->bcihp", Cs, S_prev, mode)
    return y.reshape(b, s + pad, h, p)[:, :s], S_run


# the sweep (b 2, h 3, p 16, n 8) and one mid shape at the served widths
NUMERICS = [(mode, s, chunk, (2, 3, 16, 8)) for mode in ("rn", "rna", "tf32")
            for s, chunk in SWEEP]
NUMERICS += [(mode, 512, 256, (1, 4, 64, 128)) for mode in ("rn", "rna")]


@pytest.mark.parametrize("mode,s,chunk,dims", NUMERICS,
                         ids=lambda v: str(v) if not isinstance(v, tuple) else "x".join(map(str, v)))
def test_tf32_products_against_the_oracle(mode, s, chunk, dims):
    """3xTF32 products keep the 2e-3 tolerance of the sweep (absolute) and
    of the served widths (x max |ref|); plain TF32 misses it on every sweep
    case, which is why the kernel splits each operand."""
    b, h, p, n = dims
    args = _t(_ssd_inputs(4, b, s, h, p, n))
    y, sf = _ssd_emulated(*args, chunk, mode)
    yr, sfr = ref.ssd_oracle(*args)
    err = max((y - yr).abs().max().item(), (sf - sfr).abs().max().item())
    scale = 1.0 if dims == (2, 3, 16, 8) else max(1.0, yr.abs().max().item())
    if mode == "tf32":
        assert err > 2e-3
    else:
        assert err <= 2e-3 * scale, (err, scale)


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
