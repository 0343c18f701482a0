"""The port's RG-LRU against the JAX package: the kernel's plain version and
its ops entry, the doubling scan of the XLA path, the gates, the causal conv,
the recurrent block and its single-token decode.

Inputs come from a numpy seed; block weights are the JAX ``Model.init`` of
the recurrentgemma-9b smoke config (layer 0), bridged bit-exactly. The JAX
side reaches its Pallas kernel in interpret mode. Tolerances, with their
reasons:
  * ops.rglru_scan / the oracles against the JAX kernel and oracle: 1e-5,
    the bound of tests/test_kernels.py:57-67; the same sequential f32
    recurrence (XLA may fuse a*h + b into one rounding), |h| below ~1.
  * the CUDA kernel's arithmetic, emulated: the same 1e-5 on the sweep, and
    1e-5 x max(1, max |ref|) at ragged S and with a in (0.99, 1), the
    bounds chip_smoke.py holds the kernel to on the card. Within a chunk it
    is the oracle's arithmetic; each chunk boundary adds a few ulps of |h|.
  * rglru_scan_ref against JAX's associative scan and the oracle: 1e-5, as
    tests/test_kernels.py:70-77; products and sums taken in another order.
  * gates: a to 1e-5 relative. softplus(lambda) differs by up to one ulp
    (4.8e-7 at lambda ~ 6) between the libraries, and log a = -8 r
    softplus(lambda) reaches ~-46, so a differs by up to ~4e-6 relative.
    b to 2e-4 x max |u| absolute: where a lies within a few f32 ulps of 1,
    1 - exp(2 log a) cancels, and the libraries' exp, one ulp apart there
    (2^-24), move sqrt(1 - a^2) (i u) by up to ~1e-4 |u|. Layer 0 of the
    JAX smoke init has such channels: its stacked weights have fan-in 1,
    so w_a is O(1), u reaches ~70 and r ~ 0. Both libraries are then
    equally far from an f64 evaluation of the same formula.
  * block and decode in f32: 1e-3 x max |ref|, for the same reason: h sums
    those b over the sequence (measured: 3.1e-4 of max |h| after 48 steps,
    2.2e-5 of max |out|). Everything else is f32 summation order in the
    projections (64-128 terms), relative ~1e-6.
  * block and decode in bf16: 3e-2 x max |ref|. Each projection, the conv
    and the gelu branch round to bf16 (2^-8 relative); an element one ulp
    apart moves the gates and the product that w_o sums.
  * the conv history: exact (a bf16 copy of the same projections) in f32,
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
from repro.models import rglru as jrg  # noqa: E402
from repro_torch.bridge import _tensor  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import rglru as krg  # noqa: E402
from repro_torch.kernels.rglru import rglru_scan_fwd  # noqa: E402
from repro_torch.models import rglru  # noqa: E402
from repro_torch.models.layers import ParamSpec  # noqa: E402

JINT = JCtx(attn_impl="interpret")
SWEEP = [(100, 48, 32, 16), (64, 64, 64, 64), (33, 7, 8, 8)]   # test_kernels.py:57


def _sweep_inputs(S, C):
    """As tests/test_kernels.py builds them: a = 0.4 + 0.5 sigmoid(N),
    b = 0.1 N, from RandomState(2), B 2."""
    rng = np.random.RandomState(2)
    a = np.asarray(0.4 + 0.5 * jax.nn.sigmoid(
        jnp.asarray(rng.randn(2, S, C), jnp.float32)))
    b = (np.asarray(jnp.asarray(rng.randn(2, S, C), jnp.float32)) * 0.1)
    return a.astype(np.float32), b.astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ---------------------------------------------------------------------------
# the kernel's plain version and the ops entry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,C,bt,bc", SWEEP)
def test_rglru_oracle_matches_jax_oracle(S, C, bt, bc):
    a, b = _sweep_inputs(S, C)
    h = ref.rglru_scan_oracle(*_t(a, b))
    assert h.dtype == torch.float32 and h.shape == (2, S, C)
    np.testing.assert_allclose(h.numpy(), np.asarray(jref.rglru_scan_oracle(
        jnp.asarray(a), jnp.asarray(b))), atol=1e-5)


@pytest.mark.parametrize("S,C,bt,bc", SWEEP)
def test_ops_rglru_scan_cpu_matches_jax_kernel(S, C, bt, bc):
    a, b = _sweep_inputs(S, C)
    before = rglru_scan_fwd.launches
    h = ops.rglru_scan(*_t(a, b))
    assert rglru_scan_fwd.launches == before       # the CPU path launches nothing
    hj = jops.rglru_scan(jnp.asarray(a), jnp.asarray(b), interpret=True,
                         block_t=bt, block_c=bc)
    hr = jref.rglru_scan_oracle(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), atol=1e-5)


def test_ops_rglru_scan_casts_to_f32_like_the_tpu_kernel():
    a, b = (t.bfloat16() for t in _t(*_sweep_inputs(20, 8)))
    h = ops.rglru_scan(a, b)
    assert h.dtype == torch.float32
    np.testing.assert_array_equal(
        h.numpy(), ref.rglru_scan_oracle(a.float(), b.float()).numpy())


def test_rglru_oracle_of_empty_sequence():
    assert ref.rglru_scan_oracle(torch.ones(2, 0, 3), torch.ones(2, 0, 3)).shape \
        == (2, 0, 3)


# ---------------------------------------------------------------------------
# the XLA path's scan: a log-depth doubling scan in the port
# ---------------------------------------------------------------------------

def _assoc_inputs():
    """The case of tests/test_kernels.py:70-77: a = sigmoid(N), b = N."""
    rng = np.random.RandomState(3)
    a = np.asarray(jax.nn.sigmoid(jnp.asarray(rng.randn(2, 50, 16), jnp.float32)))
    b = rng.randn(2, 50, 16).astype(np.float32)
    return a, b


def test_rglru_scan_ref_matches_jax_and_oracle():
    a, b = _assoc_inputs()
    h = rglru.rglru_scan_ref(*_t(a, b))
    np.testing.assert_allclose(h.numpy(), np.asarray(jrg.rglru_scan_ref(
        jnp.asarray(a), jnp.asarray(b))), atol=1e-5)
    np.testing.assert_allclose(h.numpy(), ref.rglru_scan_oracle(*_t(a, b)).numpy(),
                               atol=1e-5)


def test_rglru_scan_ref_with_h0_matches_jax_and_oracle():
    """h0 enters as one step before the sequence: h_{-1} = h0."""
    a, b = _assoc_inputs()
    h0 = np.random.RandomState(4).randn(2, 16).astype(np.float32)
    h = rglru.rglru_scan_ref(*_t(a, b, h0))
    want = jrg.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    np.testing.assert_allclose(h.numpy(), np.asarray(want), atol=1e-5)
    a1 = np.concatenate([np.zeros_like(a[:, :1]), a], axis=1)
    b1 = np.concatenate([h0[:, None], b], axis=1)
    np.testing.assert_allclose(
        h.numpy(), ref.rglru_scan_oracle(*_t(a1, b1))[:, 1:].numpy(), atol=1e-5)


@pytest.mark.parametrize("S", [1, 2, 7])
def test_rglru_scan_ref_short_sequences(S):
    a, b = (x[:, :S] for x in _assoc_inputs())
    np.testing.assert_allclose(rglru.rglru_scan_ref(*_t(a, b)).numpy(),
                               ref.rglru_scan_oracle(*_t(a, b)).numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# the kernel wrapper's refusals (no card here)
# ---------------------------------------------------------------------------

def test_kernel_on_cpu_tensor_raises():
    a, b = _t(*_sweep_inputs(8, 4))
    with pytest.raises(ValueError, match="CUDA"):
        rglru_scan_fwd(a, b)


@pytest.mark.parametrize("a,b,match", [
    (torch.zeros(1, 4, 8, dtype=torch.bfloat16, device="meta"),
     torch.zeros(1, 4, 8, dtype=torch.bfloat16, device="meta"), "float32"),
    (torch.zeros(1, 4, 8, device="meta"), torch.zeros(1, 5, 8, device="meta"),
     "one shape"),
    (torch.zeros(4, 8, device="meta"), torch.zeros(4, 8, device="meta"), "one shape"),
])
def test_kernel_refuses_what_it_does_not_take(monkeypatch, a, b, match):
    """Past the device check (a meta tensor posing as a CUDA one), the wrapper
    refuses other dtypes and shapes before it builds or launches anything."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(build, "load", lambda name: pytest.fail("built a library"))
    with pytest.raises(ValueError, match=match):
        rglru_scan_fwd(a, b)


def test_ops_rglru_scan_rejects_other_devices():
    x = torch.zeros(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.rglru_scan(x, x)


# ---------------------------------------------------------------------------
# the kernel's arithmetic (csrc/rglru.cu), emulated on the CPU
# ---------------------------------------------------------------------------

def test_chunk_is_the_kernels():
    src = (build.CSRC / "rglru.cu").read_text()
    assert f"constexpr int T = {krg.CHUNK};" in src


def _emulated(a, b, T=krg.CHUNK):
    """The chained scan's arithmetic: per chunk of T steps the product of the
    a's and the end state from h = 0, each step a * h then + b, rounded
    apart; the carry into the next chunk, prod * h_in + end state, rounded
    the same way; the chunk's outputs from h_in."""
    B, S, C = a.shape
    h = torch.empty_like(a)
    h_in = torch.zeros(B, C)
    for k0 in range(0, S, T):
        ac, bc = a[:, k0:k0 + T], b[:, k0:k0 + T]
        prod, end = torch.ones(B, C), torch.zeros(B, C)
        x = h_in
        for t in range(ac.shape[1]):
            end = ac[:, t] * end + bc[:, t]
            prod = prod * ac[:, t]
            x = ac[:, t] * x + bc[:, t]
            h[:, k0 + t] = x
        h_in = prod * h_in + end
    return h


@pytest.mark.parametrize("S,C,bt,bc", SWEEP)
def test_emulated_kernel_matches_oracles_and_jax_kernel(S, C, bt, bc):
    a, b = _sweep_inputs(S, C)
    h = _emulated(*_t(a, b))
    hj = jops.rglru_scan(jnp.asarray(a), jnp.asarray(b), interpret=True,
                         block_t=bt, block_c=bc)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(jref.rglru_scan_oracle(
        jnp.asarray(a), jnp.asarray(b))), atol=1e-5)
    np.testing.assert_allclose(h.numpy(), ref.rglru_scan_oracle(*_t(a, b)).numpy(),
                               atol=1e-5)


def _near_one_inputs(S, C):
    """a in (0.99, 1), b = 0.1 N: h carries across many chunks."""
    rng = np.random.RandomState(7)
    a = (1.0 - 0.01 / (1.0 + np.exp(-rng.randn(2, S, C)))).astype(np.float32)
    return a, (rng.randn(2, S, C) * 0.1).astype(np.float32)


@pytest.mark.parametrize("S,C,near_one", [(63, 16, False), (64, 16, False),
                                          (65, 16, False), (2049, 16, False),
                                          (2048, 64, True)])
def test_emulated_kernel_across_chunks(S, C, near_one):
    """One short of a chunk, one chunk, one past it, one past 32 chunks;
    and 32 chunks with a in (0.99, 1), where every carry matters."""
    a, b = _near_one_inputs(S, C) if near_one else _sweep_inputs(S, C)
    want = ref.rglru_scan_oracle(*_t(a, b))
    scale = max(1.0, float(want.abs().max()))
    h = _emulated(*_t(a, b))
    assert float((h - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("B,S,C,words", [
    (4, 2048, 4096, 4 * 31 * 4096),     # the recurrentgemma-9b serving shape
    (1, 16384, 4096, 255 * 4096),
    (2, 65, 130, 2 * 130),
    (2, 64, 130, 0), (1, 1, 7, 0),      # one chunk: the counter alone
])
def test_scratch_floats_hold_the_counter_and_a_word_per_handoff(B, S, C, words):
    """8 bytes of tile counter, then one 8-byte word per (b, chunk, channel)
    for every chunk but the last; 4.06 MB at the serving shape."""
    assert krg.scratch_floats(B, S, C) == 2 * (1 + words)
    if (B, S, C) == (4, 2048, 4096):
        assert 4 * krg.scratch_floats(B, S, C) == 4_063_240


def test_library_path_of_rglru():
    p = build.library_path("rglru")
    assert p.parent == build.BUILD_DIR and p.name.startswith("rglru-")
    assert (build.CSRC / "rglru.cu").exists()


# ---------------------------------------------------------------------------
# the rglru_a init
# ---------------------------------------------------------------------------

def test_rglru_a_init_is_seeded_and_in_range():
    spec = ParamSpec((4096,), init="rglru_a", dtype=torch.float32)
    a = spec.materialize(torch.Generator().manual_seed(5), "cpu")
    assert torch.equal(a, spec.materialize(torch.Generator().manual_seed(5), "cpu"))
    assert not torch.equal(a, spec.materialize(torch.Generator().manual_seed(6), "cpu"))
    lo, hi = np.log(0.9 / 0.1), np.log(0.999 / 0.001)
    assert a.dtype == torch.float32
    assert lo - 1e-5 <= float(a.min()) and float(a.max()) <= hi + 1e-5
    # u = sigmoid(lambda) is uniform on [0.9, 0.999): its mean is near 0.9495
    assert abs(float(torch.sigmoid(a).mean()) - 0.9495) < 2e-3


# ---------------------------------------------------------------------------
# gates, conv, block and decode against JAX on bridged weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mixer():
    """Layer 0's mixer weights of JAX Model.init (recurrentgemma-9b smoke)."""
    jcfg = jax_config("recurrentgemma-9b", smoke=True)
    params = jax_build(jcfg).init(jax.random.PRNGKey(0))
    p = jax.tree_util.tree_map(lambda a: a[0],
                               params["blocks"]["sb"]["slot0"]["mixer"])
    return jcfg, get_config("recurrentgemma-9b", smoke=True), p


def _cast(p, dtype):
    """bf16 leaves to `dtype` (the f32 gate parameters stay f32, as in the model)."""
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


DTYPES = {"float32": (jnp.float32, 1e-3), "bfloat16": (jnp.bfloat16, 3e-2)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rglru_gates_match_jax(mixer, dtype):
    _, _, p = mixer
    jdt, _ = DTYPES[dtype]
    u = jnp.asarray(np.random.RandomState(5).randn(2, 9, p["w_a"].shape[0]) * 3, jdt)
    aj, bj = jrg.rglru_gates(u, p)
    at, bt = rglru.rglru_gates(_tensor(np.asarray(u), "cpu"), _port(p))
    assert at.dtype == bt.dtype == torch.float32
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-5, atol=0)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=0,
                               atol=2e-4 * float(jnp.abs(u).max()))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_causal_conv_matches_jax(mixer, dtype):
    """One causal conv serves the SSD and the RG-LRU blocks in the port."""
    _, _, p = mixer
    jdt, _ = DTYPES[dtype]
    p = _cast(p, jdt)
    x = jnp.asarray(np.random.RandomState(2).randn(2, 9, p["conv_w"].shape[1]), jdt)
    want = jrg._causal_conv(x, p["conv_w"], p["conv_b"])
    got = rglru._causal_conv(_tensor(np.asarray(x), "cpu"),
                             *_port({"w": p["conv_w"], "b": p["conv_b"]}).values())
    assert got.dtype == getattr(torch, dtype)
    # shifted adds in the same order and dtype: the same roundings
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("S", [48, 2])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_block_apply_and_decode_match_jax(mixer, dtype, S):
    """Prefill over S tokens (2: shorter than conv_width - 1, so the conv
    history is padded on the left), then two decode steps from the JAX cache."""
    jcfg, cfg, p = mixer
    jdt, rtol = DTYPES[dtype]
    pj = _cast(p, jdt)
    pt = _port(pj)
    rng = np.random.RandomState(3)
    xj = jnp.asarray(rng.randn(2, S, cfg.d_model), jdt)

    oj, cj = jrg.rglru_block_apply(pj, xj, jcfg, JINT, collect_cache=True)
    with torch.inference_mode():
        ot, ct = rglru.rglru_block_apply(pt, _tensor(np.asarray(xj), "cpu"), cfg,
                                         None, collect_cache=True)
    assert ot.dtype == getattr(torch, dtype)
    _close(ot, oj, rtol, "apply")
    assert ct["h"].dtype == torch.float32 and ct["conv"].dtype == torch.bfloat16
    assert ct["h"].shape == (2, cfg.d_rnn)
    assert ct["conv"].shape == (2, cfg.rglru_conv_width - 1, cfg.d_rnn)
    _close(ct["h"], cj["h"], rtol, "h")
    if dtype == "float32":
        np.testing.assert_array_equal(ct["conv"].float().numpy(),
                                      np.asarray(cj["conv"], np.float32))
    if S < cfg.rglru_conv_width - 1:
        assert not ct["conv"][:, :cfg.rglru_conv_width - 1 - S].any()

    cache = {k: _tensor(np.asarray(v), "cpu") for k, v in cj.items()}
    h_buf = cache["h"]
    for step in range(2):
        x1j = jnp.asarray(rng.randn(2, 1, cfg.d_model), jdt)
        dj, cj = jrg.rglru_block_decode(pj, x1j, cj, jcfg, JINT)
        with torch.inference_mode():
            dt_, cache = rglru.rglru_block_decode(
                pt, _tensor(np.asarray(x1j), "cpu"), cache, cfg, None)
        assert dt_.shape == (2, 1, cfg.d_model) and dt_.dtype == ot.dtype
        assert cache["h"] is h_buf                       # updated in place
        _close(dt_, dj, rtol, f"decode {step}")
        _close(cache["h"], cj["h"], rtol, f"decode {step} h")
        np.testing.assert_array_equal(cache["conv"].float().numpy(),
                                      np.asarray(cj["conv"], np.float32))


def test_prefill_cache_holds_no_view_of_the_sequence(mixer):
    _, cfg, p = mixer
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        _, c = rglru.rglru_block_apply(_port(_cast(p, jnp.float32)), x, cfg, None,
                                       collect_cache=True)
    for t in c.values():
        assert t.is_contiguous() and t.untyped_storage().nbytes() == t.nbytes


def test_init_rglru_cache_matches_jax_specs():
    from repro.models.model import init_layer_cache_specs as jspecs
    from repro_torch.models.model import init_layer_cache_specs
    cfg = get_config("recurrentgemma-9b", smoke=True)
    want = jspecs(jax_config("recurrentgemma-9b", smoke=True), "rglru", 3, 64)["mixer"]
    got = init_layer_cache_specs(cfg, "rglru", 3, 64)["mixer"]
    for name in ("h", "conv"):
        assert got[name].shape == want[name].shape
        assert str(got[name].dtype).split(".")[-1] == jnp.dtype(want[name].dtype).name
        assert got[name].init == want[name].init == "zeros"


def test_rglru_specs_match_jax():
    from repro.models.rglru import rglru_specs as jspecs
    cfg = get_config("recurrentgemma-9b", smoke=True)
    want = jspecs(jax_config("recurrentgemma-9b", smoke=True))
    got = rglru.rglru_specs(cfg)
    assert sorted(got) == sorted(want)
    for name, spec in got.items():
        assert spec.shape == want[name].shape, name
        assert spec.init == want[name].init, name
        assert str(spec.dtype).split(".")[-1] == jnp.dtype(want[name].dtype).name, name
