"""K3's backward on the CPU: the plain backward (``ref.rglru_scan_bwd_oracle``)
against autograd of the plain forward and against ``jax.grad`` of the JAX
package's oracle; the kernel's reverse chained arithmetic emulated on the
CPU; ``ops.rglru_scan`` under autograd; the CUDA wrapper's refusals and
scratch.

Inputs come from a numpy seed: the sweep's distribution of
tests/test_kernels.py (a = 0.4 + 0.5 sigmoid(N), b = 0.1 N) and a in
(0.99, 1), where g carries across hundreds of steps and so across many time
chunks. Tolerances, with their reasons:
  * plain backward vs autograd of the plain forward, float64: 1e-12 x
    max(1, max |ref|); the same products and sums, one order (measured 0);
  * vs jax.grad of the JAX oracle, f32: 1e-5 x max(1, max |ref|), the
    forward's bound (tests/test_kernels.py:57-67); XLA's reverse scan may
    fuse a * g + dh into one rounding;
  * the kernel's arithmetic, emulated: bit-equal to the plain backward
    within one chunk, where no carry enters; 1e-5 x max(1, max |ref|)
    across chunks, the bound chip_smoke.py holds the kernel to on the card:
    each chunk boundary adds a few ulps of |g|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import rglru as krg  # noqa: E402
from repro_torch.kernels.rglru import rglru_scan_bwd, rglru_scan_fwd  # noqa: E402

RAGGED = [1, 63, 64, 65, 130]


def _inputs(S, C, near_one, dtype=np.float32, seed=11):
    """a, b, dh (2, S, C) from a numpy seed."""
    rng = np.random.RandomState(seed)
    s = 1.0 / (1.0 + np.exp(-rng.randn(2, S, C)))
    a = 1.0 - 0.01 * s if near_one else 0.4 + 0.5 * s
    return [x.astype(dtype) for x in (a, 0.1 * rng.randn(2, S, C), rng.randn(2, S, C))]


def _t(*arrays):
    return [torch.from_numpy(np.array(x)) for x in arrays]


def _rel(got, want):
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


# ---------------------------------------------------------------------------
# the plain backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("near_one", [False, True], ids=["sweep", "a_near_one"])
@pytest.mark.parametrize("S", RAGGED)
def test_plain_backward_matches_autograd_in_f64(S, near_one):
    a, b, dh = _t(*_inputs(S, 16, near_one, np.float64))
    a.requires_grad_()
    b.requires_grad_()
    h = ref.rglru_scan_oracle(a, b)
    want = torch.autograd.grad(h, (a, b), dh)
    got = ref.rglru_scan_bwd_oracle(a.detach(), h.detach(), dh)
    for x, y in zip(got, want):
        assert x.dtype == torch.float64 and x.shape == y.shape
        assert _rel(x, y) <= 1e-12
    assert float(got[0][:, 0].abs().max()) == 0.0           # da_0 = g_0 h_{-1} = 0


@pytest.mark.parametrize("near_one", [False, True], ids=["sweep", "a_near_one"])
@pytest.mark.parametrize("S", RAGGED)
def test_plain_backward_matches_jax_grad(S, near_one):
    a, b, dh = _inputs(S, 16, near_one)
    h, vjp = jax.vjp(jref.rglru_scan_oracle, jnp.asarray(a), jnp.asarray(b))
    want = vjp(jnp.asarray(dh))
    got = ref.rglru_scan_bwd_oracle(*_t(a, np.asarray(h), dh))
    for x, y in zip(got, want):
        assert x.dtype == torch.float32
        assert _rel(x, torch.from_numpy(np.array(y))) <= 1e-5


def test_plain_backward_of_empty_sequence():
    z = torch.zeros(2, 0, 3)
    da, db = ref.rglru_scan_bwd_oracle(z, z, z)
    assert da.shape == db.shape == (2, 0, 3)


# ---------------------------------------------------------------------------
# the kernel's arithmetic (csrc/rglru_bwd.cu), emulated on the CPU
# ---------------------------------------------------------------------------

def test_chunk_and_tile_are_the_forwards():
    fwd = (build.CSRC / "rglru.cu").read_text()
    bwd = (build.CSRC / "rglru_bwd.cu").read_text()
    for line in (f"constexpr int T = {krg.CHUNK};", "constexpr int NTHREADS = 128;"):
        assert line in fwd and line in bwd


def _emulated_bwd(a, h, dh, T=krg.CHUNK):
    """The reverse chained scan's arithmetic: chunks from the last; per chunk
    from x = 0 the steps g = x + dh_t, x = a_t g (the x that leaves it) and
    the product of its a's, each rounded apart; the carry into the chunk
    before, prod * x_in + x from zero; the chunk's db = g and da = g h_{t-1}
    from x_in."""
    B, S, C = a.shape
    da, db = torch.empty_like(a), torch.empty_like(a)
    x_in = torch.zeros(B, C)
    for k0 in reversed(range(0, S, T)):
        ac, dc = a[:, k0:k0 + T], dh[:, k0:k0 + T]
        prod, end = torch.ones(B, C), torch.zeros(B, C)
        x = x_in
        for t in reversed(range(ac.shape[1])):
            end = ac[:, t] * (end + dc[:, t])
            prod = prod * ac[:, t]
            g = x + dc[:, t]
            db[:, k0 + t] = g
            da[:, k0 + t] = g * (h[:, k0 + t - 1] if k0 + t else torch.zeros(B, C))
            x = ac[:, t] * g
        x_in = prod * x_in + end
    return da, db


@pytest.mark.parametrize("near_one", [False, True], ids=["sweep", "a_near_one"])
@pytest.mark.parametrize("S,C", [(1, 7), (63, 16), (64, 16), (65, 16), (130, 7),
                                 (2049, 16), (2048, 64)])
def test_emulated_kernel_matches_plain_backward(S, C, near_one):
    """One step; one short of a chunk and one chunk (no carry: bit-equal);
    one past it; two chunks and a step; one past 32 chunks; 32 chunks."""
    a, b, dh = _t(*_inputs(S, C, near_one))
    h = ref.rglru_scan_oracle(a, b)
    want = ref.rglru_scan_bwd_oracle(a, h, dh)
    got = _emulated_bwd(a, h, dh)
    for x, y in zip(got, want):
        if S <= krg.CHUNK:
            assert torch.equal(x, y)
        else:
            assert _rel(x, y) <= 1e-5


def test_emulated_carry_is_live_near_one():
    """With a in (0.99, 1) the carry moves g by far more than the bound, so a
    carry dropped at a chunk boundary fails the test above."""
    a, b, dh = _t(*_inputs(2048, 64, True))
    h = ref.rglru_scan_oracle(a, b)
    want = ref.rglru_scan_bwd_oracle(a, h, dh)[1]
    cut = torch.cat([ref.rglru_scan_bwd_oracle(a[:, k:k + krg.CHUNK], h[:, k:k + krg.CHUNK],
                                               dh[:, k:k + krg.CHUNK])[1]
                     for k in range(0, 2048, krg.CHUNK)], dim=1)
    assert _rel(cut, want) > 1e-2


# ---------------------------------------------------------------------------
# ops.rglru_scan under autograd
# ---------------------------------------------------------------------------

def test_ops_rglru_scan_runs_as_rglru_under_autograd():
    """On a CPU tensor the autograd Function runs both plain versions and
    launches nothing; its gradients are the plain backward's."""
    a, b, dh = _t(*_inputs(70, 9, True))
    a.requires_grad_()
    b.requires_grad_()
    before = (rglru_scan_fwd.launches, rglru_scan_bwd.launches)
    h = ops.rglru_scan(a, b)
    assert type(h.grad_fn).__name__ == "RGLRUBackward"
    got = torch.autograd.grad(h, (a, b), dh)
    assert (rglru_scan_fwd.launches, rglru_scan_bwd.launches) == before
    want = ref.rglru_scan_bwd_oracle(a.detach(), h.detach(), dh)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    with torch.no_grad():
        assert ops.rglru_scan(a, b).grad_fn is None


def test_rglru_function_passes_gradcheck():
    a, b, _ = _t(*_inputs(9, 3, False, np.float64))
    assert torch.autograd.gradcheck(ops.RGLRU.apply,
                                    (a.requires_grad_(), b.requires_grad_()))


def test_ops_rglru_scan_gradient_in_bf16_inputs():
    """bf16 inputs go to f32 first, as in the forward; the gradient comes
    back to the inputs in their dtype."""
    a, b, dh = _t(*_inputs(20, 8, False))
    a16, b16 = a.bfloat16().requires_grad_(), b.bfloat16().requires_grad_()
    h = ops.rglru_scan(a16, b16)
    assert h.dtype == torch.float32
    da, db = torch.autograd.grad(h, (a16, b16), dh)
    assert da.dtype == db.dtype == torch.bfloat16
    want = ref.rglru_scan_bwd_oracle(a16.detach().float(), h.detach(), dh)
    assert torch.equal(da, want[0].bfloat16()) and torch.equal(db, want[1].bfloat16())


# ---------------------------------------------------------------------------
# the kernel wrapper's refusals and scratch (no card here)
# ---------------------------------------------------------------------------

def test_backward_kernel_on_cpu_tensor_raises():
    a, b, dh = _t(*_inputs(8, 4, False))
    with pytest.raises(ValueError, match="CUDA"):
        rglru_scan_bwd(a, b, dh)


_M = dict(device="meta")


@pytest.mark.parametrize("a,h,dh,match", [
    (torch.zeros(1, 4, 8, **_M), torch.zeros(1, 4, 8, dtype=torch.bfloat16, **_M),
     torch.zeros(1, 4, 8, **_M), "float32"),
    (torch.zeros(1, 4, 8, **_M), torch.zeros(1, 4, 8, **_M), torch.zeros(1, 5, 8, **_M),
     "one shape"),
    (torch.zeros(4, 8, **_M), torch.zeros(4, 8, **_M), torch.zeros(4, 8, **_M), "one shape"),
    (torch.zeros(1, 8, 4, **_M).transpose(1, 2), torch.zeros(1, 4, 8, **_M),
     torch.zeros(1, 4, 8, **_M), "contiguous"),
])
def test_backward_kernel_refuses_what_it_does_not_take(monkeypatch, a, h, dh, match):
    """Past the device check (meta tensors posing as CUDA ones), the wrapper
    refuses other dtypes, shapes and layouts before it builds or launches
    anything."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(build, "load", lambda name: pytest.fail("built a library"))
    with pytest.raises(ValueError, match=match):
        rglru_scan_bwd(a, h, dh)


@pytest.mark.parametrize("B,S,C,words", [
    (2, 2048, 4096, 2 * 31 * 4096),     # the recurrentgemma-9b training shape
    (1, 16384, 4096, 255 * 4096),
    (2, 65, 130, 2 * 130),
    (2, 64, 130, 0), (1, 1, 7, 0),      # one chunk: the counter alone
])
def test_backward_scratch_holds_the_counter_and_a_word_per_handoff(B, S, C, words):
    """8 bytes of tile counter, then one 8-byte word per (b, chunk, channel)
    for every chunk but the first; 2.03 MB at the training shape."""
    assert krg.bwd_scratch_floats(B, S, C) == 2 * (1 + words)
    if (B, S, C) == (2, 2048, 4096):
        assert 4 * krg.bwd_scratch_floats(B, S, C) == 2_031_624


def test_library_path_of_rglru_bwd():
    p = build.library_path("rglru_bwd")
    assert p.parent == build.BUILD_DIR and p.name.startswith("rglru_bwd-")
    assert build.sources("rglru_bwd") == [build.CSRC / "rglru_bwd.cu"]
    assert p != build.library_path("rglru")
