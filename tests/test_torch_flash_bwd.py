"""K1's backward on the CPU: the plain backward (``ref.flash_attention_bwd_oracle``)
against autograd of the plain forward and against ``jax.grad`` of the JAX
package's oracle; the ``ops.flash_attention`` autograd Function against
finite differences; the plain forward's lse against torch.logsumexp.

Tolerances, with their reasons:
  * plain backward vs autograd of the oracle, f32: 1e-5 x max(1, max |ref|)
    per tensor (summation order only);
  * vs jax.grad of the JAX oracle, f32: 2e-5 x max(1, max |ref|), the
    forward's f32 tolerance (tests/test_kernels.py);
  * gradcheck in float64 at its default tolerances;
  * lse, f32: 1e-5 absolute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd, flash_attention_fwd)

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the suite runs in several worker processes
    at once, and torch's CPU thread pools in each would contend for the
    same cores (restored after, for the other files a worker runs)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (hd, BKV, G, Sq, Sk, causal, window)
CASES = [
    (16, 2, 1, 24, 24, True, 0), (32, 1, 2, 40, 40, True, 8),
    (16, 2, 4, 33, 33, True, 0), (64, 1, 2, 17, 17, False, 0),
    (32, 2, 2, 20, 36, False, 0), (16, 1, 4, 36, 20, True, 0),
    (16, 1, 2, 30, 30, False, 6), (128, 1, 1, 9, 9, True, 4),
    (256, 1, 2, 5, 5, True, 0),
]


def _ids(case):
    hd, kv, g, sq, sk, c, w = case
    return f"hd{hd}-kv{kv}-G{g}-Sq{sq}-Sk{sk}-{'causal' if c else 'full'}-w{w}"


def _inputs(seed, hd, BKV, G, Sq, Sk, dtype=np.float32):
    rng = np.random.RandomState(seed)
    q = rng.randn(BKV * G, Sq, hd).astype(dtype)
    k = rng.randn(BKV, Sk, hd).astype(dtype)
    v = rng.randn(BKV, Sk, hd).astype(dtype)
    do = rng.randn(BKV * G, Sq, hd).astype(dtype)
    return q, k, v, do


def _close(got, want, rtol):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())
    assert err <= rtol * scale, (err, rtol * scale)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_backward_matches_autograd_of_oracle(case):
    hd, BKV, G, Sq, Sk, causal, window = case
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(0, hd, BKV, G, Sq, Sk))
    scale = 0.7 / hd ** 0.5
    qa, ka, va = (x.clone().requires_grad_() for x in (q, k, v))
    o = ref.flash_attention_oracle(qa, ka, va, scale=scale, causal=causal, window=window)
    o.backward(do)
    o2, lse = ref.flash_attention_oracle(q, k, v, scale=scale, causal=causal,
                                         window=window, return_lse=True)
    assert torch.equal(o2, o.detach())
    dq, dk, dv = ref.flash_attention_bwd_oracle(q, k, v, o2, lse, do, scale=scale,
                                                causal=causal, window=window)
    for got, want in ((dq, qa.grad), (dk, ka.grad), (dv, va.grad)):
        assert got.shape == want.shape and got.dtype == want.dtype
        _close(got.numpy(), want.numpy(), 1e-5)


@pytest.mark.parametrize("case", CASES[:6], ids=_ids)
def test_plain_backward_matches_jax_grad_of_jax_oracle(case):
    hd, BKV, G, Sq, Sk, causal, window = case
    q, k, v, do = _inputs(1, hd, BKV, G, Sq, Sk)

    def f(q, k, v):
        return jref.flash_attention_oracle(q, k, v, causal=causal, window=window)

    oj, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = ref.flash_attention_oracle(qt, kt, vt, causal=causal, window=window,
                                        return_lse=True)
    _close(o.numpy(), np.asarray(oj), 2e-5)
    got = ref.flash_attention_bwd_oracle(qt, kt, vt, o, lse, dot, causal=causal,
                                         window=window)
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w), 2e-5)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 3), (False, 0)])
def test_ops_function_gradcheck_float64(causal, window):
    """The autograd Function's CPU path (model layout in, model layout out)
    against finite differences of its own forward."""
    rng = np.random.RandomState(2)
    B, S, KV, G, hd = 1, 6, 2, 2, 16
    q = torch.from_numpy(rng.randn(B, S, KV, G, hd)).requires_grad_()
    k = torch.from_numpy(rng.randn(B, S, KV, hd)).requires_grad_()
    v = torch.from_numpy(rng.randn(B, S, KV, hd)).requires_grad_()
    fn = lambda q, k, v: ops.flash_attention(q, k, v, causal=causal,  # noqa: E731
                                             window=window, scale=0.3)
    assert torch.autograd.gradcheck(fn, (q, k, v))


def test_ops_function_saves_lse_and_counts_no_launch():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(3, 16, 1, 2, 12, 12))
    before = (flash_attention_fwd.launches, flash_attention_bwd.launches)
    qa = q.reshape(1, 2, 12, 16).movedim(2, 1)[:, :, None].clone().requires_grad_()
    ka = k.movedim(0, 1)[None].clone().requires_grad_()
    va = v.movedim(0, 1)[None].clone().requires_grad_()
    o = ops.flash_attention(qa, ka, va, causal=True, window=5)
    assert o.grad_fn is not None
    o.sum().backward()
    assert qa.grad.shape == qa.shape and ka.grad.shape == ka.shape
    assert (flash_attention_fwd.launches, flash_attention_bwd.launches) == before
    with torch.no_grad():
        o2 = ops.flash_attention(qa, ka, va, causal=True, window=5)
    assert o2.grad_fn is None and torch.equal(o2, o.detach())


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_lse_matches_logsumexp_of_masked_scores(case):
    hd, BKV, G, Sq, Sk, causal, window = case
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(4, hd, BKV, G, Sq, Sk))
    _, lse = ref.flash_attention_oracle(q, k, v, causal=causal, window=window,
                                        return_lse=True)
    s = torch.einsum("bqh,bsh->bqs", q, k.repeat_interleave(G, 0)) / hd ** 0.5
    qpos, kpos = torch.arange(Sq)[:, None], torch.arange(Sk)[None]
    keep = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        keep &= kpos <= qpos
    if window:
        keep &= qpos - kpos < window
    want = torch.logsumexp(s.masked_fill(~keep, float("-inf")), dim=-1)
    assert lse.dtype == torch.float32 and lse.shape == (BKV * G, Sq)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), atol=1e-5)


def test_backward_kernel_on_cpu_tensor_raises():
    x = torch.zeros(2, 16, 16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd(x, x, x, x, torch.zeros(2, 16), x)


@pytest.mark.parametrize("fn,args", [
    ("ssd", lambda t: (t(1, 4, 2, 16), t(1, 4, 2), t(2), t(1, 4, 8), t(1, 4, 8))),
    ("rglru_scan", lambda t: (t(1, 4, 8), t(1, 4, 8))),
])
def test_ssd_and_rglru_stay_differentiable_on_cpu(fn, args):
    """On the CPU the plain versions run under autograd (ssd as ops.SSD with
    its plain backward; on the card rglru_scan refuses it and ssd runs K2's
    backward kernel, which chip_smoke.py checks)."""
    inputs = args(lambda *s: torch.rand(*s, dtype=torch.float32).requires_grad_())
    out = getattr(ops, fn)(*inputs)
    out = out[0] if isinstance(out, tuple) else out
    out.sum().backward()
    assert all(x.grad is not None for x in inputs)


def test_backward_tiles_match_the_kernels():
    """The wrapper's grid and scratch rules use the tiles and the G-split rule
    of the CUDA source: bf16 dK/dV blocks of 64 keys over 64-row q tiles,
    dQ blocks of 128 rows (two 64-row warpgroups) over 64-key tiles (V in
    one stage at hd 256), at least 256 dK/dV blocks
    where a divisor of G gives them; f32 tiles of 64 q rows and 64 keys (32
    at hd 256); D rows in blocks of 8 warps."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    src = (build.CSRC / "flash_attention_bwd.cu").read_text()
    for line in ("constexpr int BWD_BN = 64;", "constexpr int BWD_BM = 64;",
                 "constexpr int MIN_BLOCKS = 256;", "constexpr int D_WARPS = 8;",
                 "constexpr int F32_BM = 64;",
                 "constexpr int BN = BWD_BN;",
                 "static constexpr int VSTAGES = HD >= 256 ? 1 : 2;",
                 "static constexpr int BN = HD >= 256 ? 32 : 64;   // keys per kv tile",
                 "if (G % s == 0 && tiles * s >= MIN_BLOCKS) return s;",
                 "((long long)BH * Sq + 63) / 64 * 64",
                 "(Sq + 2 * BWD_BM - 1) / (2 * BWD_BM)"):
        assert line in src, line
    assert (fa.BWD_BN, fa.BWD_DQ_ROWS, fa.BWD_F32_Q_ROWS, fa.BWD_ROWS_PER_BLOCK) == (64, 128, 64, 8)
    assert fa.BWD_MIN_BLOCKS == 256
    assert [fa.bwd_f32_keys_per_tile(hd) for hd in fa.HEAD_DIMS] == [64, 64, 64, 64, 32]
    bf16, f32 = torch.bfloat16, torch.float32
    # the D kernel's grid is the largest here: a block per 8 rows
    assert fa.bwd_blocks(16, 8, 2048, 2048, 256, bf16) == 16 * 2048 // 8
    assert fa.bwd_blocks(16, 8, 2048, 2048, 256, f32) == 16 * 2048 // 8
    # one kv head: the split multiplies the bf16 dK/dV grid (32 tiles x 8
    # splits of its 8 heads); the f32 kernel's tiles are 32 keys at hd 256
    assert fa.bwd_blocks(8, 1, 8, 2048, 64, bf16) == 32 * 8
    assert fa.bwd_blocks(8, 1, 8, 2048, 256, f32) == 2048 // 32
    assert fa.bwd_blocks(2**20, 1, 2**16, 1, 64, bf16) > fa.INT32_MAX


# (label, B, heads, kv heads, hd, S, splits, scratch floats)
SPLIT_CASES = [
    # gemma3-4b at B 2: 8 kv heads x 32 kv tiles = 256 blocks, no split
    ("gemma3-4b", 2, 8, 4, 256, 2048, 1, 2 * 8 * 2048),
    # recurrentgemma-9b: 16 heads over one kv head, 64 tiles -> 4 splits, 256 blocks
    ("recurrentgemma-9b", 2, 16, 1, 256, 2048, 4, 2 * 16 * 2048 + 2 * 4 * 2 * 2048 * 256),
    # qwen3-8b (hd 128, GQA 4): 16 kv heads x 32 tiles = 512 blocks, no split
    ("qwen3-8b", 2, 32, 8, 128, 2048, 1, 2 * 32 * 2048),
    # recurrentgemma-9b at B 1 and S 1000: 16 tiles -> 16 splits (all G)
    ("recurrentgemma-9b B1 S1000", 1, 16, 1, 256, 1000, 16,
     16 * 1000 + 2 * 16 * 1 * 1000 * 256),
]


@pytest.mark.parametrize("case", SPLIT_CASES, ids=[c[0] for c in SPLIT_CASES])
def test_head_split_rule_and_scratch(case):
    """The G-split rule at the trained and planned shapes: the fewest splits,
    a divisor of G, that give the bf16 dK/dV grid 256 blocks; the scratch
    holds D (rounded to 64 floats) and, when split, f32 partial dK and dV.
    The f32 path never splits."""
    from repro_torch.kernels import flash_attention as fa
    _, B, H, KV, hd, S, splits, floats = case
    BKV, G = B * KV, H // KV
    assert fa.bwd_head_splits(BKV, G, S) == splits
    assert G % splits == 0
    blocks = BKV * -(-S // fa.BWD_BN) * splits
    assert blocks >= fa.BWD_MIN_BLOCKS or splits == G
    if splits > 1:                      # no smaller divisor of G would do
        assert all(G % s or BKV * -(-S // fa.BWD_BN) * s < fa.BWD_MIN_BLOCKS
                   for s in range(1, splits))
    assert fa.bwd_scratch_floats(B * H, BKV, S, S, hd, torch.bfloat16) == floats
    assert fa.bwd_scratch_floats(B * H, BKV, S, S, hd, torch.float32) == -(-(B * H * S) // 64) * 64
