"""The port's functional layers against the JAX package's, in f32.

Inputs come from a numpy seed and go to both frameworks unchanged. The
tolerance, 1e-5 absolute, allows for f32 rounding in another summation
order and in transcendental functions (rsqrt, cos/sin, tanh, pow).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro.models.model import Ctx as JCtx  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

ATOL = 1e-5


def _pair(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.array(a)) for a in arrays])


def test_rms_norm():
    rng = np.random.RandomState(0)
    (xj, sj), (xt, st) = _pair(rng.randn(2, 5, 64).astype(np.float32),
                               0.1 * rng.randn(64).astype(np.float32))
    np.testing.assert_allclose(tl.rms_norm(xt, st, 1e-6).numpy(),
                               np.asarray(jl.rms_norm(xj, sj, 1e-6)), atol=ATOL)


def test_rms_norm_bf16_rounds_like_jax():
    """bf16 input: the product stays in bf16 in both (at most one bf16 ulp apart)."""
    rng = np.random.RandomState(1)
    x = rng.randn(3, 64).astype(np.float32)
    s = 0.1 * rng.randn(64).astype(np.float32)
    oj = np.asarray(jl.rms_norm(jnp.asarray(x, jnp.bfloat16),
                                jnp.asarray(s, jnp.bfloat16)), np.float32)
    ot = tl.rms_norm(torch.from_numpy(x).bfloat16(),
                     torch.from_numpy(s).bfloat16())
    assert ot.dtype == torch.bfloat16
    np.testing.assert_allclose(ot.float().numpy(), oj, rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope(theta):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 24, 4, 16).astype(np.float32)
    pos = np.arange(24)[None, :] + 7
    out = tl.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jl.rope(jnp.asarray(x), jnp.asarray(pos), theta)),
        atol=ATOL)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_gated_mlp(act):
    rng = np.random.RandomState(3)
    p = {"wi": rng.randn(64, 128) / 8, "wg": rng.randn(64, 128) / 8,
         "wo": rng.randn(128, 64) / 11}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.randn(2, 6, 64).astype(np.float32)
    oj = jl.mlp_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                      act, JCtx())
    ot = tl.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                      torch.from_numpy(x), act)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=ATOL)


def test_embed_and_unembed():
    rng = np.random.RandomState(4)
    table = (rng.randn(512, 64) / 4).astype(np.float32)
    tokens = rng.randint(0, 512, (2, 9))
    hj = jl.embed_apply({"table": jnp.asarray(table)}, jnp.asarray(tokens), 64)
    ht = tl.embed_apply({"table": torch.from_numpy(table)},
                        torch.from_numpy(tokens), 64)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=ATOL)
    for cap in (0.0, 30.0):
        lj = jl.unembed_apply(jnp.asarray(table), hj, cap)
        lt = tl.unembed_apply(torch.from_numpy(table), ht, cap)
        assert lt.dtype == torch.float32
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)


def test_param_spec_inits_are_seeded():
    spec = tl.ParamSpec((64, 8), dtype=torch.float32)
    a = spec.materialize(torch.Generator().manual_seed(3), "cpu")
    b = spec.materialize(torch.Generator().manual_seed(3), "cpu")
    assert torch.equal(a, b)
    assert float(a.abs().max()) <= 2.0 / 8 + 1e-7     # truncated at 2 std, std 1/sqrt(64)
    assert torch.equal(tl.ParamSpec((3,), init="zeros").materialize(None, "cpu"),
                       torch.zeros(3, dtype=torch.bfloat16))
    assert torch.equal(tl.ParamSpec((3,), init="ones").materialize(None, "cpu"),
                       torch.ones(3, dtype=torch.bfloat16))
    # rglru_a: lambda = logit(u), u uniform on [0.9, 0.999), seeded, in f32
    lam = tl.ParamSpec((256,), init="rglru_a", dtype=torch.float32)
    la = lam.materialize(torch.Generator().manual_seed(3), "cpu")
    assert torch.equal(la, lam.materialize(torch.Generator().manual_seed(3), "cpu"))
    assert la.dtype == torch.float32
    assert np.log(0.9 / 0.1) - 1e-5 <= float(la.min())
    assert float(la.max()) <= np.log(0.999 / 0.001) + 1e-5
    with pytest.raises(ValueError):
        tl.ParamSpec((3,), init="bogus").materialize(None, "cpu")
