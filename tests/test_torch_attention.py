"""The port's attention against the JAX package's, on gemma3-4b smoke layers
in f32 (weights from JAX ``Model.init``, bridged and cast to f32).

Tolerances: 2e-5 absolute plus 1e-5 relative where both sides compute in
f32 (summation order only; outputs reach ~50 through the JAX init's wo);
caches are bf16 in both packages, so cached keys/values may sit one bf16
ulp apart (rtol 2^-7) when an f32 value lies on a rounding boundary, and
decode rounds its softmax weights to bf16 before P.V, which moves an output
by at most ~1e-3 for such a flip.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.models import attention as ja, build_model as jax_build  # noqa: E402
from repro.models.model import Ctx as JCtx  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models import Ctx, Model, attention as ta  # noqa: E402

F32 = 2e-5
BF16_ULP = 2.0 ** -7                 # one bf16 ulp, relative, at worst
KINDS = {"local": 0, "global": 2}          # smoke pattern: local, local, global, local


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("gemma3-4b", smoke=True)
    jcfg = jax_config("gemma3-4b", smoke=True)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32),
        jax_build(jcfg).init(jax.random.PRNGKey(0)))
    model = Model(cfg, device="cpu")
    model.load_state_dict(from_jax_params(params, cfg, device="cpu"),
                          strict=True, assign=True)
    jp = {kind: jax.tree_util.tree_map(
        lambda a: jnp.asarray(a[0]), params["blocks"]["sb"][f"slot{i}"]["attn"])
        for kind, i in KINDS.items()}
    tp = {kind: model.layers[i]["attn"] for kind, i in KINDS.items()}
    return cfg, jcfg, jp, tp


def _x(seed, S, d=64):
    return np.random.RandomState(seed).randn(2, S, d).astype(np.float32)


@pytest.mark.parametrize("kind", ["local", "global"])
def test_attention_apply_matches_jax_kernel(setup, kind):
    cfg, jcfg, jp, tp = setup
    x = _x(0, 48)                         # 48 > local window 32
    oj, (kj, vj) = ja.attention_apply(jp[kind], jnp.asarray(x), jcfg,
                                      JCtx(attn_impl="interpret"), kind)
    ot, (kt, vt) = ta.attention_apply(tp[kind], torch.from_numpy(x), cfg, Ctx(),
                                      kind)
    for a, b in ((ot, oj), (kt, kj), (vt, vj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=F32, rtol=1e-5)


@pytest.mark.parametrize("kind", ["local", "global"])
@pytest.mark.parametrize("S", [48, 20, 32])
def test_pack_prefill_cache(setup, kind, S):
    cfg, jcfg, _, _ = setup
    rng = np.random.RandomState(S)
    k = rng.randn(2, S, 2, 16).astype(np.float32)
    v = rng.randn(2, S, 2, 16).astype(np.float32)
    cj = ja.pack_prefill_cache(jnp.asarray(k), jnp.asarray(v), kind, jcfg, 64)
    ct = ta.pack_prefill_cache(torch.from_numpy(k), torch.from_numpy(v), kind,
                               cfg, 64)
    for name in ("k", "v"):
        assert ct[name].dtype == torch.bfloat16
        # the same f32 values cast once to bf16: bit-identical
        np.testing.assert_array_equal(ct[name].float().numpy(),
                                      np.asarray(cj[name], np.float32))


@pytest.mark.parametrize("kind", ["local", "global"])
def test_attention_decode_wraps_local_ring(setup, kind):
    """Prefill 60 tokens (ring of 32 slots), then decode positions 60..67:
    slots 28..31 then 0..3 of the local ring."""
    cfg, jcfg, jp, tp = setup
    S, cache_len = 60, 72
    x = _x(1, S + 8)
    _, (kj, vj) = ja.attention_apply(jp[kind], jnp.asarray(x[:, :S]), jcfg,
                                     JCtx(attn_impl="interpret"), kind)
    cj = ja.pack_prefill_cache(kj, vj, kind, jcfg, cache_len)
    ct = {n: torch.from_numpy(np.array(cj[n].astype(jnp.float32))).bfloat16()
          for n in ("k", "v")}
    for pos in range(S, S + 8):
        xi = x[:, pos:pos + 1]
        oj, cj = ja.attention_decode(jp[kind], jnp.asarray(xi), cj,
                                     jnp.int32(pos), jcfg, JCtx(), kind)
        ot, ct = ta.attention_decode(tp[kind], torch.from_numpy(xi), ct, pos,
                                     cfg, Ctx(), kind)
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=2e-3,
                                   rtol=1e-5, err_msg=f"pos {pos}")
        for n in ("k", "v"):
            np.testing.assert_allclose(ct[n].float().numpy(),
                                       np.asarray(cj[n], np.float32),
                                       rtol=BF16_ULP, atol=1e-6)
    if kind == "local":
        assert ct["k"].shape[1] == cfg.local_window


def test_cross_attention_not_ported(setup):
    """The name is from before cross-attention was ported; the test now holds
    the cross and enc kinds, which gemma3-4b's layer params run as well as
    their own archs' (tests/test_torch_cross.py), against the JAX package:
    the cross specs add an f32 scalar gate initialised to zero; an enc layer
    (roped, unmasked) and a cross layer (k/v from the memory, no rope, its
    output times tanh(gate), here 0.5) match the JAX layers in interpret
    mode."""
    cfg, jcfg, jp, tp = setup
    got, want = ta.attention_specs(cfg, cross=True), ja.attention_specs(jcfg, cross=True)
    assert set(got) == set(want) == set(ta.attention_specs(cfg)) | {"gate"}
    assert got["gate"].shape == () and got["gate"].dtype == torch.float32
    assert got["gate"].init == "zeros" and want["gate"].dtype == jnp.float32
    x, mem = _x(1, 40), _x(2, 24)
    gj = dict(jp["global"], gate=jnp.float32(0.5))
    gt = {k: tp["global"][k] for k in ("wq", "wk", "wv", "wo", "qnorm", "knorm")}
    gt["gate"] = torch.tensor(0.5)
    for kind, memory in (("enc", None), ("cross", mem)):
        oj, (kj, vj) = ja.attention_apply(
            gj, jnp.asarray(x), jcfg, JCtx(attn_impl="interpret"), kind,
            memory=None if memory is None else jnp.asarray(memory))
        with torch.inference_mode():
            ot, (kt, vt) = ta.attention_apply(
                gt, torch.from_numpy(x), cfg, Ctx(), kind,
                memory=None if memory is None else torch.from_numpy(memory))
        for a, b in ((ot, oj), (kt, kj), (vt, vj)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=F32, rtol=1e-5,
                                       err_msg=kind)
