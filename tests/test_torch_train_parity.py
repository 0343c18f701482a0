"""The port's training path against the JAX package (smoke configs, CPU).

Weights come from JAX ``Model.init`` through ``bridge.from_jax_params``, in
f32; batches are the reference's (``repro.train.make_batch``); the JAX side
runs ``Model.loss`` with ``attn_impl="xla"``, the JAX trainer's path.

Tolerances, with their reasons:
  * total, ce and zloss: 1e-6 relative (f32 summation order only);
  * every gradient leaf, relative to that leaf's max |grad| (the smoke
    weights are large, ROADMAP queue 3): gemma3-4b 2e-5 (4.2e-6 measured)
    and mamba2-780m 2e-4 (6.1e-5 measured; f32 summation order, through
    outputs of up to ~5e4); recurrentgemma-9b
    5e-3, because its smoke gradient is ill-conditioned in f32: the port's
    own f32 gradient is 1.7e-3 from its f64 gradient (measured), the
    largest part of the 1.2e-3 that separates the two packages;
  * adamw_update over 3 steps: 1e-6 relative to each leaf's max;
  * remat none, dots and full: 1e-6 relative (the same products, replayed).
mamba2-780m: the JAX f32 gradient through ``ssd_chunked`` is NaN at smoke
size (``jnp.where(causal, jnp.exp(seg), 0)`` selects, but above the diagonal
exp(seg) overflows to inf and its cotangent 0 * inf is NaN; ROADMAP queue
3). So its gradient leaves are held against ``jax.value_and_grad`` with the
SSD scan computed by the JAX package's sequential ``ref.ssd_oracle`` (the
function ``ssd_chunked`` computes, as tests/test_kernels.py holds them), and
against the chunked path element by element wherever that is finite.
A single whole train step is not compared: at step 1 AdamW moves each
element by about lr * sign(g), so a gradient element near 0 flips its
update by 2 lr, and such a test is ill-posed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ParallelConfig as JParallel  # noqa: E402
from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models import Ctx as JCtx, build_model as jax_build  # noqa: E402
from repro.train import DataConfig as JDataConfig, make_batch as jax_batch  # noqa: E402
from repro.train.optimizer import (OptConfig as JOptConfig,  # noqa: E402
                                   adamw_update as jax_adamw,
                                   init_opt_state as jax_init_opt)
from repro_torch.bridge import from_jax_opt_state, from_jax_params  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models import Ctx, Model  # noqa: E402
from repro_torch.train.optimizer import OptConfig, adamw_update, init_opt_state  # noqa: E402

ARCHS = ("gemma3-4b", "mamba2-780m", "recurrentgemma-9b")
GRAD_RTOL = {"gemma3-4b": 2e-5, "mamba2-780m": 2e-4, "recurrentgemma-9b": 5e-3}
SEQ, BATCH = 48, 2

_cache = {}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the suite runs in several worker processes
    at once, and torch's CPU thread pools in each would contend for the
    same cores (restored after, for the other files a worker runs)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_params(arch):
    jm = jax_build(jax_config(arch, smoke=True))
    params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32),
                                    jm.init(jax.random.PRNGKey(0)))
    return jm, params


def _port_model(arch, params):
    cfg = get_config(arch, smoke=True)
    m = Model(cfg, device="cpu", trainable=True)
    m.load_state_dict(from_jax_params(_np(params), cfg, device="cpu"), strict=True,
                      assign=True)
    assert all(p.requires_grad and p.dtype == torch.float32 for p in m.parameters())
    return m


def _both(arch, ssd="oracle"):
    """(JAX loss, metrics, grads as the port's flat dict; port model after
    backward, its loss and metrics), computed once per (arch, ssd). ``ssd``:
    the JAX SSD scan as ``ssd_chunked`` ("chunked") or as ``ref.ssd_oracle``
    ("oracle"); only mamba2-780m has SSD layers."""
    if (arch, ssd) not in _cache:
        jm, params = _jax_params(arch)
        batch = jax_batch(JDataConfig(vocab_size=jm.cfg.vocab_size, seq_len=SEQ,
                                      global_batch=BATCH), 0)
        chunked = jax_ssm.ssd_chunked
        if ssd == "oracle":
            jax_ssm.ssd_chunked = lambda x, dt, A, B, C, chunk: jax_ref.ssd_oracle(x, dt, A, B, C)
        try:
            (jl, jmet), jg = jax.value_and_grad(
                lambda p, b: jm.loss(p, b, JCtx(attn_impl="xla")), has_aux=True)(params, batch)
        finally:
            jax_ssm.ssd_chunked = chunked
        m = _port_model(arch, params)
        tb = {k: torch.from_numpy(np.array(v)).long() for k, v in batch.items()}
        tl, tmet = m.loss(tb)
        tl.backward()
        cfg = get_config(arch, smoke=True)
        _cache[arch, ssd] = (float(jl), {k: float(v) for k, v in jmet.items()},
                        from_jax_params(_np(jg), cfg, device="cpu"), m, tl.item(),
                        {k: v.item() for k, v in tmet.items()})
    return _cache[arch, ssd]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_parallel_config_matches_the_reference():
    assert [f.name for f in dataclasses.fields(ParallelConfig)] == \
        [f.name for f in dataclasses.fields(JParallel)]
    for f in dataclasses.fields(JParallel):
        assert getattr(ParallelConfig(), f.name) == f.default, f.name


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_jax(arch):
    jl, jmet, _, _, tl, tmet = _both(arch)
    assert abs(tl - jl) <= 1e-6 * abs(jl)
    for key in ("ce", "zloss", "ntok", "aux"):
        assert abs(tmet[key] - jmet[key]) <= 1e-6 * max(abs(jmet[key]), 1e-30), key


@pytest.mark.parametrize("arch", ARCHS)
def test_every_gradient_leaf_matches_jax(arch):
    _, _, jg, m, _, _ = _both(arch)
    names = dict(m.named_parameters())
    assert names.keys() == jg.keys()
    for k, p in names.items():
        assert p.grad is not None and p.grad.shape == jg[k].shape, k
        assert torch.isfinite(p.grad).all(), k
        err = _rel(p.grad.numpy(), jg[k].numpy())
        assert err <= GRAD_RTOL[arch], (k, err)


def test_mamba2_gradient_matches_the_chunked_path_where_finite():
    """The JAX trainer's own SSD path, ssd_chunked, element by element where
    its f32 gradient is finite (see the module docstring); its loss in full."""
    jl, _, jg, m, tl, _ = _both("mamba2-780m", ssd="chunked")
    assert abs(tl - jl) <= 1e-6 * abs(jl)
    n_finite = 0
    for k, p in m.named_parameters():
        want = jg[k].numpy()
        ok = np.isfinite(want)
        n_finite += int(ok.sum())
        if ok.any():
            err = np.abs(p.grad.numpy()[ok] - want[ok]).max() / np.abs(want[ok]).max()
            assert err <= GRAD_RTOL["mamba2-780m"], (k, err)
    assert n_finite > 0


def _leaves_of(jax_tree, cfg):
    return from_jax_params(_np(jax_tree), cfg, device="cpu")


def test_adamw_update_matches_jax_over_three_steps():
    """Step 1 from a fresh state; steps 2 and 3 from the JAX state bridged
    by from_jax_opt_state, with the JAX params of the step before."""
    arch = "gemma3-4b"
    cfg = get_config(arch, smoke=True)
    _, params = _jax_params(arch)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=0.5, weight_decay=0.1)
    jcfg, tcfg = JOptConfig(**kw), OptConfig(**kw)
    rng = np.random.RandomState(5)
    jstate = jax_init_opt(params)
    tparams, tstate = _leaves_of(params, cfg), None
    tstate = init_opt_state(tparams)
    ndims = Model(cfg, device="cpu").stacked_ndims()
    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.05), params)
        if step:
            tparams = _leaves_of(params, cfg)
            tstate = from_jax_opt_state(_np(jstate), cfg, device="cpu")
            assert tstate.step == step
        params, jstate, jmet = jax_adamw(jcfg, params, grads, jstate)
        tparams, tstate, tmet = adamw_update(tcfg, tparams, _leaves_of(grads, cfg), tstate,
                                             ndims)
        assert tstate.step == int(jstate.step) == step + 1
        assert abs(float(tmet["gnorm"]) - float(jmet["gnorm"])) <= 1e-6 * float(jmet["gnorm"])
        assert abs(tmet["lr"] - float(jmet["lr"])) <= 1e-6 * float(jmet["lr"])
        for got, want in ((tparams, params), (tstate.mu, jstate.mu), (tstate.nu, jstate.nu)):
            want = _leaves_of(want, cfg)
            assert got.keys() == want.keys()
            for k in want:
                assert _rel(got[k].numpy(), want[k].numpy()) <= 1e-6, (step, k)


def test_from_jax_opt_state_maps_every_leaf():
    arch = "recurrentgemma-9b"
    cfg = get_config(arch, smoke=True)
    _, params = _jax_params(arch)
    st = jax_init_opt(params)
    st = st._replace(step=jnp.asarray(4, jnp.int32),
                     mu=jax.tree_util.tree_map(lambda x: x + 1.0, st.mu))
    got = from_jax_opt_state(_np(st), cfg, device="cpu")
    names = {k for k, _ in Model(cfg, device="cpu").named_parameters()}
    assert got.step == 4 and got.mu.keys() == names == got.nu.keys()
    assert all(v.dtype == torch.float32 and torch.all(v == 1) for v in got.mu.values())


@pytest.mark.parametrize("arch", ARCHS + ("mixtral-8x7b", "dbrx-132b"))
def test_remat_policies_give_the_same_loss_and_grads(arch):
    _, params = _jax_params(arch)
    cfg = get_config(arch, smoke=True)
    batch = jax_batch(JDataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                  global_batch=BATCH), 1)
    tb = {k: torch.from_numpy(np.array(v)).long() for k, v in batch.items()}
    out = {}
    for remat in ("none", "dots", "full"):
        m = _port_model(arch, params)
        loss, _ = m.loss(tb, Ctx(remat=remat))
        loss.backward()
        out[remat] = (loss.item(), {k: p.grad for k, p in m.named_parameters()})
    for remat in ("dots", "full"):
        assert abs(out[remat][0] - out["none"][0]) <= 1e-6 * abs(out["none"][0])
        for k, g in out["none"][1].items():
            assert _rel(out[remat][1][k].numpy(), g.numpy()) <= 1e-6, (remat, k)
