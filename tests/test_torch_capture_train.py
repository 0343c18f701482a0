"""Capture of the training step (``repro_torch.core.capture_step``).

At smoke size (B 2 x S 64) for each of the ten archs, on fake ``cpu``
tensors (a build of PyTorch without CUDA cannot record autograd on a fake
``cuda`` tensor; ``tests/test_torch_capture.py`` says why), at remat none:
``parsed_flops`` against the JAX ``capture_step`` of the JAX training step
on a one-device mesh, exactly, less the differences stated below with
their causes. ``tests/test_torch_capture.py`` holds the step's kernel
nodes at remat full.
"""
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ParallelConfig as JParallel  # noqa: E402
from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.core import capture_step as jax_capture_step  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.parallel.mesh import make_mesh  # noqa: E402
from repro.train.optimizer import OptConfig as JOptConfig  # noqa: E402
from repro.train.train_step import init_train_state as jax_init_train_state  # noqa: E402
from repro.train.train_step import make_train_step as jax_train_step  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.configs.registry import ARCH_NAMES, get_config  # noqa: E402
from repro_torch.core import capture_step, fake_mode  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.train.train_step import init_train_state, make_train_step  # noqa: E402

B, S = 2, 64


def _abstract_batch(model, cfg):
    toks = torch.empty(B, S, dtype=torch.long)
    batch = {"tokens": toks, "labels": toks}
    if model.memory_len():
        batch["memory"] = torch.empty(B, model.memory_len(), cfg.d_model, dtype=torch.bfloat16)
    return batch


def _port_train_capture(arch, remat):
    cfg = get_config(arch, smoke=True)
    with fake_mode():
        model = Model(cfg, device="cpu", trainable=True, abstract=True)
        step = make_train_step(model, OptConfig(), ParallelConfig(remat=remat))
        return cfg, capture_step(step, (init_train_state(model), _abstract_batch(model, cfg)))


def _jax_train_flops(arch):
    jcfg = jax_config(arch, smoke=True)
    jm = jax_build(jcfg)
    par = JParallel(remat="none")
    state = jax.eval_shape(lambda: jax_init_train_state(jm, jax.random.PRNGKey(0), par))
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    batch = {"tokens": tok, "labels": tok}
    if jm.memory_len():
        batch["memory"] = jax.ShapeDtypeStruct((B, jm.memory_len(), jcfg.d_model),
                                               jnp.dtype(jcfg.dtype))
    mesh = make_mesh((1,), ("data",))
    cap = jax_capture_step(jax_train_step(jm, JOptConfig(), par, mesh), (state, batch), None,
                           mesh, build_graph=False)
    return cap.summary["parsed_flops"]


# The training step at remat none. K1's backward computes the scores again
# (csrc/flash_attention_bwd.cu: S = Q K^T, then dV, dP, dQ, dK), where XLA
# differentiates the forward's two products into four: the port counts half
# of K1's forward FLOPs more, exactly. mamba2-780m, measured: the port counts
# 3,145,728 fewer; K2's formulas count the plain versions (the sequential
# forward's readout, the chunked backward's products), where XLA
# differentiates its chunked forward.
TRAIN_GAPS = {"mamba2-780m": -3_145_728}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_train_step_flops_match_the_jax_capture(arch):
    cfg, cap = _port_train_capture(arch, "none")
    k1_fwd = sum(n.attrs["flops"] for n in cap.graph.nodes
                 if n.attrs["op"].startswith("repro_torch.flash_attention_fwd"))
    want = _jax_train_flops(arch) + k1_fwd // 2 + TRAIN_GAPS.get(arch, 0)
    assert cap.summary["parsed_flops"] == want, (arch, cap.summary["parsed_flops"], want)
