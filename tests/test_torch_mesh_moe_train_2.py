"""The MoE archs' train step under a mesh against the JAX package's sharded
train step: the second half of tests/test_torch_mesh_moe_train.py's runs,
dbrx-132b on (2, 4), (4, 2) and (1, 8) under the defaults and on (2, 4)
under ``model_axis="zero3"``, held by that file's tests and rules (its
docstring), their JAX and port processes started together at the first
test.
"""
import pytest

torch = pytest.importorskip("torch")

import test_torch_mesh_moe_train as base  # noqa: E402

JOBS = [p for p in base.PROCS if p[0] == "dbrx-132b"]
KEYS = base.keys_of(JOBS)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return base.run_results(tmp_path_factory, JOBS)


@pytest.mark.parametrize("case", KEYS, ids=base._ids)
def test_loss_and_gnorm_match_the_jax_sharded_train_step(results, case):
    base.test_loss_and_gnorm_match_the_jax_sharded_train_step(results, case)


@pytest.mark.parametrize("case", KEYS, ids=base._ids)
def test_loss_and_gnorm_match_the_ports_unsharded_step(results, case):
    base.test_loss_and_gnorm_match_the_ports_unsharded_step(results, case)


@pytest.mark.parametrize("case", KEYS, ids=base._ids)
def test_every_gathered_gradient_leaf_matches_jax(results, case):
    base.test_every_gathered_gradient_leaf_matches_jax(results, case)


@pytest.mark.parametrize("case", KEYS, ids=base._ids)
def test_every_moe_call_routes_as_jax(results, case):
    base.test_every_moe_call_routes_as_jax(results, case)


@pytest.mark.parametrize("case", KEYS, ids=base._ids)
def test_grads_and_moments_are_placed_as_their_params(results, case):
    base.test_grads_and_moments_are_placed_as_their_params(results, case)


@pytest.mark.parametrize("case", KEYS, ids=base._ids)
def test_adamw_over_dtensors_is_the_unsharded_update(results, case):
    base.test_adamw_over_dtensors_is_the_unsharded_update(results, case)
