"""The port's train step under a mesh against the JAX package's sharded
train step: the second half of tests/test_torch_mesh_train.py's archs,
qwen3-8b on (2, 4) and (4, 2) under the defaults and on (2, 4) under
``model_axis="zero3"`` and ``microbatches=2``, and gemma3-12b on (2, 4) and
(4, 2), held by that file's tests and rules (its docstring), their JAX and
port processes started together at the first test.
"""
import pytest

torch = pytest.importorskip("torch")

import test_torch_mesh_train as base  # noqa: E402

JOBS = [("qwen3-8b", base.RUNS["qwen3-8b"]), base.EXTRA, ("gemma3-12b", base.RUNS["gemma3-12b"])]
KEYS = base.keys_of(JOBS)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return base.run_results(tmp_path_factory, JOBS)


@pytest.mark.parametrize("case", KEYS, ids=base._ids)
def test_loss_and_gnorm_match_the_jax_sharded_train_step(results, case):
    base.test_loss_and_gnorm_match_the_jax_sharded_train_step(results, case)


@pytest.mark.parametrize("case", KEYS, ids=base._ids)
def test_every_gathered_gradient_leaf_matches_jax(results, case):
    base.test_every_gathered_gradient_leaf_matches_jax(results, case)


@pytest.mark.parametrize("case", KEYS, ids=base._ids)
def test_grads_and_moments_are_placed_as_their_params(results, case):
    base.test_grads_and_moments_are_placed_as_their_params(results, case)


@pytest.mark.parametrize("case", KEYS, ids=base._ids)
def test_adamw_over_dtensors_is_the_unsharded_update(results, case):
    base.test_adamw_over_dtensors_is_the_unsharded_update(results, case)
