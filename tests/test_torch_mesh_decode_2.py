"""Decode under a mesh against the JAX package's sharded decode step: the
second half of tests/test_torch_mesh_decode.py's archs (``PARTS``),
granite-3-8b and gemma3-12b on (2, 4) and (4, 2) under the default rules,
held by that file's tests and rules (its docstring), their processes
started together at the first test.
"""
import pytest

torch = pytest.importorskip("torch")

import test_torch_mesh_decode as base  # noqa: E402

ARCHS = base.PARTS[1]


@pytest.mark.parametrize("mesh", base.MESHES, **base.IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_decode_logits_match_the_jax_sharded_decode(arch, mesh):
    base.test_sharded_decode_logits_match_the_jax_sharded_decode(arch, mesh)


@pytest.mark.parametrize("mesh", base.MESHES, **base.IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_each_layer_cache_matches_the_jax_sharded_cache_within_one_bf16_ulp(arch, mesh):
    base.test_each_layer_cache_matches_the_jax_sharded_cache_within_one_bf16_ulp(arch, mesh)


@pytest.mark.parametrize("mesh", base.MESHES, **base.IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_is_placed_by_batch_and_kv_heads_as_the_jax_spec(arch, mesh):
    base.test_cache_is_placed_by_batch_and_kv_heads_as_the_jax_spec(arch, mesh)
