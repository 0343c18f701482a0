"""Decode under a mesh with ``seq_shard_cache`` against the JAX package's
decode: the second half of tests/test_torch_mesh_decode.py's archs
(``PARTS``), granite-3-8b and gemma3-12b on (2, 4) and (4, 2), held by
tests/test_torch_mesh_decode_seq.py's tests and rules (its docstring),
their processes started together at the first test.
"""
import pytest

torch = pytest.importorskip("torch")

import test_torch_mesh_decode_seq as base  # noqa: E402
from test_torch_mesh_decode import IDS, MESHES, PARTS  # noqa: E402

ARCHS = PARTS[1]


@pytest.mark.parametrize("mesh", MESHES, **IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_length_sharded_decode_matches_the_jax_unsharded_decode(arch, mesh):
    base.test_length_sharded_decode_matches_the_jax_unsharded_decode(arch, mesh)


@pytest.mark.parametrize("mesh", MESHES, **IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_length_sharded_decode_is_within_the_jax_sharded_spread(arch, mesh):
    base.test_length_sharded_decode_is_within_the_jax_sharded_spread(arch, mesh)


@pytest.mark.parametrize("mesh", MESHES, **IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_each_layer_cache_matches_the_jax_unsharded_cache_within_one_bf16_ulp(arch, mesh):
    base.test_each_layer_cache_matches_the_jax_unsharded_cache_within_one_bf16_ulp(arch, mesh)


@pytest.mark.parametrize("mesh", MESHES, **IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_length_is_placed_over_data_as_the_jax_spec(arch, mesh):
    base.test_cache_length_is_placed_over_data_as_the_jax_spec(arch, mesh)
