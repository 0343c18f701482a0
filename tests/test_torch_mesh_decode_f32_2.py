"""The port's decode under a mesh against its own unsharded decode with the
cache in f32: the second half of tests/test_torch_mesh_decode_f32.py's
archs (``PARTS``), granite-3-8b and gemma3-12b on (2, 4) and (4, 2) under
both rules, held by that file's tests and rules (its docstring), their
processes started together at the first test.
"""
import pytest

torch = pytest.importorskip("torch")

import test_torch_mesh_decode_f32 as base  # noqa: E402

ARCHS = base.PARTS[1]
MESH_IDS = {"ids": lambda m: "x".join(map(str, m))}


@pytest.mark.parametrize("rule", base.RULES)
@pytest.mark.parametrize("mesh", base.MESHES, **MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_decode_matches_the_unsharded_decode_with_an_f32_cache(arch, mesh, rule):
    base.test_sharded_decode_matches_the_unsharded_decode_with_an_f32_cache(arch, mesh, rule)


@pytest.mark.parametrize("rule", base.RULES)
@pytest.mark.parametrize("mesh", base.MESHES, **MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_init_cache_is_placed_as_the_prefill_cache(arch, mesh, rule):
    base.test_sharded_init_cache_is_placed_as_the_prefill_cache(arch, mesh, rule)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_under_a_mesh_gives_the_unsharded_greedy_tokens(arch):
    base.test_generate_under_a_mesh_gives_the_unsharded_greedy_tokens(arch)
