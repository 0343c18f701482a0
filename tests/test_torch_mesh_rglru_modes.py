"""recurrentgemma-9b under a mesh in the other modes of the rules, against
the JAX package's sharded steps (smoke config, CPU, 8 ranks): zero3 on
(2, 4), where the activations' "inner" rule is empty, so each rank holds
whole channels of its batch rows and the params split over (data, model)
are gathered for the products, the conv and the gates; and
``seq_shard_cache`` at B 1 on (2, 4) (the long_500k setting), where the
one row does not split over the data axis and only the local layers' rings
take it: h and the conv history have no length dim.

The runs and the rules are tests/test_torch_mesh_rglru.py's (``PARITY``),
its two processes started together.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_mesh_rglru import (check_against_unsharded, check_decode,  # noqa: E402
                                   check_forward_and_loss, check_k3_calls,
                                   check_placements, check_prefill_and_cache, run_all)

MESH = (2, 4)
MODES = ("zero3", "seq")
# what a rank holds of u (rows, channels) and where u is placed: under zero3
# B 4 does not divide the 8 ranks of (data, model), so the rows split over
# data alone and the channels stay whole; at B 1 the row stays whole and the
# channels split over model
LOCAL_U = {"zero3": (2, 64), "seq": (1, 16)}
U_SPEC = {"zero3": ["data"], "seq": [None, None, "model"]}

_results = {}


def result(mode):
    if not _results:
        _results.update({m: r for (_, m), r in run_all([(MESH, m) for m in MODES]).items()})
    return _results[mode]


@pytest.mark.parametrize("mode", MODES)
def test_rglru_forward_and_loss_match_the_jax_sharded_steps(mode):
    check_forward_and_loss(result(mode))


@pytest.mark.parametrize("mode", MODES)
def test_rglru_prefill_and_its_cache_match_the_jax_sharded_prefill(mode):
    check_prefill_and_cache(result(mode))


@pytest.mark.parametrize("mode", MODES)
def test_rglru_decode_matches_the_jax_sharded_decode(mode):
    check_decode(result(mode))


@pytest.mark.parametrize("mode", MODES)
def test_rglru_steps_match_the_unsharded_steps(mode):
    check_against_unsharded(result(mode))


@pytest.mark.parametrize("mode", MODES)
def test_rglru_placements_are_the_jax_specs(mode):
    r = result(mode)
    check_placements(r, MESH)
    assert r["want_spec"]["u"] == U_SPEC[mode], r["want_spec"]


@pytest.mark.parametrize("mode", MODES)
def test_k3_runs_once_a_layer_on_each_ranks_local_channels(mode):
    check_k3_calls(result(mode), MESH, LOCAL_U[mode])
