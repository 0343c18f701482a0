"""The port's flash attention (plain version on CPU tensors) against the JAX
package's Pallas kernel in interpret mode and its oracle.

Tolerances are those of tests/test_kernels.py: f32 2e-5 (summation order
only), bf16 3e-2 (bf16 rounding of scores, probabilities and output).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    INT32_MAX, MAX_GRID_Y, Q_ROWS_PER_TILE, flash_attention_fwd, grid_fits,
    rows_without_keys)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _inputs(seed, B, S, KV, G, hd):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, KV, G, hd).astype(np.float32),
            rng.randn(B, S, KV, hd).astype(np.float32),
            rng.randn(B, S, KV, hd).astype(np.float32))


def _jax_oracle(q, k, v, causal, window):
    """JAX ref.flash_attention_oracle in the kernel layout, back to model layout."""
    B, S, KV, G, hd = q.shape
    qf = np.moveaxis(q, 1, 3).reshape(B * KV * G, S, hd)
    kf = np.moveaxis(k, 1, 2).reshape(B * KV, S, hd)
    vf = np.moveaxis(v, 1, 2).reshape(B * KV, S, hd)
    o = jref.flash_attention_oracle(jnp.asarray(qf), jnp.asarray(kf),
                                    jnp.asarray(vf), causal=causal, window=window)
    return np.moveaxis(np.asarray(o, np.float32).reshape(B, KV, G, S, hd), 3, 1)


@pytest.mark.parametrize("S,causal,window", [
    (64, True, 0), (96, True, 0), (64, True, 16), (128, False, 0),
    (80, True, 24),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_sweep(S, causal, window, dtype):
    q, k, v = _inputs(0, 2, S, 2, 2, 32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    # same values in both frameworks: round through the working dtype once
    qj, kj, vj = (jnp.asarray(x, jdt) for x in (q, k, v))
    qt, kt, vt = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)
                  for x in (qj, kj, vj))
    o = ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert o.dtype == tdt and o.shape == qt.shape
    o = o.float().numpy()
    oj = jops.flash_attention(qj, kj, vj, causal=causal, window=window,
                              interpret=True, block_q=32, block_k=32)
    atol = 2e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(o, np.asarray(oj, np.float32), atol=atol)
    oref = _jax_oracle(*(np.asarray(x, np.float32) for x in (qj, kj, vj)),
                       causal, window)
    np.testing.assert_allclose(o, oref, atol=atol)


@pytest.mark.parametrize("mqa_kv", [1, 2, 4])
def test_flash_attention_gqa_ratios(mqa_kv):
    q, k, v = _inputs(1, 2, 64, mqa_kv, 4 // mqa_kv, 16)
    o = ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                            causal=True).numpy()
    oj = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True, interpret=True, block_q=32,
                              block_k=32)
    np.testing.assert_allclose(o, np.asarray(oj), atol=2e-5)
    np.testing.assert_allclose(o, _jax_oracle(q, k, v, True, 0), atol=2e-5)


def test_oracle_matches_jax_oracle_kernel_layout():
    rng = np.random.RandomState(2)
    q = rng.randn(8, 40, 16).astype(np.float32)
    k = rng.randn(4, 40, 16).astype(np.float32)
    v = rng.randn(4, 40, 16).astype(np.float32)
    o = ref.flash_attention_oracle(*(torch.from_numpy(x) for x in (q, k, v)),
                                   causal=True, window=8, scale=0.3)
    oj = jref.flash_attention_oracle(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=True, window=8,
                                     scale=0.3)
    np.testing.assert_allclose(o.numpy(), np.asarray(oj), atol=2e-5)


def test_cpu_path_counts_no_launch():
    before = flash_attention_fwd.launches
    q, k, v = _inputs(3, 1, 16, 1, 2, 16)
    ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    assert flash_attention_fwd.launches == before


def test_kernel_on_cpu_tensor_raises():
    x = torch.zeros(2, 16, 16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(x, x, x)


def test_ops_rejects_other_devices():
    x = torch.zeros(1, 4, 1, 1, 16, device="meta")
    kv = torch.zeros(1, 4, 1, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_attention(x, kv, kv)


def test_kernel_modules_import_without_nvcc(tmp_path):
    env = dict(os.environ, PATH=str(tmp_path), PYTHONPATH=SRC)
    code = ("import repro_torch.kernels.ops, repro_torch.kernels.flash_attention\n"
            "import repro_torch.kernels.ssd, repro_torch.models.ssm\n"
            "import repro_torch.kernels.rglru, repro_torch.models.rglru\n"
            "from repro_torch.kernels import build\n"
            "try:\n    build.nvcc()\nexcept RuntimeError as e:\n    print('no nvcc:', e)\n")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    if not os.path.exists("/usr/local/cuda/bin/nvcc"):
        assert "no nvcc:" in r.stdout


def test_library_path_tracks_source_and_flags():
    p = build.library_path("flash_attention")
    assert p.parent == build.BUILD_DIR and p.name.startswith("flash_attention-")
    assert p == build.library_path("flash_attention")


def test_library_path_tracks_included_headers(tmp_path, monkeypatch):
    """An edit of a header a source includes, directly or through another
    header, gives the source a new library, so no stale one is loaded; an
    edit of a header it does not include leaves the path as it was."""
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda_runtime.h>\nint x;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "other.cuh").write_text("// other\n")
    assert [p.name for p in build.sources("k")] == ["k.cu", "a.cuh", "b.cuh"]
    first = build.library_path("k")
    (tmp_path / "other.cuh").write_text("// other, edited\n")
    assert build.library_path("k") == first
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    second = build.library_path("k")
    assert second != first
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    assert build.library_path("k") not in (first, second)


def test_backward_and_forward_share_the_hopper_header():
    """K1's forward and backward take their PTX helpers from csrc/hopper.cuh
    and both libraries' names cover it; build_all still builds .cu files only."""
    for name in ("flash_attention", "flash_attention_bwd"):
        assert [p.name for p in build.sources(name)] == [f"{name}.cu", "hopper.cuh"]
    assert "hopper" not in {p.stem for p in build.CSRC.glob("*.cu")}


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (64, 64, True, 16), (96, 64, True, 0), (96, 64, False, 0),
    (40, 16, True, 24), (39, 16, True, 24), (48, 16, False, 32),
    (47, 16, False, 32), (8, 0, True, 0), (0, 8, True, 4), (1, 1, True, 1),
])
def test_rows_without_keys_matches_the_mask(Sq, Sk, causal, window):
    """The rule by which flash_attention_fwd refuses a call agrees with the
    oracle's mask: some query row keeps no key. The CUDA kernel writes 0 for
    such a row where the oracle returns the mean of v."""
    qpos = torch.arange(Sq)[:, None]
    kpos = torch.arange(Sk)[None, :]
    mask = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= (qpos - kpos) < window
    assert rows_without_keys(Sq, Sk, causal, window) == bool((~mask.any(1)).any())


@pytest.mark.parametrize("dtype,BH,Sq,Sk,fits", [
    (torch.bfloat16, 1, 1, 1, True), (torch.float32, 1, 1, 1, True),
    (torch.bfloat16, 64, 2048, 2048, True), (torch.float32, 64, 2048, 2049, True),
    # f32: grid (BH, ceil(Sq / 64)), at most 65535 q tiles on y
    (torch.float32, 1, MAX_GRID_Y * 64, 8, True),
    (torch.float32, 1, MAX_GRID_Y * 64 + 1, 8, False),
    (torch.float32, INT32_MAX, 1, 1, True), (torch.float32, INT32_MAX + 1, 1, 1, False),
    # bf16: persistent, BH * ceil(Sq / 128) q tiles ranked in 32 bits
    (torch.bfloat16, 1, MAX_GRID_Y * 128 + 1, 8, True),
    (torch.bfloat16, 2**15 - 1, 2**16 * 128, 8, True),   # 2^31 - 2^16 tiles
    (torch.bfloat16, 2**15, 2**16 * 128, 8, False),      # 2^31 tiles
    (torch.bfloat16, INT32_MAX, 1, 1, True), (torch.bfloat16, 1, 64, INT32_MAX + 1, False),
])
def test_grid_fits_the_launch_limits(dtype, BH, Sq, Sk, fits):
    """The wrapper refuses calls past a kernel's grid or its 32-bit sizes,
    rather than let the launch fail or ctypes cut an int."""
    assert grid_fits(BH, Sq, Sk, dtype) is fits


def test_q_rows_per_tile_match_the_kernels():
    """The wrapper's grid rule uses the q rows per tile of the CUDA source:
    128 for the bf16 kernel (two 64-row consumer warpgroups), 64 for f32."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    assert "constexpr int BM = 128;" in src
    assert "constexpr int F32_BM = 64;" in src
    assert Q_ROWS_PER_TILE == {torch.bfloat16: 128, torch.float32: 64}
