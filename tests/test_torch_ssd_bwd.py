"""K2's backward on the CPU: the plain backward (``ref.ssd_bwd_oracle``)
against autograd of the plain forward and against ``jax.grad`` of the JAX
package's oracle; the ``ops.SSD`` autograd Function against finite
differences; the kernel's 3xTF32 products emulated on the CPU; the CUDA
wrapper's refusals and scratch.

Tolerances, with their reasons:
  * plain backward vs autograd of the sequential oracle, float64: 1e-10 x
    max(1, max |ref|) per tensor (the chunked and sequential forms differ in
    summation order only; measured ~1e-14);
  * vs jax.grad of the JAX oracle, f32: 2e-4 x max(1, max |ref|), the
    bound of the mamba2 gradient parity (tests/test_torch_train_parity.py):
    exponentials of cumulative sums taken in another order;
  * gradcheck in float64 at its default tolerances;
  * the backward's products in emulated 3xTF32 against the plain backward:
    chip_smoke.py's SSD_BWD_RTOL x max(1, max |ref|), the bound it holds
    the kernel to on the card; the same products in plain TF32 miss it,
    so the bound catches a lost 3xTF32 split.
The JAX oracle is used, not ``ssd_chunked``, whose f32 gradient is NaN
(exp overflows above the diagonal and 0 * inf is NaN; ROADMAP queue 3).
"""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import ssd as kssd  # noqa: E402
from repro_torch.kernels.ssd import ssd_bwd, ssd_fwd  # noqa: E402
from test_torch_ssd import _mm, _ssd_inputs  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the suite runs in several worker processes
    at once, and torch's CPU thread pools in each would contend for the
    same cores (restored after, for the other files a worker runs)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (s, chunk): tests/test_torch_ssd.py's sweep, a ragged last chunk, a chunk
# longer than the sequence, one row; each with dS_final None and given
CASES = [(s, chunk, with_ds) for s, chunk in [(80, 32), (64, 64), (96, 16), (50, 16),
                                             (20, 32), (1, 8)]
         for with_ds in (False, True)]


def _ids(case):
    s, chunk, with_ds = case
    return f"s{s}-chunk{chunk}-dS_final_{'given' if with_ds else 'None'}"


def _grads_inputs(seed, b, s, h, p, n):
    """x, dt, A, B, C as tests/test_kernels.py builds them, dy ~ N(0, 1) and
    dS_final ~ N(0, 1), all numpy f32."""
    rng = np.random.RandomState(seed + 100)
    dy = rng.randn(b, s, h, p).astype(np.float32)
    dsf = rng.randn(b, h, n, p).astype(np.float32)
    return [np.array(a) for a in _ssd_inputs(seed, b, s, h, p, n)], dy, dsf


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, rtol * scale)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_backward_matches_autograd_of_oracle_float64(case):
    s, chunk, with_ds = case
    args, dy, dsf = _grads_inputs(4, 2, s, 3, 16, 8)
    args = [torch.from_numpy(a).double() for a in args]
    dy, dsf = torch.from_numpy(dy).double(), torch.from_numpy(dsf).double()
    leaves = [a.clone().requires_grad_() for a in args]
    y, sf = ref.ssd_oracle(*leaves)
    assert y.dtype == sf.dtype == torch.float64
    loss = (y * dy).sum() + ((sf * dsf).sum() if with_ds else 0.0)
    want = torch.autograd.grad(loss, leaves)
    got = ref.ssd_bwd_oracle(*args, dy, dsf if with_ds else None, chunk=chunk)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        _close(g.numpy(), w.numpy(), 1e-10)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_backward_matches_jax_grad_of_jax_oracle(case):
    s, chunk, with_ds = case
    args, dy, dsf = _grads_inputs(5, 2, s, 3, 16, 8)
    (yj, sfj), vjp = jax.vjp(jref.ssd_oracle, *(jnp.asarray(a) for a in args))
    want = vjp((jnp.asarray(dy), jnp.asarray(dsf) if with_ds else jnp.zeros_like(sfj)))
    got = ref.ssd_bwd_oracle(*(torch.from_numpy(a) for a in args), torch.from_numpy(dy),
                             torch.from_numpy(dsf) if with_ds else None, chunk=chunk)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g.numpy(), np.asarray(w), 2e-4)


@pytest.mark.parametrize("chunk", [4, 16])
def test_ops_function_gradcheck_float64(chunk):
    """SSD's CPU path (sequential forward, chunked backward) against finite
    differences of its own forward, through y and S_final; s 10 is ragged
    against chunk 4 and shorter than chunk 16."""
    rng = np.random.RandomState(3)
    b, s, h, p, n = 1, 10, 2, 3, 4
    x = torch.from_numpy(rng.randn(b, s, h, p))
    dt = torch.nn.functional.softplus(torch.from_numpy(rng.randn(b, s, h)))
    A = -torch.exp(torch.from_numpy(rng.randn(h)) * 0.3)
    B, C = (torch.from_numpy(rng.randn(b, s, n) * 0.5) for _ in range(2))
    leaves = [t.requires_grad_() for t in (x, dt, A, B, C)]
    assert torch.autograd.gradcheck(lambda *a: ops.SSD.apply(*a, chunk), leaves)


def test_ops_ssd_under_autograd_runs_the_ssd_function():
    """Under autograd ops.ssd runs as ops.SSD (on the card: the forward and
    backward kernels) and no longer refuses; on the CPU it launches nothing
    and the gradient is the plain backward's."""
    args, dy, _ = _grads_inputs(6, 1, 40, 2, 16, 8)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    before = (ssd_fwd.launches, ssd_bwd.launches)
    y, sf = ops.ssd(*leaves, chunk=16)
    assert type(y.grad_fn).__name__ == "SSDBackward" and y.grad_fn is sf.grad_fn
    got = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    assert (ssd_fwd.launches, ssd_bwd.launches) == before
    want = ref.ssd_bwd_oracle(*(t.detach() for t in leaves), torch.from_numpy(dy), chunk=16)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with torch.no_grad():
        y2, _ = ops.ssd(*leaves, chunk=16)
    assert y2.grad_fn is None and torch.equal(y2, y.detach())
    src = (build.CSRC.parents[0] / "ops.py").read_text()
    assert '_no_backward("ssd"' not in src and "SSD.apply(" in src


# ---------------------------------------------------------------------------
# the kernel's numerics: its backward products in 3xTF32, emulated
# ---------------------------------------------------------------------------

def _chip_smoke_rtol():
    """SSD_BWD_RTOL as chip_smoke.py states it (read, not imported)."""
    tree = ast.parse((pathlib.Path(__file__).parents[1] / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and [getattr(t, "id", None) for t in node.targets] \
                == ["SSD_BWD_RTOL"]:
            return ast.literal_eval(node.value)
    raise AssertionError("chip_smoke.py states no SSD_BWD_RTOL")


# the sweep (b 2, h 3, p 16, n 8) and one mid shape at the served widths
NUMERICS = [(s, chunk, (2, 3, 16, 8)) for s, chunk in [(80, 32), (64, 64), (96, 16)]]
NUMERICS += [(512, 256, (1, 4, 64, 128))]


def _emulated_errors(s, chunk, dims, mode):
    """Each gradient's error, relative to max(1, max |ref|), when every
    product the kernel puts on its tensor cores (C B^T, the chunk states,
    dy x^T, M^T dy, P B, P^T C, B dS_out, x dS_out^T, dy S_prev^T,
    C^T (exp(cum) dy)) takes TF32 operands: "rn" 3xTF32 with cvt.rn splits,
    "tf32" one plain TF32 product."""
    b, h, p, n = dims
    args, dy, dsf = _grads_inputs(7, b, s, h, p, n)
    args, dy, dsf = [torch.from_numpy(a) for a in args], torch.from_numpy(dy), \
        torch.from_numpy(dsf)
    want = ref.ssd_bwd_oracle(*args, dy, dsf, chunk=chunk)
    got = ref.ssd_bwd_oracle(*args, dy, dsf, chunk=chunk,
                             matmul=lambda spec, a, b_: _mm(spec, a, b_, mode))
    return [(g - w).abs().max().item() / max(1.0, w.abs().max().item())
            for g, w in zip(got, want)]


_NUMERICS_IDS = lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v)  # noqa: E731


@pytest.mark.parametrize("s,chunk,dims", NUMERICS, ids=_NUMERICS_IDS)
def test_tf32_backward_products_against_the_plain_backward(s, chunk, dims):
    """The kernel's products in 3xTF32 keep every gradient within the bound
    chip_smoke.py holds the kernel to on the card."""
    rtol = _chip_smoke_rtol()
    errs = _emulated_errors(s, chunk, dims, "rn")
    assert max(errs) <= rtol, (errs, rtol)


@pytest.mark.parametrize("s,chunk,dims", NUMERICS, ids=_NUMERICS_IDS)
def test_plain_tf32_backward_products_miss_the_bound(s, chunk, dims):
    """The same products in plain TF32 put some gradient past that bound,
    so the card's check would catch a kernel that lost its 3xTF32 split."""
    rtol = _chip_smoke_rtol()
    errs = _emulated_errors(s, chunk, dims, "tf32")
    assert max(errs) > rtol, (errs, rtol)


# ---------------------------------------------------------------------------
# the CUDA wrapper (no card here)
# ---------------------------------------------------------------------------

def _no_build(monkeypatch):
    def refuse(name):
        raise AssertionError(f"built {name}")
    monkeypatch.setattr(build, "load", refuse)


def test_backward_kernel_refuses_cpu_tensors_before_it_builds(monkeypatch):
    _no_build(monkeypatch)
    args, dy, _ = _grads_inputs(8, 1, 8, 2, 16, 8)
    x, dt, A, B, C = (torch.from_numpy(a) for a in args)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_bwd(x, dt, A, B, C, torch.from_numpy(dy), None, None, None, None)


@pytest.mark.parametrize("what", ["n", "dy", "dS_final"])
def test_backward_kernel_refuses_what_it_does_not_take(monkeypatch, what):
    """A state above 128 (a 64 x n tile of dB or dC lives in registers), a dy
    or dS_final of another shape: refused before any device or build step."""
    _no_build(monkeypatch)
    n = 136 if what == "n" else 8
    args, dy, dsf = _grads_inputs(9, 1, 8, 2, 16, n)
    x, dt, A, B, C = (torch.from_numpy(a) for a in args)
    dy, dsf = torch.from_numpy(dy), torch.from_numpy(dsf)
    if what == "dy":
        dy = dy[:, :4]
    if what == "dS_final":
        dsf = dsf[..., :8]
    with pytest.raises(ValueError, match="n <= 128" if what == "n" else "want dy"):
        ssd_bwd(x, dt, A, B, C, dy, dsf, None, None, None)


def test_backward_scratch_shapes():
    """The training shape: 8 head groups; each group's sum of P^T per 64 x 64
    tile pair j <= i of a chunk (10 pairs of 4 tiles), 21.0 MB, and its state
    terms of dB and dC, (b, groups, s, n); per chunk the state pass's 8
    blocks' shares of <dS_out, S_prev>; per row T's partial row sums by
    j-tile, (b, h, nc, ntile, Q), and (b, h, nc, Q); per chunk (b, h, nc).
    The heads' shares of dB and dC, (b, h, s, n) at 100.7 MB each, are gone."""
    got = kssd.bwd_scratch_shapes(2, 2048, 48, 64, 128, 256)
    assert got == {"dstates": (2, 48, 8, 128, 64), "sdot": (2, 48, 8, 8),
                   "sump": (2, 8, 8, 10, 64, 64),
                   "dBg": (2, 8, 2048, 128), "dCg": (2, 8, 2048, 128),
                   "rowp": (2, 48, 8, 4, 256), "rows": (2, 48, 8, 256),
                   "dw": (2, 48, 8, 256), "u": (2, 48, 8, 256), "dapart": (2, 48, 8)}
    assert 4 * int(np.prod(got["sump"])) == 20_971_520
    assert kssd.bwd_scratch_shapes(1, 100, 4, 64, 128, 256)["rowp"] == (1, 4, 1, 2, 100)
    assert kssd.bwd_scratch_shapes(1, 100, 4, 64, 128, 256)["sump"] == (1, 4, 1, 3, 64, 64)


def test_backward_source_matches_the_wrapper():
    """The backward's tile is the forward's (it reads the forward's C B^T,
    padded to it), its state limit and head-group rule are the wrapper's, and
    its C function takes the wrapper's 25 pointers: 15 tensors and the 10 of
    bwd_scratch_shapes."""
    src = (build.CSRC / "ssd_bwd.cu").read_text()
    assert f"constexpr int TQ = {kssd.TILE};" in src
    assert f"constexpr int MAX_N = {kssd.MAX_STATE_BWD};" in src
    assert f"constexpr int MIN_BLOCKS = {kssd.BWD_MIN_BLOCKS};" in src
    assert "if (h % g == 0 && tiles * g >= MIN_BLOCKS) return g;" in src
    sig = src[src.index("int ssd_bwd("):]
    sig = sig[:sig.index("int b,")]
    assert sig.count("void*") == 25 == 15 + len(kssd.bwd_scratch_shapes(1, 8, 2, 16, 8, 8))
    # the scratch in the order the C function names it
    names = [w.strip().lstrip("*") for w in sig.split("void* dC,")[1].split(",") if w.strip()]
    assert names == [f"void* {k}" for k in kssd.bwd_scratch_shapes(1, 8, 2, 16, 8, 8)], names
    assert build.library_path("ssd_bwd").name.startswith("ssd_bwd-")
    assert [p.name for p in build.sources("ssd_bwd")] == ["ssd_bwd.cu", "ssd_common.cuh"]
    assert [p.name for p in build.sources("ssd")] == ["ssd.cu", "ssd_common.cuh"]


# (label, b, s, h, chunk, groups): the fewest head groups, a divisor of h,
# that give the dx kernel's grid (b x groups x chunks x 64-row tiles) 512 blocks
GROUP_CASES = [
    # mamba2-780m training: 2 x 8 chunks x 4 tiles = 64; 8 groups of 6 heads
    ("mamba2-780m training", 2, 2048, 48, 256, 8),
    # the mamba2-780m serving prefill: 4 x 8 x 4 = 128; 4 groups of 12 heads
    ("mamba2-780m prefill", 4, 2048, 48, 256, 4),
    # the sweep's h 3 and the served widths' h 4: too few tiles, a group a head
    ("sweep h3", 2, 80, 3, 32, 3),
    ("served widths h4", 1, 2049, 4, 256, 4),
    # h 4 with enough tiles: 1 x 64 chunks x 4 = 256; 2 groups of 2 heads
    ("h4 s16384", 1, 16384, 4, 256, 2),
]


@pytest.mark.parametrize("case", GROUP_CASES, ids=[c[0] for c in GROUP_CASES])
def test_backward_head_group_rule_and_scratch(case):
    """The head-group rule at the training and serving shapes and at the
    sweep's h 3 and h 4: a divisor of h, the fewest that give 512 blocks or
    h; the group sums' scratch follows the groups."""
    _, b, s, h, chunk, groups = case
    Q = min(chunk, s)
    nc, ntile = -(-s // Q), -(-Q // kssd.TILE)
    assert kssd.bwd_head_groups(b, h, nc, ntile) == groups
    assert h % groups == 0
    tiles = b * nc * ntile
    assert tiles * groups >= kssd.BWD_MIN_BLOCKS or groups == h
    assert all(h % g or tiles * g < kssd.BWD_MIN_BLOCKS for g in range(1, groups))
    got = kssd.bwd_scratch_shapes(b, s, h, 64, 128, chunk)
    assert got["sump"] == (b, groups, nc, ntile * (ntile + 1) // 2, 64, 64)
    assert got["dBg"] == got["dCg"] == (b, groups, s, 128)


@pytest.mark.parametrize("dims", [(2, 2048, 48, 64, 128, 256), (4, 2048, 48, 64, 128, 256),
                                  (1, 16384, 4, 64, 128, 256)],
                         ids=["training", "prefill", "h4-s16384"])
def test_backward_scratch_has_no_per_head_share_of_db_or_dc(dims):
    """Where the heads form fewer groups than heads, no scratch is (b, h, s,
    n): dB and dC are summed over head groups, and the whole scratch at the
    training shape is under 90 MB (the heads' shares alone were 201 MB)."""
    b, s, h, p, n, chunk = dims
    shapes = kssd.bwd_scratch_shapes(b, s, h, p, n, chunk)
    assert shapes["dBg"][1] < h
    assert all(shape[:2] != (b, h) or s not in shape for shape in shapes.values())
    if dims[:3] == (2, 2048, 48):
        assert 4 * sum(int(np.prod(shape)) for shape in shapes.values()) < 90e6
