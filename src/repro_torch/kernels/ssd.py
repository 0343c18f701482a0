"""Mamba2 SSD on Hopper: wrappers of ``csrc/ssd.cu`` and ``csrc/ssd_bwd.cu``.

The forward kernel replaces the TPU kernel ``src/repro/kernels/ssd.py::ssd_tpu``
and computes the same function (chunked SSD, f32 in and out, every product
in 3xTF32 on the tensor cores); its source says what bounds it and how the
chunk loop is split across blocks. Its plain version is
``kernels/ref.py::ssd_oracle``. The backward kernel computes the gradient of
that function (the JAX package takes it through XLA), from the per-chunk
states, cum and C B^T that the forward keeps on request; its plain version
is ``kernels/ref.py::ssd_bwd_oracle``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build, ref

HEAD_DIMS = (16, 32, 64)
MAX_STATE = 256
MAX_CHUNK = 4096
TILE = 64          # C B^T rows and columns are padded to it (TQ in csrc/ssd.cu)
MAX_STATE_BWD = 128  # the backward keeps a 64 x n tile of dB or dC in registers


def _library(source, fn_name, n_ptr):
    """csrc/<source>.cu, its C function `fn_name` (n_ptr pointers, six ints
    and the stream) and <source>_error_string, typed for ctypes."""
    lib = build.load(source)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{source}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib


def _check(x, dt, A, B, C, chunk, fn="ssd_fwd", more=()):
    """Raise ValueError for anything the kernel `fn` does not take; `more`
    names further tensors that must lie beside x, in f32, contiguous."""
    named = (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C), *more)
    if not (x.is_cuda and all(t.device == x.device for _, t in named)):
        raise ValueError(f"{fn} runs on one CUDA device; got "
                         + ", ".join(f"{k} on {t.device}" for k, t in named))
    if any(t.dtype != torch.float32 for _, t in named):
        raise ValueError(f"{fn} takes float32 only; got "
                         + ", ".join(f"{k} {t.dtype}" for k, t in named))
    if x.dim() != 4:
        raise ValueError(f"want x (b,s,h,p); got {tuple(x.shape)}")
    b, s, h, p = x.shape
    n = B.shape[-1] if B.dim() == 3 else -1
    if (dt.shape != (b, s, h) or A.shape != (h,) or B.shape != (b, s, n)
            or C.shape != (b, s, n)):
        raise ValueError(f"want x (b,s,h,p), dt (b,s,h), A (h,), B/C (b,s,n); got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    if p not in HEAD_DIMS:
        raise ValueError(f"head dim p={p} not in {HEAD_DIMS}")
    if n % 4 or not 0 < n <= MAX_STATE:
        raise ValueError(f"state size n={n} must be a multiple of 4 in "
                         f"(0, {MAX_STATE}]")
    if not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} must be in (0, {MAX_CHUNK}]")
    if b * h > 65535:
        raise ValueError(f"b*h = {b * h} is above the grid limit 65535")
    if s and -(-s // min(chunk, s)) > 65535:
        raise ValueError(f"{-(-s // min(chunk, s))} chunks of {chunk} rows are above "
                         "the grid limit 65535")
    for name, t in named:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def scratch_shapes(b, s, h, p, n, chunk):
    """Shapes of the kernel's scratch for s >= 1: each chunk's state, cum
    and decay per head, and C B^T once per (b, chunk), padded to whole
    TILE-row tiles."""
    Q = min(chunk, s)
    nc = -(-s // Q)
    Qp = -(-Q // TILE) * TILE
    return {"states": (b, h, nc, n, p), "cum": (b, h, nc, Q), "decay": (b, h, nc),
            "cb": (b, nc, Qp, Qp)}


def ssd_fwd(x, dt, A, B, C, *, chunk=256, return_saved=False):
    """x (b,s,h,p), dt (b,s,h), A (h,), B/C (b,s,n): float32 on a CUDA device.

    Returns (y (b,s,h,p), S_final (b,h,n,p)) in float32; with
    ``return_saved`` also the scratch the backward reads: the state entering
    each chunk (b,h,nc,n,p), cum (b,h,nc,Q) and C B^T (b,nc,Qp,Qp) (y and
    S_final are the same bits either way). Launches the kernel (four CUDA
    kernels in order on the current stream) and adds one to
    ``ssd_fwd.launches``."""
    _check(x, dt, A, B, C, chunk)
    b, s, h, p = x.shape
    n = B.shape[-1]
    y = torch.empty_like(x)
    s_final = torch.empty(b, h, n, p, dtype=torch.float32, device=x.device)
    if s == 0:
        s_final.zero_()
        return (y, s_final, None, None, None) if return_saved else (y, s_final)
    scratch = {name: torch.empty(shape, dtype=torch.float32, device=x.device)
               for name, shape in scratch_shapes(b, s, h, p, n, chunk).items()}
    lib = _library("ssd", "ssd_fwd", 11)
    with torch.cuda.device(x.device):
        err = lib.ssd_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), s_final.data_ptr(), *(scratch[k].data_ptr() for k in
                                                ("states", "cum", "decay", "cb")),
            b, s, h, p, n, min(chunk, s),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError("ssd_fwd launch failed: "
                           + lib.ssd_error_string(err).decode())
    ssd_fwd.launches += 1
    if return_saved:
        return y, s_final, scratch["states"], scratch["cum"], scratch["cb"]
    return y, s_final


ssd_fwd.launches = 0


# the backward's dx kernel walks a head group's heads per block; the groups
# aim its grid at ~4 waves of 132 SMs (MIN_BLOCKS in csrc/ssd_bwd.cu)
BWD_MIN_BLOCKS = 512


def bwd_head_groups(b, h, nc, ntile):
    """Head groups of the backward (``head_groups`` in the CUDA source): the
    fewest, a divisor of h, that give its dx kernel, a block per (b, group,
    chunk, 64-row tile), BWD_MIN_BLOCKS blocks, or h when none does. Each
    group sums its heads' P in head order; the groups' sums are summed in
    group order, so every call gives the same bits."""
    tiles = b * nc * ntile
    return next((g for g in range(1, h) if h % g == 0 and tiles * g >= BWD_MIN_BLOCKS), h)


def bwd_scratch_shapes(b, s, h, p, n, chunk):
    """Shapes of the backward's scratch for s >= 1, in the order its C
    function takes them: the gradient of each chunk's state and the state
    pass's blocks' shares of its dot with the state (a block per 1024
    floats of n x p); per head group
    the sum of P^T over its heads for each 64 x 64 tile pair j <= i of a
    chunk (packed, pair i (i + 1) / 2 + j) and its sums of the state terms
    of dB and dC; per row T's partial row sums by j-tile, dcum's state term,
    dw and u; and per chunk the share of dA."""
    Q = min(chunk, s)
    nc = -(-s // Q)
    ntile = -(-Q // TILE)
    G = bwd_head_groups(b, h, nc, ntile)
    return {"dstates": (b, h, nc, n, p), "sdot": (b, h, nc, -(-(n * p) // 1024)),
            "sump": (b, G, nc, ntile * (ntile + 1) // 2, TILE, TILE),
            "dBg": (b, G, s, n), "dCg": (b, G, s, n), "rowp": (b, h, nc, ntile, Q),
            "rows": (b, h, nc, Q), "dw": (b, h, nc, Q), "u": (b, h, nc, Q), "dapart": (b, h, nc)}


@functools.lru_cache(maxsize=64)
def _bwd_scratch_layout(b, s, h, p, n, chunk):
    """The backward's scratch as one allocation: (floats in all, each part's
    offset in bytes), every part on a 256-byte boundary."""
    sizes = [-(-math.prod(shape) // 64) * 64
             for shape in bwd_scratch_shapes(b, s, h, p, n, chunk).values()]
    return sum(sizes), tuple(4 * sum(sizes[:k]) for k in range(len(sizes)))


def ssd_bwd(x, dt, A, B, C, dy, dS_final, states, cum, cb, *, chunk=256):
    """The gradient of ``ssd_fwd``: x, dt, A, B, C as it took them, dy
    (b,s,h,p), dS_final (b,h,n,p) or None (zero, passed as a null pointer),
    and what ``ssd_fwd(..., return_saved=True)`` kept: states, cum, cb.

    Returns (dx, ddt, dA, dB, dC) in float32. Launches the kernel (eight CUDA
    kernels in order on the current stream, no float atomics: every call
    gives the same bits) and adds one to ``ssd_bwd.launches``. P is summed
    over head groups (``bwd_head_groups``) before it meets B and C."""
    if B.shape[-1] > MAX_STATE_BWD:
        raise ValueError(f"ssd_bwd takes a state size n <= {MAX_STATE_BWD}; got {B.shape[-1]}")
    want_ds = (x.shape[0], x.shape[2], B.shape[-1], x.shape[-1])
    if dy.shape != x.shape or (dS_final is not None and tuple(dS_final.shape) != want_ds):
        raise ValueError(f"want dy {tuple(x.shape)} and dS_final {want_ds} or None; got "
                         f"{tuple(dy.shape)}, "
                         f"{None if dS_final is None else tuple(dS_final.shape)}")
    more = [("dy", dy)] + ([("dS_final", dS_final)] if dS_final is not None else [])
    _check(x, dt, A, B, C, chunk, "ssd_bwd", more)
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s == 0:
        return (torch.zeros_like(x), torch.zeros_like(dt), torch.zeros_like(A),
                torch.zeros_like(B), torch.zeros_like(C))
    if -(-s // min(chunk, s)) * b * h > 2**31 - 1:
        raise ValueError(f"b*h*chunks = {-(-s // min(chunk, s)) * b * h} is above the grid "
                         "limit 2^31 - 1")
    want = scratch_shapes(b, s, h, p, n, chunk)
    for name, t in (("states", states), ("cum", cum), ("cb", cb)):
        if (not t.is_cuda or t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != want[name] or not t.is_contiguous()):
            raise ValueError(f"{name} must be the forward's f32 {want[name]} on {x.device}")
    grads = tuple(torch.empty_like(t) for t in (x, dt, A, B, C))   # every element written
    # the scratch in one allocation (host time a call)
    floats, offsets = _bwd_scratch_layout(b, s, h, p, n, chunk)
    scratch = torch.empty(floats, dtype=torch.float32, device=x.device)
    lib = _library("ssd_bwd", "ssd_bwd", 15 + len(offsets))
    args = (*(t.data_ptr() for t in (x, dt, A, B, C, dy)),
            None if dS_final is None else dS_final.data_ptr(),
            *(t.data_ptr() for t in (states, cum, cb, *grads)),
            *(scratch.data_ptr() + o for o in offsets), b, s, h, p, n, min(chunk, s))
    with torch.cuda.device(x.device):
        err = lib.ssd_bwd(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError("ssd_bwd launch failed: "
                           + lib.ssd_bwd_error_string(err).decode())
    ssd_bwd.launches += 1
    return grads


ssd_bwd.launches = 0


# -- the operators ------------------------------------------------------------
# K2 and its backward as operators of their own (torch.library), which
# ``kernels/ops.py`` calls: on a CUDA tensor each runs its wrapper above (the
# kernel, its checks and its launch count), on a CPU tensor the plain version,
# on a fake tensor (``core/capture.py``) only the outputs' shapes, so that a
# trace records each call as one node. The forward is two operators, one for
# each set of outputs; the plain forward keeps nothing for the backward, so
# only the card runs the second.

_SSD_ARGS = "Tensor x, Tensor dt, Tensor A, Tensor B, Tensor C, int chunk"


@torch.library.custom_op("repro_torch::ssd_fwd", mutates_args=(), device_types="cuda",
                         schema=f"({_SSD_ARGS}) -> (Tensor, Tensor)")
def ssd_fwd_op(x, dt, A, B, C, chunk):
    """(y, S_final) of K2; ``ssd_fwd`` on the card."""
    return ssd_fwd(x, dt, A, B, C, chunk=chunk)


@torch.library.custom_op("repro_torch::ssd_fwd_saved", mutates_args=(), device_types="cuda",
                         schema=f"({_SSD_ARGS}) -> (Tensor, Tensor, Tensor, Tensor, Tensor)")
def ssd_fwd_saved_op(x, dt, A, B, C, chunk):
    """(y, S_final, states, cum, cb): K2 with what its backward reads (empty
    tensors for s = 0, which the backward does not read)."""
    out = ssd_fwd(x, dt, A, B, C, chunk=chunk, return_saved=True)
    return tuple(x.new_empty(0) if t is None else t for t in out)


@torch.library.custom_op(
    "repro_torch::ssd_bwd", mutates_args=(), device_types="cuda",
    schema="(Tensor x, Tensor dt, Tensor A, Tensor B, Tensor C, Tensor dy, "
           "Tensor? dS_final, Tensor? states, Tensor? cum, Tensor? cb, int chunk) "
           "-> (Tensor, Tensor, Tensor, Tensor, Tensor)")
def ssd_bwd_op(x, dt, A, B, C, dy, dS_final, states, cum, cb, chunk):
    """(dx, ddt, dA, dB, dC) of K2's backward; ``ssd_bwd`` on the card, which
    needs the saved states, cum and cb of ``ssd_fwd_saved``."""
    if states is None or cum is None or cb is None:
        raise ValueError("ssd_bwd on the card reads the forward's states, cum and cb "
                         "(repro_torch::ssd_fwd_saved)")
    return ssd_bwd(x, dt, A, B, C, dy, dS_final, states, cum, cb, chunk=chunk)


@ssd_fwd_op.register_kernel("cpu")
def _(x, dt, A, B, C, chunk):
    return ref.ssd_oracle(x, dt, A, B, C)


@ssd_bwd_op.register_kernel("cpu")
def _(x, dt, A, B, C, dy, dS_final, states, cum, cb, chunk):
    # contiguous, as the kernel's (the plain backward slices its padded chunks)
    return tuple(g.contiguous() for g in
                 ref.ssd_bwd_oracle(x, dt, A, B, C, dy, dS_final, chunk=chunk))


def _f32(x):
    """The dtype of the plain version's outputs: at least float32."""
    return torch.promote_types(x.dtype, torch.float32)


def _fake_fwd(x, B):
    b, _, h, p = x.shape
    return (torch.empty_like(x, dtype=_f32(x)),
            x.new_empty(b, h, B.shape[-1], p, dtype=_f32(x)))


@ssd_fwd_op.register_fake
def _(x, dt, A, B, C, chunk):
    return _fake_fwd(x, B)


@ssd_fwd_saved_op.register_fake
def _(x, dt, A, B, C, chunk):
    b, s, h, p = x.shape
    if s == 0:
        return (*_fake_fwd(x, B), *(x.new_empty(0, dtype=_f32(x)) for _ in range(3)))
    shapes = scratch_shapes(b, s, h, p, B.shape[-1], chunk)
    return (*_fake_fwd(x, B),
            *(x.new_empty(shapes[k], dtype=_f32(x)) for k in ("states", "cum", "cb")))


@ssd_bwd_op.register_fake
def _(x, dt, A, B, C, dy, dS_final, states, cum, cb, chunk):
    return tuple(torch.empty_like(t, dtype=_f32(x)) for t in (x, dt, A, B, C))


def flops(x_shape, n):
    """The products of the plain forward (one step at a time), as
    ``FlopCounterMode`` counts them: at each step the readout C S, 2 h p n
    (the state update B x^T is an outer product, which einsum computes
    elementwise, and the counter counts no elementwise work)."""
    b, s, h, p = x_shape
    return 2 * b * s * h * p * n


def bwd_flops(x_shape, n, chunk):
    """The plain backward's products, as ``FlopCounterMode`` counts them,
    over nc chunks of Q = min(chunk, s) rows (the last one padded): C B^T,
    (sum P) B and (sum P)^T C, 2 Q^2 n each; dy x^T and M^T dy per head, 2
    Q^2 p each; the chunk states, their gradients and the products of B, C,
    x and dy with them, five of 2 Q n p per head."""
    b, s, h, p = x_shape
    if s == 0:
        return 0
    Q = min(chunk, s)
    nc = -(-s // Q)
    return 2 * b * nc * Q * (3 * Q * n + 2 * h * Q * p + 5 * h * n * p)


@register_flop_formula([torch.ops.repro_torch.ssd_fwd, torch.ops.repro_torch.ssd_fwd_saved])
def _(x_shape, dt_shape, A_shape, B_shape, *args, out_shape=None, **kwargs):
    return flops(x_shape, B_shape[-1])


@register_flop_formula(torch.ops.repro_torch.ssd_bwd)
def _(x_shape, dt_shape, A_shape, B_shape, C_shape, dy_shape, dS_shape, states_shape,
      cum_shape, cb_shape, chunk, *args, out_shape=None, **kwargs):
    return bwd_flops(x_shape, B_shape[-1], chunk)
