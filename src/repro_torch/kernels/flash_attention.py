"""Flash attention on Hopper: wrappers of ``csrc/flash_attention.cu`` (the
forward) and ``csrc/flash_attention_bwd.cu`` (its gradient).

The forward kernel replaces the TPU kernel
``src/repro/kernels/flash_attention.py::flash_attention_tpu`` and computes
the same function (causal / sliding window / GQA, f32 softmax statistics);
the backward computes that function's gradient, which the JAX package takes
through XLA. Each source says what bounds it and how it is tiled. Their
plain versions are ``kernels/ref.py::flash_attention_oracle`` and
``flash_attention_bwd_oracle``.
"""
from __future__ import annotations

import ctypes
import math

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build, ref

HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# q rows per tile of each kernel; every size reaches the kernels as a 32-bit
# int (the bf16 kernel's TMA coordinates are 32-bit too)
Q_ROWS_PER_TILE = {torch.float32: 64, torch.bfloat16: 128}
MAX_GRID_Y = 65535
INT32_MAX = 2**31 - 1


def _library():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def rows_without_keys(Sq, Sk, causal, window):
    """True when some query row of a (Sq, Sk) call would see no valid key.

    The mask keeps key kpos for query qpos when kpos < Sk, kpos <= qpos
    (causal) and qpos - kpos < window (window > 0). Without a window every
    row keeps key 0, so only a window empties a row: the last row,
    qpos Sq - 1, keeps nothing once Sq - window >= Sk. There the kernel
    writes 0 where the plain version returns the mean of v, so the wrapper
    refuses the call. (Sk == 0 empties every row.)"""
    if Sq <= 0:
        return False
    return Sk <= 0 or (window > 0 and Sq >= Sk + window)


def grid_fits(BH, Sq, Sk, dtype):
    """True when a (BH, Sq) x (Sk) call fits the kernel's 32-bit sizes and
    grid. The bf16 kernel is persistent (a block per SM) and ranks its
    BH * ceil(Sq / 128) q tiles in 32 bits; the f32 kernel's grid is
    (BH, ceil(Sq / 64)), and a grid's y extent is at most 65535."""
    q_tiles = -(-Sq // Q_ROWS_PER_TILE[dtype])
    if max(BH, Sq, Sk) > INT32_MAX:
        return False
    if dtype == torch.bfloat16:
        return BH * q_tiles <= INT32_MAX
    return q_tiles <= MAX_GRID_Y


def _bwd_library():
    lib = build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


# the backward's tiles, in csrc/flash_attention_bwd.cu. bf16: a dK/dV block
# owns BWD_BN keys (64-row q tiles stream past it), a dQ block 128 q rows;
# f32: 64-row q tiles, 64 keys (32 at hd 256). D takes a block per 8 rows.
BWD_BN, BWD_DQ_ROWS, BWD_F32_Q_ROWS, BWD_ROWS_PER_BLOCK = 64, 128, 64, 8
# the G split aims the bf16 dK/dV grid at two waves of 132 SMs
BWD_MIN_BLOCKS = 256


def bwd_f32_keys_per_tile(hd):
    return 32 if hd >= 256 else 64


def bwd_head_splits(BKV, G, Sk):
    """Blocks that share a kv tile's G query heads in the bf16 dK/dV kernel
    (``head_splits`` in the CUDA source): the fewest, a divisor of G, that
    give the grid BWD_MIN_BLOCKS blocks, or G when none does. A split block
    writes f32 partial dK and dV that a reduction kernel sums in split order,
    so every call gives the same bits."""
    tiles = BKV * -(-Sk // BWD_BN)
    return next((s for s in range(1, G) if G % s == 0 and tiles * s >= BWD_MIN_BLOCKS), G)


def bwd_scratch_floats(BH, BKV, Sq, Sk, hd, dtype):
    """f32 scratch of one backward call: D for the (BH, Sq) rows, rounded up
    to 64 floats, then for a split bf16 call the dK and dV partials,
    2 x splits x (BKV, Sk, hd)."""
    n = -(-(BH * Sq) // 64) * 64
    splits = bwd_head_splits(BKV, BH // BKV, Sk) if dtype == torch.bfloat16 else 1
    return n + (2 * splits * BKV * Sk * hd if splits > 1 else 0)


def bwd_blocks(BH, BKV, Sq, Sk, hd, dtype):
    """The most blocks any of the backward's kernels launches for a call
    (each grid is one-dimensional; the reduction's grid is capped)."""
    d_blocks = -(-(BH * Sq) // BWD_ROWS_PER_BLOCK)
    if dtype == torch.bfloat16:
        splits = bwd_head_splits(BKV, BH // BKV, Sk)
        return max(d_blocks, BKV * -(-Sk // BWD_BN) * splits, BH * -(-Sq // BWD_DQ_ROWS))
    return max(d_blocks, BH * -(-Sq // BWD_F32_Q_ROWS), BKV * -(-Sk // bwd_f32_keys_per_tile(hd)))


def _check(q, k, v, causal, window, what="flash_attention_fwd"):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{what} runs on one CUDA device; got "
                         f"q on {q.device}, k on {k.device}, v on {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes must all be float32 or bfloat16; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"want q (BH,Sq,hd), k/v (BKV,Sk,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    BH, _, hd = q.shape
    BKV = k.shape[0]
    if k.shape[2] != hd or BKV == 0 or BH % BKV:
        raise ValueError(f"q heads {BH} must be a multiple of kv heads {BKV} "
                         f"and head dims must agree ({hd} vs {k.shape[2]})")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if not grid_fits(BH, q.shape[1], k.shape[1], q.dtype):
        raise ValueError(f"BH {BH}, Sq {q.shape[1]}, Sk {k.shape[1]}: past the "
                         f"{q.dtype} kernel's 32-bit sizes or grid (q tiles of "
                         f"{Q_ROWS_PER_TILE[q.dtype]} rows)")
    if rows_without_keys(q.shape[1], k.shape[1], causal, window):
        raise ValueError(f"Sq {q.shape[1]}, Sk {k.shape[1]}, window {window}: "
                         "some query rows see no valid key")


def flash_attention_fwd(q, k, v, *, scale=None, causal=True, window=0,
                        return_lse=False):
    """q (BH,Sq,hd); k/v (BKV,Sk,hd) with BH = BKV*G, on a CUDA device.

    Returns (BH,Sq,hd) in q's dtype, and with ``return_lse`` also the rows'
    logsumexp of the scaled, masked scores (BH,Sq) in f32, which the
    backward takes. Launches the kernel on the current stream and adds one
    to ``flash_attention_fwd.launches``."""
    _check(q, k, v, causal, window)
    BH, Sq, hd = q.shape
    BKV, Sk, _ = k.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    lse = (torch.empty(BH, Sq, dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None,
            BH, BKV, Sq, Sk, hd, _DTYPES[q.dtype], int(bool(causal)),
            int(window), float(scale), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError("flash_attention_fwd launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    flash_attention_fwd.launches += 1
    return (out, lse) if return_lse else out


flash_attention_fwd.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, *, scale=None, causal=True, window=0):
    """Gradient of ``flash_attention_fwd`` on a CUDA device.

    q, o, do (BH,Sq,hd); k/v (BKV,Sk,hd); lse (BH,Sq) f32 from the forward
    with ``return_lse``. Takes the calls the forward takes and refuses the
    rest. Returns (dq, dk, dv) in q's dtype, dk and dv summed over each kv
    head's G query heads. Launches its kernels (three, four when the bf16
    dK/dV kernel splits a kv head's query heads) on the current stream and
    adds one to ``flash_attention_bwd.launches``."""
    _check(q, k, v, causal, window, "flash_attention_bwd")
    BH, Sq, hd = q.shape
    BKV, Sk, _ = k.shape
    for name, x in (("o", o), ("do", do)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} must match q: got {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if (lse.shape != (BH, Sq) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be ({BH}, {Sq}) contiguous float32 on "
                         f"{q.device}; got {tuple(lse.shape)} {lse.dtype}")
    if bwd_blocks(BH, BKV, Sq, Sk, hd, q.dtype) > INT32_MAX:
        raise ValueError(f"BH {BH}, Sq {Sq}, Sk {Sk}: past the backward "
                         "kernels' 32-bit grids")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    scratch = torch.empty(bwd_scratch_floats(BH, BKV, Sq, Sk, hd, q.dtype),
                          dtype=torch.float32, device=q.device)
    lib = _bwd_library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            scratch.data_ptr(), BH, BKV, Sq, Sk, hd, _DTYPES[q.dtype],
            int(bool(causal)), int(window), float(scale),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError("flash_attention_bwd launch failed: "
                           + lib.flash_attention_bwd_error_string(err).decode())
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


# -- the operators ------------------------------------------------------------
# K1 and its backward as operators of their own (torch.library), which
# ``kernels/ops.py`` calls: on a CUDA tensor each runs its wrapper above (the
# kernel, its checks and its launch count), on a CPU tensor the plain version,
# on a fake tensor (``core/capture.py``) only the outputs' shapes, so that a
# trace records each call as one node. The forward is two operators, one for
# each set of outputs, since an operator's outputs are fixed.

_ATTN_ARGS = "Tensor q, Tensor k, Tensor v, float? scale, bool causal, int window"


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=(),
                         device_types="cuda", schema=f"({_ATTN_ARGS}) -> Tensor")
def flash_attention_fwd_op(q, k, v, scale, causal, window):
    """(BH,Sq,hd) output of K1; ``flash_attention_fwd`` on the card."""
    return flash_attention_fwd(q, k, v, scale=scale, causal=causal, window=window)


@torch.library.custom_op("repro_torch::flash_attention_fwd_lse", mutates_args=(),
                         device_types="cuda", schema=f"({_ATTN_ARGS}) -> (Tensor, Tensor)")
def flash_attention_fwd_lse_op(q, k, v, scale, causal, window):
    """K1's output and its rows' logsumexp, which the backward reads."""
    return flash_attention_fwd(q, k, v, scale=scale, causal=causal, window=window,
                               return_lse=True)


@torch.library.custom_op(
    "repro_torch::flash_attention_bwd", mutates_args=(), device_types="cuda",
    schema="(Tensor q, Tensor k, Tensor v, Tensor o, Tensor lse, Tensor do, float? scale, "
           "bool causal, int window) -> (Tensor, Tensor, Tensor)")
def flash_attention_bwd_op(q, k, v, o, lse, do, scale, causal, window):
    """(dq, dk, dv) of K1's backward; ``flash_attention_bwd`` on the card."""
    return flash_attention_bwd(q, k, v, o, lse, do, scale=scale, causal=causal,
                               window=window)


@flash_attention_fwd_op.register_kernel("cpu")
def _(q, k, v, scale, causal, window):
    return ref.flash_attention_oracle(q, k, v, scale=scale, causal=causal, window=window)


@flash_attention_fwd_lse_op.register_kernel("cpu")
def _(q, k, v, scale, causal, window):
    return ref.flash_attention_oracle(q, k, v, scale=scale, causal=causal, window=window,
                                      return_lse=True)


@flash_attention_bwd_op.register_kernel("cpu")
def _(q, k, v, o, lse, do, scale, causal, window):
    return ref.flash_attention_bwd_oracle(q, k, v, o, lse, do, scale=scale, causal=causal,
                                          window=window)


@flash_attention_fwd_op.register_fake
def _(q, k, v, scale, causal, window):
    return torch.empty_like(q)


@flash_attention_fwd_lse_op.register_fake
def _(q, k, v, scale, causal, window):
    lse_dtype = torch.promote_types(q.dtype, torch.float32)
    return torch.empty_like(q), q.new_empty(q.shape[:2], dtype=lse_dtype)


@flash_attention_bwd_op.register_fake
def _(q, k, v, o, lse, do, scale, causal, window):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def flops(q_shape, k_shape):
    """The products of the plain forward, as ``FlopCounterMode`` counts them:
    scores and P V over every (q, k) pair of each of the BH heads, whatever
    the mask, 2 hd each."""
    (BH, Sq, hd), Sk = q_shape, k_shape[1]
    return 4 * BH * Sq * Sk * hd


def bwd_flops(q_shape, k_shape):
    """The plain backward's five products (the scores again, dV, dP, dQ,
    dK), as ``FlopCounterMode`` counts them."""
    return 5 * flops(q_shape, k_shape) // 2


@register_flop_formula([torch.ops.repro_torch.flash_attention_fwd,
                        torch.ops.repro_torch.flash_attention_fwd_lse])
def _(q_shape, k_shape, *args, out_shape=None, **kwargs):
    return flops(q_shape, k_shape)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _(q_shape, k_shape, *args, out_shape=None, **kwargs):
    return bwd_flops(q_shape, k_shape)
