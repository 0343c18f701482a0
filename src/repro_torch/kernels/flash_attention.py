"""Flash attention forward on Hopper: wrapper of ``csrc/flash_attention.cu``.

The CUDA kernel replaces the TPU kernel
``src/repro/kernels/flash_attention.py::flash_attention_tpu`` and computes
the same function (causal / sliding window / GQA, f32 softmax statistics);
its source says what bounds it and how it is tiled. Its plain version is
``kernels/ref.py::flash_attention_oracle``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

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
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
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


def _check(q, k, v, causal, window):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_fwd runs on one CUDA device; got "
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


def flash_attention_fwd(q, k, v, *, scale=None, causal=True, window=0):
    """q (BH,Sq,hd); k/v (BKV,Sk,hd) with BH = BKV*G, on a CUDA device.

    Returns (BH,Sq,hd) in q's dtype. Launches the kernel on the current
    stream and adds one to ``flash_attention_fwd.launches``."""
    _check(q, k, v, causal, window)
    BH, Sq, hd = q.shape
    BKV, Sk, _ = k.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            BH, BKV, Sq, Sk, hd, _DTYPES[q.dtype], int(bool(causal)),
            int(window), float(scale), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError("flash_attention_fwd launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0
