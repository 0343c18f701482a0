"""RG-LRU linear-recurrence scan on Hopper: wrapper of ``csrc/rglru.cu``.

The CUDA kernel replaces the TPU kernel
``src/repro/kernels/rglru.py::rglru_scan_tpu`` and computes the same function
(h_t = a_t h_{t-1} + b_t over (B,S,C), h_0 = 0, f32); its source says what
bounds it and how the carry is handed from one time chunk to the next. Its
plain version is ``kernels/ref.py::rglru_scan_oracle``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

CHUNK = 64          # time steps per tile: ``T`` in csrc/rglru.cu


def scratch_floats(B, S, C):
    """Floats of scratch the kernel takes for (B,S,C), as the C function
    ``rglru_scratch_floats`` counts them: the tile counter and one hand-off
    word per (b, chunk, channel) for every chunk but the last, 8 bytes each."""
    nc = -(-S // CHUNK)
    return 2 * (1 + B * max(nc - 1, 0) * C)


def _library():
    lib = build.load("rglru")
    fn = lib.rglru_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.rglru_scratch_floats.argtypes = [ctypes.c_int] * 3
        lib.rglru_scratch_floats.restype = ctypes.c_longlong
        lib.rglru_error_string.argtypes = [ctypes.c_int]
        lib.rglru_error_string.restype = ctypes.c_char_p
    return lib


def _check(a, b):
    """Raise ValueError for anything the kernel does not take."""
    if not (a.is_cuda and b.device == a.device):
        raise ValueError(f"rglru_scan_fwd runs on one CUDA device; got a on "
                         f"{a.device}, b on {b.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"rglru_scan_fwd takes float32 only; got a {a.dtype}, "
                         f"b {b.dtype}")
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"want a and b of one shape (B,S,C); got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    for name, t in (("a", a), ("b", b)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def rglru_scan_fwd(a, b):
    """a, b (B,S,C): float32 on a CUDA device -> h (B,S,C) float32.

    Zeroes the kernel's scratch (one memset) and launches its one CUDA kernel
    on the current stream, and adds one to ``rglru_scan_fwd.launches``."""
    _check(a, b)
    B, S, C = a.shape
    h = torch.empty_like(a)
    if h.numel() == 0:
        return h
    lib = _library()
    scratch = torch.empty(lib.rglru_scratch_floats(B, S, C), dtype=torch.float32,
                          device=a.device)
    with torch.cuda.device(a.device):
        err = lib.rglru_scan_fwd(a.data_ptr(), b.data_ptr(), h.data_ptr(),
                                 scratch.data_ptr(), B, S, C,
                                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError("rglru_scan_fwd launch failed: "
                           + lib.rglru_error_string(err).decode())
    rglru_scan_fwd.launches += 1
    return h


rglru_scan_fwd.launches = 0
