"""Mamba2 SSD forward on Hopper: wrapper of ``csrc/ssd.cu``.

The CUDA kernel replaces the TPU kernel ``src/repro/kernels/ssd.py::ssd_tpu``
and computes the same function (chunked SSD, f32 in and out, every product
in 3xTF32 on the tensor cores); its source says what bounds it and how the
chunk loop is split across blocks. Its plain version is
``kernels/ref.py::ssd_oracle``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64)
MAX_STATE = 256
MAX_CHUNK = 4096
TILE = 64          # C B^T rows and columns are padded to it (TQ in csrc/ssd.cu)


def _library():
    lib = build.load("ssd")
    fn = lib.ssd_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ssd_error_string.argtypes = [ctypes.c_int]
        lib.ssd_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, dt, A, B, C, chunk):
    """Raise ValueError for anything the kernel does not take."""
    named = (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C))
    if not (x.is_cuda and all(t.device == x.device for _, t in named)):
        raise ValueError("ssd_fwd runs on one CUDA device; got "
                         + ", ".join(f"{k} on {t.device}" for k, t in named))
    if any(t.dtype != torch.float32 for _, t in named):
        raise ValueError("ssd_fwd takes float32 only; got "
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


def ssd_fwd(x, dt, A, B, C, *, chunk=256):
    """x (b,s,h,p), dt (b,s,h), A (h,), B/C (b,s,n): float32 on a CUDA device.

    Returns (y (b,s,h,p), S_final (b,h,n,p)) in float32. Launches the
    kernel (four CUDA kernels in order on the current stream) and adds one
    to ``ssd_fwd.launches``."""
    _check(x, dt, A, B, C, chunk)
    b, s, h, p = x.shape
    n = B.shape[-1]
    y = torch.empty_like(x)
    s_final = torch.empty(b, h, n, p, dtype=torch.float32, device=x.device)
    if s == 0:
        return y, s_final.zero_()
    scratch = {name: torch.empty(shape, dtype=torch.float32, device=x.device)
               for name, shape in scratch_shapes(b, s, h, p, n, chunk).items()}
    lib = _library()
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
    return y, s_final


ssd_fwd.launches = 0
