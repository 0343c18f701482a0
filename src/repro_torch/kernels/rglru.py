"""RG-LRU linear-recurrence scan on Hopper: wrappers of ``csrc/rglru.cu``
and of its backward, ``csrc/rglru_bwd.cu``.

The forward kernel replaces the TPU kernel
``src/repro/kernels/rglru.py::rglru_scan_tpu`` and computes the same function
(h_t = a_t h_{t-1} + b_t over (B,S,C), h_0 = 0, f32); the backward kernel
computes its gradient, which the JAX package takes through XLA. Each source
says what bounds it and how the carry is handed from one time chunk to the
next. Their plain versions are ``kernels/ref.py::rglru_scan_oracle`` and
``rglru_scan_bwd_oracle``.
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build, ref

CHUNK = 64          # time steps per tile: ``T`` in csrc/rglru.cu


def scratch_floats(B, S, C):
    """Floats of scratch the kernel takes for (B,S,C), as the C function
    ``rglru_scratch_floats`` counts them: the tile counter and one hand-off
    word per (b, chunk, channel) for every chunk but the last, 8 bytes each."""
    nc = -(-S // CHUNK)
    return 2 * (1 + B * max(nc - 1, 0) * C)


def bwd_scratch_floats(B, S, C):
    """Floats of scratch the backward kernel takes for (B,S,C), as the C
    function ``rglru_bwd_scratch_floats`` counts them: the tile counter and one
    hand-off word per (b, chunk, channel) for every chunk but the first, 8
    bytes each."""
    return scratch_floats(B, S, C)


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


def _bwd_library():
    lib = build.load("rglru_bwd")
    fn = lib.rglru_scan_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.rglru_bwd_scratch_floats.argtypes = [ctypes.c_int] * 3
        lib.rglru_bwd_scratch_floats.restype = ctypes.c_longlong
        lib.rglru_bwd_error_string.argtypes = [ctypes.c_int]
        lib.rglru_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check(fn, **tensors):
    """Raise ValueError for anything the kernel ``fn`` does not take."""
    x = next(iter(tensors.values()))
    if not (x.is_cuda and all(t.device == x.device for t in tensors.values())):
        raise ValueError(f"{fn} runs on one CUDA device; got " + ", ".join(
            f"{n} on {t.device}" for n, t in tensors.items()))
    if any(t.dtype != torch.float32 for t in tensors.values()):
        raise ValueError(f"{fn} takes float32 only; got " + ", ".join(
            f"{n} {t.dtype}" for n, t in tensors.items()))
    if x.dim() != 3 or any(t.shape != x.shape for t in tensors.values()):
        raise ValueError(f"want {', '.join(tensors)} of one shape (B,S,C); got " + " and ".join(
            str(tuple(t.shape)) for t in tensors.values()))
    for name, t in tensors.items():
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def rglru_scan_fwd(a, b):
    """a, b (B,S,C): float32 on a CUDA device -> h (B,S,C) float32.

    Zeroes the kernel's scratch (one memset) and launches its one CUDA kernel
    on the current stream, and adds one to ``rglru_scan_fwd.launches``."""
    _check("rglru_scan_fwd", a=a, b=b)
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


def rglru_scan_bwd(a, h, dh):
    """a, h, dh (B,S,C): float32 on a CUDA device, h the forward's output ->
    (da, db) (B,S,C) float32, the gradient of ``rglru_scan_fwd``'s h.

    Zeroes the kernel's scratch (one memset) and launches its one CUDA kernel
    on the current stream, and adds one to ``rglru_scan_bwd.launches``."""
    _check("rglru_scan_bwd", a=a, h=h, dh=dh)
    B, S, C = a.shape
    da, db = torch.empty_like(a), torch.empty_like(a)
    if a.numel() == 0:
        return da, db
    lib = _bwd_library()
    scratch = torch.empty(lib.rglru_bwd_scratch_floats(B, S, C), dtype=torch.float32,
                          device=a.device)
    with torch.cuda.device(a.device):
        err = lib.rglru_scan_bwd(a.data_ptr(), h.data_ptr(), dh.data_ptr(), da.data_ptr(),
                                 db.data_ptr(), scratch.data_ptr(), B, S, C,
                                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError("rglru_scan_bwd launch failed: "
                           + lib.rglru_bwd_error_string(err).decode())
    rglru_scan_bwd.launches += 1
    return da, db


rglru_scan_bwd.launches = 0


# -- the operators ------------------------------------------------------------
# K3 and its backward as operators of their own (torch.library), which
# ``kernels/ops.py`` calls: on a CUDA tensor each runs its wrapper above (the
# kernel, its checks and its launch count), on a CPU tensor the plain version,
# on a fake tensor (``core/capture.py``) only the outputs' shapes, so that a
# trace records each call as one node.

@torch.library.custom_op("repro_torch::rglru_scan_fwd", mutates_args=(), device_types="cuda",
                         schema="(Tensor a, Tensor b) -> Tensor")
def rglru_scan_fwd_op(a, b):
    """h of K3; ``rglru_scan_fwd`` on the card."""
    return rglru_scan_fwd(a, b)


@torch.library.custom_op("repro_torch::rglru_scan_bwd", mutates_args=(), device_types="cuda",
                         schema="(Tensor a, Tensor h, Tensor dh) -> (Tensor, Tensor)")
def rglru_scan_bwd_op(a, h, dh):
    """(da, db) of K3's backward; ``rglru_scan_bwd`` on the card."""
    return rglru_scan_bwd(a, h, dh)


@rglru_scan_fwd_op.register_kernel("cpu")
def _(a, b):
    return ref.rglru_scan_oracle(a, b)


@rglru_scan_bwd_op.register_kernel("cpu")
def _(a, h, dh):
    return ref.rglru_scan_bwd_oracle(a, h, dh)


def _fake_like(a):
    return a.new_empty(a.shape, dtype=torch.promote_types(a.dtype, torch.float32))


@rglru_scan_fwd_op.register_fake
def _(a, b):
    return _fake_like(a)


@rglru_scan_bwd_op.register_fake
def _(a, h, dh):
    return _fake_like(a), _fake_like(a)


@register_flop_formula([torch.ops.repro_torch.rglru_scan_fwd,
                        torch.ops.repro_torch.rglru_scan_bwd])
def _(*args, out_shape=None, **kwargs):
    """The recurrence and its gradient are elementwise: ``FlopCounterMode``
    counts 0 over their plain versions, as the JAX capture counts no dot in
    the scan's ``rglru_vmem`` scope."""
    return 0
