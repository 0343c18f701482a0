#!/usr/bin/env python3
"""Time this tree's SSD kernel (K2) against earlier sources of it, in one
process on one card, at the mamba2-780m serving shape.

  git show HEAD:src/repro_torch/kernels/csrc/ssd.cu > build/parent/ssd.cu
  python3 scripts/ssd_vs_parent.py build/parent/ssd.cu [more.cu ...] [--no-check]

Each earlier source is built with the port's nvcc flags next to itself and
called through its own C interface (``ssd_fwd`` with ten pointers, or eleven
with the C B^T scratch; the count is read from the source) behind the same
checks and allocations as ``kernels/ssd.py::ssd_fwd``. Every kernel is held
against ``ref.ssd_oracle`` (2e-3 x max(1, max |ref|)), then timed in turns
with ``chip_smoke.cuda_ms``, the yardstick of ``chip_smoke.py``: the earlier
sources in order, this tree twice, the earlier sources in reverse. Two calls
land on cards up to 15% apart; turns in one process do not. Each one's CUDA
kernels are listed with their device time per call (torch.profiler).
``--no-check`` times earlier sources whose results differ (diagnostic
variants) and still holds this tree's. Prints one JSON object and the card's
name and power limit; needs a GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
REPS = 20                                  # CUDA-event times a median is taken over


def pointer_args(source):
    """Pointers that the source's ssd_fwd takes before its six ints (the
    stream, its last argument, is not counted)."""
    text = open(source).read()
    sig = text[text.index("int ssd_fwd("):]
    return sig[:sig.index(")")].count("void*") - 1


def build_earlier(source):
    """nvcc an earlier source into a library beside it; returns it loaded and
    the number of pointers its ssd_fwd takes."""
    from repro_torch.kernels import build
    lib_path = os.path.splitext(source)[0] + "-earlier.so"
    t0 = time.perf_counter()
    # a source that includes ssd_common.cuh finds it beside itself first,
    # then in csrc/
    cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", os.path.dirname(os.path.abspath(source)),
           "-I", str(build.CSRC), "-o", lib_path, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed for {source}:\n{proc.stdout}{proc.stderr}")
    print(f"{source} built in {time.perf_counter() - t0:.1f}s", flush=True)
    n_ptr = pointer_args(source)
    if n_ptr not in (10, 11):
        raise SystemExit(f"{source}: ssd_fwd takes {n_ptr} pointers, not 10 or 11")
    lib = ctypes.CDLL(lib_path)
    lib.ssd_fwd.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.ssd_fwd.restype = ctypes.c_int
    return lib, n_ptr


def device_us_by_kernel(torch, fn, calls=5):
    """{CUDA kernel name: device microseconds per call} over `calls` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        out[e.key[:120]] = us / calls
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sources", nargs="+", help="earlier ssd.cu files")
    ap.add_argument("--no-check", action="store_true",
                    help="time without holding the earlier sources to the oracle "
                         "(for diagnostic variants that change the result)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ssd_vs_parent: no GPU found")
    from chip_smoke import BATCH, PROMPT, SEED, SSM_ARCH, cuda_ms, ssd_inputs
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd as kssd
    torch.backends.cuda.matmul.allow_tf32 = False

    earlier = {src: build_earlier(src) for src in args.sources}
    cfg = get_config(SSM_ARCH)
    b, s, h, p, n, chunk = BATCH, PROMPT, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, \
        cfg.ssm_chunk
    g = torch.Generator(device="cuda").manual_seed(SEED)
    x, dt, A, B, C = ssd_inputs(torch, g, b, s, h, p, n)

    def caller(lib, n_ptr):
        def run():                         # kernels/ssd.py::ssd_fwd's host work
            kssd._check(x, dt, A, B, C, chunk)
            y = torch.empty_like(x)
            sf = torch.empty(b, h, n, p, device="cuda")
            shapes = kssd.scratch_shapes(b, s, h, p, n, chunk)
            if n_ptr == 10:                # before C B^T had a scratch of its own
                del shapes["cb"]
            scratch = [torch.empty(shape, device="cuda") for shape in shapes.values()]
            err = lib.ssd_fwd(*(t.data_ptr() for t in (x, dt, A, B, C, y, sf, *scratch)),
                              b, s, h, p, n, min(chunk, s),
                              torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"earlier ssd_fwd failed: error {err}")
            return y, sf
        return run

    runs = {src: caller(*lib) for src, lib in earlier.items()}
    runs["this"] = lambda: kssd.ssd_fwd(x, dt, A, B, C, chunk=chunk)
    yr, sfr = ref.ssd_oracle(x, dt, A, B, C)
    scale = max(1.0, yr.abs().max().item(), sfr.abs().max().item())
    errs = {}
    for who, fn in runs.items():
        y, sf = fn()
        torch.cuda.synchronize()
        errs[who] = max((y - yr).abs().max().item(), (sf - sfr).abs().max().item())
        if not errs[who] <= 2e-3 * scale and not (args.no_check and who != "this"):
            raise SystemExit(f"{who}: max abs err {errs[who]:.3g} > 2e-3 x {scale:.4g}")
    del yr, sfr

    order = list(args.sources) + ["this", "this"] + list(reversed(args.sources))
    turns = [(who, cuda_ms(torch, runs[who], reps=REPS)) for who in order]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    ms = {who: [t for w, t in turns if w == who] for who in runs}
    result = {"shape": {"b": b, "s": s, "h": h, "p": p, "n": n, "chunk": chunk},
              "turns": turns, "ms": ms,
              "speedup": {src: statistics.mean(ms[src]) / statistics.mean(ms["this"])
                          for src in args.sources},
              "max_abs_err": errs, "max_abs_ref": scale, "reps": REPS, "card": card,
              "device_us_by_kernel": {who: device_us_by_kernel(torch, fn)
                                      for who, fn in runs.items()}}
    print(json.dumps(result))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
