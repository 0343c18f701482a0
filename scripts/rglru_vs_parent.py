#!/usr/bin/env python3
"""Time this tree's RG-LRU scan kernel (K3) against earlier sources of it, in
one process on one card, at the recurrentgemma-9b serving shape.

  mkdir -p build/parent
  git show HEAD:src/repro_torch/kernels/csrc/rglru.cu > build/parent/rglru.cu
  python3 scripts/rglru_vs_parent.py build/parent/rglru.cu [more.cu ...]

Each earlier source is built with the port's nvcc flags next to itself and
called through the C interface every version of it shares
(``rglru_scan_fwd``, ``rglru_scratch_floats``) behind the same checks and
allocations as ``kernels/rglru.py::rglru_scan_fwd``. Every kernel is held
against ``ref.rglru_scan_oracle`` (1e-5 x max(1, max |ref|)) and its h is
compared bit for bit with this tree's; then all are timed in turns with
``chip_smoke.cuda_ms``, the yardstick of ``chip_smoke.py``: the earlier
sources in order, this tree twice, the earlier sources in reverse; and in
the same turns by CUDA events around 20 calls launched back to back, which
leaves out the host's lead-in. Two calls land on cards up to 15% apart;
turns in one process do not. Each one's CUDA
kernels and memsets are listed with their device time per call
(torch.profiler), and their sum is set against the bound and against
``torch.add(a, b, out=h)``, which moves the same bytes. Prints one JSON
object and the card's name and power limit; needs a GPU.
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


def build_earlier(source):
    """nvcc an earlier source into a library beside it; returns it loaded and
    its ptxas lines."""
    from chip_smoke import ptxas_usage
    from repro_torch.kernels import build
    lib_path = os.path.splitext(source)[0] + "-earlier.so"
    t0 = time.perf_counter()
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", lib_path, source],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed for {source}:\n{proc.stdout}{proc.stderr}")
    usage = ptxas_usage(proc.stdout + proc.stderr)
    print(f"{source} built in {time.perf_counter() - t0:.1f}s; {usage}", flush=True)
    lib = ctypes.CDLL(lib_path)
    lib.rglru_scan_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.rglru_scan_fwd.restype = ctypes.c_int
    lib.rglru_scratch_floats.argtypes = [ctypes.c_int] * 3
    lib.rglru_scratch_floats.restype = ctypes.c_longlong
    return lib, usage


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sources", nargs="+", help="earlier rglru.cu files")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("rglru_vs_parent: no GPU found")
    from chip_smoke import (BATCH, PROMPT, RG_ARCH, SEED, back_to_back_ms, cuda_ms,
                            device_us_by_kernel, rglru_bound_ms, rglru_inputs)
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru as krg

    earlier = {src: build_earlier(src) for src in args.sources}
    shape = (BATCH, PROMPT, get_config(RG_ARCH).d_rnn)
    # the serving shape in the sweep's distribution, from chip_smoke.py's seed
    a, b = rglru_inputs(torch, torch.Generator(device="cuda").manual_seed(SEED), shape)

    def caller(lib):
        def run():                         # kernels/rglru.py::rglru_scan_fwd's host work
            krg._check(a, b)
            h = torch.empty_like(a)
            scratch = torch.empty(lib.rglru_scratch_floats(*shape), device="cuda")
            err = lib.rglru_scan_fwd(a.data_ptr(), b.data_ptr(), h.data_ptr(),
                                     scratch.data_ptr(), *shape,
                                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"earlier rglru_scan_fwd failed: error {err}")
            return h
        return run

    runs = {src: caller(lib) for src, (lib, _) in earlier.items()}
    runs["this"] = lambda: krg.rglru_scan_fwd(a, b)
    want = ref.rglru_scan_oracle(a, b)
    scale = max(1.0, want.abs().max().item())
    h_this = runs["this"]()
    errs, bit_equal = {}, {}
    for who, fn in runs.items():
        h = fn()
        torch.cuda.synchronize()
        errs[who] = (h - want).abs().max().item()
        bit_equal[who] = torch.equal(h, h_this)
        if not errs[who] <= 1e-5 * scale:
            raise SystemExit(f"{who}: max abs err {errs[who]:.3g} > 1e-5 x {scale:.4g}")
    del want, h_this, h

    order = list(args.sources) + ["this", "this"] + list(reversed(args.sources))
    turns = [(who, cuda_ms(torch, runs[who], reps=REPS)) for who in order]
    b2b_turns = [(who, back_to_back_ms(torch, runs[who])) for who in order]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    ms = {who: [t for w, t in turns if w == who] for who in runs}
    device_us = {who: device_us_by_kernel(torch, fn) for who, fn in runs.items()}
    device_ms = {who: sum(us.values()) / 1e3 for who, us in device_us.items()}
    bound_ms, bound_by = rglru_bound_ms(a)
    # yardstick of bytes only: the same 12 bytes an element, another function
    out = torch.empty_like(a)
    copy = lambda: torch.add(a, b, out=out)  # noqa: E731
    copy_ms = cuda_ms(torch, copy, reps=REPS)
    copy_back_to_back_ms = back_to_back_ms(torch, copy)
    copy_device_ms = sum(device_us_by_kernel(torch, copy).values()) / 1e3
    result = {"shape": shape, "turns": turns, "ms": ms,
              "speedup_by_cuda_ms": {src: statistics.mean(ms[src]) / statistics.mean(ms["this"])
                                     for src in args.sources},
              "back_to_back_ms": {who: [t for w, t in b2b_turns if w == who] for who in runs},
              "device_ms": device_ms,
              "speedup_by_device_ms": {src: device_ms[src] / device_ms["this"]
                                       for src in args.sources if device_ms["this"]},
              "bound_ms": bound_ms, "bound_by": bound_by,
              "bound_share_by_device_ms": {who: bound_ms / t for who, t in device_ms.items()
                                           if t},
              "bound_share_by_cuda_ms": {who: bound_ms / statistics.mean(t)
                                         for who, t in ms.items()},
              "copy_ms": copy_ms, "copy_back_to_back_ms": copy_back_to_back_ms,
              "copy_device_ms": copy_device_ms,
              "max_abs_err": errs, "max_abs_ref": scale, "bit_equal_to_this": bit_equal,
              "ptxas": {src: usage for src, (_, usage) in earlier.items()},
              "reps": REPS, "card": card, "device_us_by_kernel": device_us}
    print(json.dumps(result))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
