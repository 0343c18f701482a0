#!/usr/bin/env python3
"""Time this tree's K2 backward (``csrc/ssd_bwd.cu``) against earlier sources
of it, in one process on one card, at the mamba2-780m training shape of
``chip_smoke.py`` (b 2, s 2048, h 48, p 64, n 128, chunk 256, no dS_final).

  mkdir -p build/parent
  git show HEAD:src/repro_torch/kernels/csrc/ssd_bwd.cu > build/parent/ssd_bwd.cu
  python3 scripts/ssd_bwd_vs_parent.py build/parent/ssd_bwd.cu [more.cu ...] [--no-check]

Each earlier source is built with the port's nvcc flags next to itself (all
at once; a header it includes is found beside it first, then in ``csrc/``)
and called through its own C interface behind the checks and allocations of
``kernels/ssd.py::ssd_bwd``: the first design's (23 pointers: the heads'
shares of dB and dC as scratch, FIRST_DESIGN_SCRATCH below) or this tree's
(its pointer count, scratch from ``kssd.bwd_scratch_shapes``). Every version
is held against ``ref.ssd_bwd_oracle`` at ``chip_smoke.SSD_BWD_RTOL`` x
max(1, max |ref|) per gradient (``--no-check`` holds this tree's only: for
diagnostic variants that change the result) and compared bit for bit with
this tree's. Then all are timed in turns with ``chip_smoke.cuda_ms``, the
yardstick of ``chip_smoke.py`` (one call between CUDA events, the wrapper's
host work included): the earlier sources in order, this tree twice, the
earlier sources in reverse; and in the same turns by CUDA events around 20
calls back to back, which leaves out the host's lead-in. Two calls land on
cards up to 15% apart; turns in one process do not. Beside them: each
version's kernels by device time (torch.profiler), the host time a call
takes to enqueue, the bytes a call adds to the peak of device memory, its
ptxas registers and spills at the served widths, and both bounds of
``chip_smoke.ssd_bwd_bound_ms`` (the least work, and the first design's
count of P B and P^T C per head). Prints one JSON object and the card's name
and power limit; needs a GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
REPS = 20                                  # CUDA-event times a median is taken over


def first_design_scratch(b, s, h, p, n, chunk):
    """The first design's scratch, in the order its C function takes it: each
    chunk's dS_out, each head's share of dB and dC, per-row partial sums and
    per-chunk shares of dA."""
    Q = min(chunk, s)
    nc = -(-s // Q)
    return {"dstates": (b, h, nc, n, p), "dBh": (b, h, s, n), "dCh": (b, h, s, n),
            "rowp": (b, h, nc, Q), "colp": (b, h, nc, Q), "dw": (b, h, nc, Q),
            "u": (b, h, nc, Q), "dapart": (b, h, nc)}


FIRST_DESIGN_POINTERS = 23


def min_blocks(source):
    """The head-group rule's MIN_BLOCKS that a source states (None if it
    has none): a variant's scratch follows its own head groups."""
    found = re.search(r"constexpr int MIN_BLOCKS = (\d+);", open(source).read())
    return int(found.group(1)) if found else None


def pointer_args(source):
    """Pointers that the source's ssd_bwd takes before its six ints."""
    text = open(source).read()
    sig = text[text.index("int ssd_bwd("):]
    return sig[:sig.index(")")].count("void*") - 1      # the stream is not counted


def build_earlier(sources):
    """nvcc each earlier source into a library beside it, all at once;
    returns {source: (library, pointer count, ptxas lines)}."""
    from chip_smoke import ptxas_usage
    from repro_torch.kernels import build
    procs = {}
    for src in sources:
        lib_path = os.path.splitext(src)[0] + "-earlier.so"
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", os.path.dirname(os.path.abspath(src)),
               "-I", str(build.CSRC), "-o", lib_path, src]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), lib_path, time.perf_counter())
    out = {}
    for src, (proc, lib_path, t0) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {src}:\n{text}")
        print(f"{src} built in {time.perf_counter() - t0:.1f}s", flush=True)
        n_ptr = pointer_args(src)
        lib = ctypes.CDLL(lib_path)
        lib.ssd_bwd.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.ssd_bwd.restype = ctypes.c_int
        out[src] = (lib, n_ptr, ptxas_usage(text))
    return out


def served_usage(usage):
    """{kernel: ptxas line} of the instances the training shape runs (p 64,
    n 128) and of the kernels that take no template arguments."""
    out = {}
    for entry, line in usage.items():
        name = re.search(r"ssd_bwd_\w+?_kernel", entry)
        if name and ("ILi" not in entry or "ILi64ELi128E" in entry):
            out[name.group(0)] = line
    return out


def host_us(torch, fn, calls=50):
    """Host microseconds a call takes to enqueue, over `calls` calls without
    a synchronise between them (the card runs behind)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def peak_bytes(torch, fn):
    """Bytes one call adds to the peak of device memory (its outputs and
    scratch), above what was allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sources", nargs="+", help="earlier ssd_bwd.cu files")
    ap.add_argument("--no-check", action="store_true",
                    help="hold only this tree's to the oracle (for diagnostic variants "
                         "that change the result)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ssd_bwd_vs_parent: no GPU found")
    from chip_smoke import (SEED, SSD_BWD_RTOL, SSM_ARCH, TRAIN_BATCH, TRAIN_SEQ,
                            back_to_back_ms, cuda_ms, device_us_by_kernel, ptxas_usage,
                            ssd_bwd_bound_ms, ssd_inputs)
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import ssd as kssd
    torch.backends.cuda.matmul.allow_tf32 = False

    built = build.build_all(["ssd_bwd"])["ssd_bwd"]
    this_usage = served_usage(ptxas_usage(built["log"]))
    this_ptr = pointer_args(str(build.CSRC / "ssd_bwd.cu"))
    earlier = build_earlier(args.sources)
    cfg = get_config(SSM_ARCH)
    b, s, h, p, n, chunk = TRAIN_BATCH, TRAIN_SEQ, cfg.ssm_heads, cfg.ssm_head_dim, \
        cfg.ssm_state, cfg.ssm_chunk
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    x, dt, A, B, C = ssd_inputs(torch, g, b, s, h, p, n)
    dy = torch.randn(b, s, h, p, generator=g, device="cuda")
    _, _, *saved = kssd.ssd_fwd(x, dt, A, B, C, chunk=chunk, return_saved=True)

    def caller(lib, n_ptr, source):
        if n_ptr == FIRST_DESIGN_POINTERS:
            shapes = first_design_scratch(b, s, h, p, n, chunk)
        elif n_ptr == this_ptr:
            rule = kssd.BWD_MIN_BLOCKS
            kssd.BWD_MIN_BLOCKS = min_blocks(source) or rule
            shapes = kssd.bwd_scratch_shapes(b, s, h, p, n, chunk)
            kssd.BWD_MIN_BLOCKS = rule
        else:
            raise SystemExit(f"ssd_bwd takes {n_ptr} pointers: neither the first design's "
                             f"{FIRST_DESIGN_POINTERS} nor this tree's {this_ptr}")

        def run():                         # kernels/ssd.py::ssd_bwd's host work
            kssd._check(x, dt, A, B, C, chunk, "ssd_bwd", [("dy", dy)])
            grads = tuple(torch.empty_like(t) for t in (x, dt, A, B, C))
            scratch = [torch.empty(shape, device="cuda") for shape in shapes.values()]
            err = lib.ssd_bwd(*(t.data_ptr() for t in (x, dt, A, B, C, dy)), None,
                              *(t.data_ptr() for t in (*saved, *grads, *scratch)),
                              b, s, h, p, n, chunk, torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"earlier ssd_bwd failed: error {err}")
            return grads
        return run

    runs = {src: caller(lib, n_ptr, src) for src, (lib, n_ptr, _) in earlier.items()}
    runs["this"] = lambda: kssd.ssd_bwd(x, dt, A, B, C, dy, None, *saved, chunk=chunk)  # noqa: E731
    want = ref.ssd_bwd_oracle(x, dt, A, B, C, dy, None, chunk=chunk)
    got_this = runs["this"]()
    names = ("dx", "ddt", "dA", "dB", "dC")
    errs, bit_equal = {}, {}
    for who, fn in runs.items():
        got = fn()
        torch.cuda.synchronize()
        errs[who] = {k: (u - w).abs().max().item() / max(1.0, w.abs().max().item())
                     for k, u, w in zip(names, got, want)}
        bit_equal[who] = all(torch.equal(u, w) for u, w in zip(got, got_this))
        held = who == "this" or not args.no_check
        if held and not all(e <= SSD_BWD_RTOL for e in errs[who].values()):
            raise SystemExit(f"{who}: errors {errs[who]} x max(1, max |ref|) > {SSD_BWD_RTOL}")
    del want, got, got_this

    order = list(args.sources) + ["this", "this"] + list(reversed(args.sources))
    turns = [(who, cuda_ms(torch, runs[who], reps=REPS)) for who in order]
    b2b = [(who, back_to_back_ms(torch, runs[who])) for who in order]
    ms = {who: [t for w, t in turns if w == who] for who in runs}
    mean = {who: statistics.mean(t) for who, t in ms.items()}
    device_us = {who: device_us_by_kernel(torch, fn) for who, fn in runs.items()}
    device_ms = {who: sum(us.values()) / 1e3 for who, us in device_us.items()}
    bound_ms, bound_by, _ = ssd_bwd_bound_ms(x, B, chunk)
    first_bound_ms, _, _ = ssd_bwd_bound_ms(x, B, chunk, per_head_pb=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    n_layers = sum(kind == "ssd" for kind in cfg.layer_kinds)
    result = {
        "shape": {"b": b, "s": s, "h": h, "p": p, "n": n, "chunk": chunk},
        "turns": turns, "ms": ms,
        "back_to_back_ms": {who: [t for w, t in b2b if w == who] for who in runs},
        "speedup_by_cuda_ms": {src: mean[src] / mean["this"] for src in args.sources},
        "device_ms": device_ms,
        "speedup_by_device_time": {src: device_ms[src] / device_ms["this"]
                                   for src in args.sources if device_ms["this"]},
        "device_us_by_kernel": device_us,
        "bound_ms": bound_ms, "bound_by": bound_by, "first_design_bound_ms": first_bound_ms,
        "bound_share": {who: bound_ms / t for who, t in mean.items()},
        "first_design_bound_share": {who: first_bound_ms / t for who, t in mean.items()},
        "per_train_step_ms": {who: n_layers * t for who, t in mean.items()},
        "host_us": {who: host_us(torch, fn) for who, fn in runs.items()},
        "peak_bytes": {who: peak_bytes(torch, fn) for who, fn in runs.items()},
        "max_rel_err": errs, "bit_equal_to_this": bit_equal, "checked": not args.no_check,
        "ptxas": {"this": this_usage,
                  **{src: served_usage(u) for src, (_, _, u) in earlier.items()}},
        "reps": REPS, "card": card,
    }
    print(", ".join(f"{who} {mean[who]:.4f} ms (device {device_ms[who]:.4f})" for who in runs)
          + f"; bound {bound_ms:.4f}, first design's {first_bound_ms:.4f}", flush=True)
    print(json.dumps(result))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
