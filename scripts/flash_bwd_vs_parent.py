#!/usr/bin/env python3
"""Time this tree's K1 backward (``csrc/flash_attention_bwd.cu``) against
earlier sources of it, in one process on one card, at the three training
shapes of ``chip_smoke.py`` phase 3 (bf16, B 2 x S 2048, hd 256: gemma3-4b
global and window 1024, recurrentgemma-9b's local layer).

  mkdir -p build/parent
  git show HEAD:src/repro_torch/kernels/csrc/flash_attention_bwd.cu \\
      > build/parent/flash_attention_bwd.cu
  # where the earlier source includes csrc/hopper.cuh, its own copy beside it:
  git show HEAD:src/repro_torch/kernels/csrc/hopper.cuh > build/parent/hopper.cuh
  python3 scripts/flash_bwd_vs_parent.py build/parent/flash_attention_bwd.cu [more.cu ...]

Each earlier source is built with the port's nvcc flags next to itself (a
header it includes is found beside it first, then in ``csrc/``) and called
through the C interface every version shares (``flash_attention_bwd``)
behind the same checks and allocations as
``kernels/flash_attention.py::flash_attention_bwd``, with this tree's
scratch size (a version that takes D alone reads its first BH x Sq floats).
At each shape every version is held against ``ref.flash_attention_bwd_oracle``
at ``chip_smoke.BWD_RTOL`` and its dq, dk, dv compared bit for bit with this
tree's; then all are timed in turns with ``chip_smoke.cuda_ms``, the
yardstick of ``chip_smoke.py`` (one call between CUDA events, the wrapper's
host work included): the earlier sources in order, this tree twice, the
earlier sources in reverse; and in the same turns by CUDA events around 20
calls back to back, which leaves out the host's lead-in. Two calls land on
cards up to 15% apart; turns in one process do not. cuDNN's SDPA backward
(the yardstick ``chip_smoke.py`` times) and each version's kernels by
device time (torch.profiler) and the host time a call takes to enqueue are
listed beside them, with every version's ptxas registers and spills and the
highest register this tree's kernels use (cuobjdump). Prints one JSON object and the card's name and
power limit; needs a GPU.
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


def build_earlier(source):
    """nvcc an earlier source into a library beside it; returns it loaded and
    its ptxas lines."""
    from chip_smoke import ptxas_usage
    from repro_torch.kernels import build
    lib_path = os.path.splitext(source)[0] + "-earlier.so"
    t0 = time.perf_counter()
    cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", os.path.dirname(os.path.abspath(source)),
           "-I", str(build.CSRC), "-o", lib_path, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed for {source}:\n{proc.stdout}{proc.stderr}")
    usage = ptxas_usage(proc.stdout + proc.stderr)
    print(f"{source} built in {time.perf_counter() - t0:.1f}s", flush=True)
    lib = ctypes.CDLL(lib_path)
    lib.flash_attention_bwd.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                                        + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_bwd.restype = ctypes.c_int
    return lib, usage


def bf16_usage(usage):
    """{kernel: ptxas line} of a library's bf16 hd-256 instances and its
    reduction kernel (what the training shapes run)."""
    out = {}
    for entry, line in usage.items():
        name = re.search(r"flash_bwd_([a-z0-9_]+?_kernel)", entry)
        bf16_hd256 = "Li256E" in entry and ("bf16_kernel" in entry or "bfloat16Li256E" in entry)
        if name and (bf16_hd256 or "reduce" in entry):
            out[name.group(1)] = line
    return out


def host_us(fn, calls=100):
    """Host microseconds a call takes to enqueue, over `calls` calls without
    a synchronise between them (the card runs behind)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def max_register(library):
    """{kernel: highest register index in its SASS} of a library's bf16
    hd-256 backward kernels (cuobjdump): ptxas reports the launch bound (168
    at 384 threads); an index above it shows the setmaxnreg budget taken."""
    from repro_torch.kernels import build
    cuobjdump = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    proc = subprocess.run([cuobjdump, "-sass", str(library)], capture_output=True, text=True)
    out, func = {}, None
    for ln in proc.stdout.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = re.search(r"flash_bwd_([a-z0-9_]+?_kernel)", m.group(1))
            func = name.group(1) if name and "Li256E" in m.group(1) and "bf16" in m.group(1) else None
        elif func:
            for r in re.findall(r"\bR(\d+)\b", ln):
                out[func] = max(out.get(func, 0), int(r))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sources", nargs="+", help="earlier flash_attention_bwd.cu files")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_vs_parent: no GPU found")
    import torch.nn.functional as F
    from chip_smoke import (ARCH, BWD_RTOL, RG_ARCH, SEED, TRAIN_BATCH, TRAIN_SEQ,
                            attention_bwd_bound_ms, back_to_back_ms, cuda_ms,
                            device_us_by_kernel, ptxas_usage, sdpa_backend)
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    built = build.build_all(["flash_attention_bwd"])["flash_attention_bwd"]
    this_usage = ptxas_usage(built["log"])
    earlier = {src: build_earlier(src) for src in args.sources}
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    cfg, rg = get_config(ARCH), get_config(RG_ARCH)
    shapes = (("gemma3-4b global", cfg, 0), ("gemma3-4b local", cfg, cfg.local_window),
              (f"{RG_ARCH} local", rg, rg.local_window))
    order = list(args.sources) + ["this", "this"] + list(reversed(args.sources))
    out = {}
    for label, c, window in shapes:
        G, BKV, S, hd = c.num_heads // c.num_kv_heads, TRAIN_BATCH * c.num_kv_heads, TRAIN_SEQ, c.head_dim
        mk = lambda n: torch.randn(n, S, hd, generator=g, device="cuda").to(torch.bfloat16)  # noqa: E731
        q, k, v, do = mk(BKV * G), mk(BKV), mk(BKV), mk(BKV * G)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=True, window=window, return_lse=True)
        BH = BKV * G

        def caller(lib):
            def run():                     # kernels/flash_attention.py's host work
                fa._check(q, k, v, True, window, "flash_attention_bwd")
                dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
                scratch = torch.empty(fa.bwd_scratch_floats(BH, BKV, S, S, hd, q.dtype),
                                      dtype=torch.float32, device="cuda")
                err = lib.flash_attention_bwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                    do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                    scratch.data_ptr(), BH, BKV, S, S, hd, 1, 1, window, 1.0 / hd ** 0.5,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise SystemExit(f"earlier flash_attention_bwd failed: error {err}")
                return dq, dk, dv
            return run

        runs = {src: caller(lib) for src, (lib, _) in earlier.items()}
        runs["this"] = lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True,  # noqa: E731
                                                      window=window)
        qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
        of, lsef = ref.flash_attention_oracle(qf, kf, vf, causal=True, window=window,
                                              return_lse=True)
        want = ref.flash_attention_bwd_oracle(qf, kf, vf, of, lsef, dof, causal=True,
                                              window=window)
        del qf, kf, vf, dof, of, lsef
        got_this = runs["this"]()
        errs, bit_equal = {}, {}
        for who, fn in runs.items():
            got = fn()
            torch.cuda.synchronize()
            errs[who] = [(x.float() - y).abs().max().item() / max(1.0, y.abs().max().item())
                         for x, y in zip(got, want)]
            bit_equal[who] = all(torch.equal(x, y) for x, y in zip(got, got_this))
            if not all(e <= BWD_RTOL["bfloat16"] for e in errs[who]):
                raise SystemExit(f"{label} {who}: dq, dk, dv errors {errs[who]} x max(1, max "
                                 f"|ref|) > {BWD_RTOL['bfloat16']}")
        del want, got, got_this
        turns = [(who, cuda_ms(torch, runs[who], reps=REPS)) for who in order]
        b2b = [(who, back_to_back_ms(torch, runs[who])) for who in order]
        ms = {who: [t for w, t in turns if w == who] for who in runs}
        # yardstick only: the backward of one PyTorch SDPA call on the same inputs
        q4, k4, v4 = (x.view(TRAIN_BATCH, -1, S, hd).detach().requires_grad_() for x in (q, k, v))
        mask = None
        if 0 < window < S:
            pos = torch.arange(S, device="cuda")
            d = pos[:, None] - pos[None, :]
            mask = (d >= 0) & (d < window)
        out4 = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, is_causal=mask is None,
                                              enable_gqa=True)
        library_ms = cuda_ms(torch, lambda: torch.autograd.grad(
            out4, (q4, k4, v4), do.view(q4.shape), retain_graph=True), reps=REPS)
        backend = sdpa_backend(torch, q4, k4, v4, mask, mask is None)
        del out4, q4, k4, v4
        bound_ms, bound_by = attention_bwd_bound_ms(q, k, True, window)
        mean = {who: statistics.mean(t) for who, t in ms.items()}
        out[label] = {
            "window": window, "heads": c.num_heads, "kv_heads": c.num_kv_heads,
            "head_splits": fa.bwd_head_splits(BKV, G, S),
            "turns": turns, "ms": ms,
            "back_to_back_ms": {who: [t for w, t in b2b if w == who] for who in runs},
            "speedup_by_cuda_ms": {src: mean[src] / mean["this"] for src in args.sources},
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": {who: bound_ms / t for who, t in mean.items()},
            "library_ms": library_ms, "sdpa_backend": backend,
            "vs_library": {who: t / library_ms for who, t in mean.items()},
            "device_us_by_kernel": {who: device_us_by_kernel(torch, fn) for who, fn in runs.items()},
            "host_us": {who: host_us(fn) for who, fn in runs.items()},
            "max_rel_err": errs, "bit_equal_to_this": bit_equal,
        }
        print(f"{label}: " + ", ".join(f"{who} {statistics.mean(t):.4f} ms" for who, t in ms.items())
              + f"; cuDNN {library_ms:.4f} ms ({backend}); bound {bound_ms:.4f}", flush=True)
        del q, k, v, do, o, lse
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    n_local = sum(kind == "local" for kind in cfg.layer_kinds)
    n_global = sum(kind == "global" for kind in cfg.layer_kinds)
    per_step = {who: n_global * statistics.mean(out["gemma3-4b global"]["ms"][who])
                + n_local * statistics.mean(out["gemma3-4b local"]["ms"][who])
                for who in ["this", *args.sources]}
    result = {"shapes": out, "per_train_step_ms": per_step,
              "per_train_step_is": f"{n_global} global + {n_local} local launches",
              "ptxas": {"this": bf16_usage(this_usage),
                        **{src: bf16_usage(u) for src, (_, u) in earlier.items()}},
              "max_register_this": max_register(built["path"]),
              "reps": REPS, "card": card}
    print(json.dumps(result))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
