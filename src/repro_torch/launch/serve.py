"""Serving entry point: batched prefill + decode with a KV cache.

  python -m repro_torch.launch.serve --arch gemma3-4b --batch 4 --steps 32
  python -m repro_torch.launch.serve --arch gemma3-4b --smoke --device cpu

Weights are random, drawn from ``--seed``; the prompt from ``--seed + 1``;
for an arch with cross-attention (llama-3.2-vision-90b, seamless-m4t-medium)
the stub frontend's memory, standard normals in bf16, from ``--seed + 2``.
"""
from __future__ import annotations

import argparse
import time

import torch


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models import Model
    from repro_torch.train.serve_step import (make_decode_step,
                                              make_prefill_step, sample_token)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = Model(cfg, device=device, seed=args.seed)
    cache_len = args.prompt_len + args.steps
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=device)
    memory = None
    if model.memory_len():
        mem_gen = torch.Generator(device=device).manual_seed(args.seed + 2)
        memory = torch.randn(args.batch, model.memory_len(), cfg.d_model,
                             generator=mem_gen, device=device).to(torch.bfloat16)

    prefill = make_prefill_step(model, cache_len)
    decode = make_decode_step(model)

    with torch.inference_mode():
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = prefill(prompt, memory)
        _sync(device)
        t_prefill = time.perf_counter() - t0
        print(f"[serve] prefill {args.batch}x{args.prompt_len} on {device}: "
              f"{t_prefill * 1e3:.1f}ms "
              f"({args.batch * args.prompt_len / t_prefill:.0f} tok/s)")

        tok = sample_token(logits, args.temperature, gen)
        out = [tok]
        t0 = time.perf_counter()
        for _ in range(args.steps - 1):
            logits, cache = decode(tok, cache)
            tok = sample_token(logits, args.temperature, gen)
            out.append(tok)
        _sync(device)
        t_dec = time.perf_counter() - t0
    toks = torch.cat(out, dim=1)
    print(f"[serve] decode {args.steps - 1} steps: {t_dec * 1e3:.1f}ms "
          f"({args.batch * (args.steps - 1) / max(t_dec, 1e-9):.0f} tok/s)")
    print(f"[serve] sample output ids: {toks[0, :16].tolist()}")
    return toks


if __name__ == "__main__":
    main()
