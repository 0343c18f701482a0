"""Training entry point: checkpointed, preemptible, fault-tolerant.

  python -m repro_torch.launch.train --arch gemma3-4b --steps 20
  python -m repro_torch.launch.train --arch gemma3-4b --smoke --device cpu

Counterpart of ``repro/launch/train.py``, with the same flags plus
``--device`` (``cuda`` unless the caller asks for ``cpu``). It composes
atomic checkpoints with keep-last-k, resume from the latest with exact data
replay, SIGTERM preemption save, per-step straggler detection and retry of
transient failures. Weights are random, drawn from seed 0. Remat is
``none`` with ``--smoke`` and ``full`` otherwise, as in the JAX entry point.
"""
from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--inject-fault-at", type=int, default=-1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs.base import ParallelConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models import Model
    from repro_torch.train.checkpoint import (latest_step, restore_checkpoint,
                                              save_checkpoint)
    from repro_torch.train.data import DataConfig, DataIterator
    from repro_torch.train.fault import (FaultInjector, PreemptionHandler,
                                         StepTimer, StragglerMonitor,
                                         run_with_retry)
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import init_train_state, make_train_step

    par = ParallelConfig(remat="none" if args.smoke else "full",
                         microbatches=args.microbatches,
                         grad_compression=args.grad_compression)
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = Model(cfg, device=device, seed=0, trainable=True)
    opt = OptConfig(lr=args.lr, warmup_steps=max(10, args.steps // 20),
                    total_steps=args.steps)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                    global_batch=args.batch, memory_len=model.memory_len(),
                    d_model=cfg.d_model)

    step_fn = make_train_step(model, opt, par)
    state = init_train_state(model)
    start_step = 0

    ckpt_dir = args.ckpt_dir or os.path.join("checkpoints", cfg.name)
    if args.resume:
        last = latest_step(ckpt_dir)
        if last is not None:
            state, meta = restore_checkpoint(ckpt_dir, last, state)
            start_step = meta["step"]
            print(f"[train] resumed from step {start_step}")

    it = DataIterator(dc, start_step=start_step, device=device)
    monitor = StragglerMonitor()
    injector = FaultInjector(
        fail_steps=(args.inject_fault_at,) if args.inject_fault_at >= 0 else ())

    metrics_log = []
    with PreemptionHandler() as preempt:
        for step in range(start_step, args.steps):
            batch = next(it)

            def run(state=state, batch=batch, step=step):
                injector.check(step)
                return step_fn(state, batch)

            with StepTimer() as t:
                state, metrics = run_with_retry(
                    run, retries=2,
                    on_failure=lambda e, a: print(f"[train] step {step} failed "
                                                  f"({e}); retry {a + 1}"))
                loss = float(metrics["loss"])          # waits for the step
            if monitor.record(step, t.duration):
                print(f"[train] straggler step {step}: {t.duration:.3f}s "
                      f"(median {monitor.median:.3f}s)")

            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"[train] step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['gnorm']):.3f} "
                      f"lr {float(metrics['lr']):.2e} {t.duration * 1e3:.0f}ms")
                metrics_log.append({"step": step, "loss": loss,
                                    "t_ms": t.duration * 1e3})

            if (step + 1) % args.ckpt_every == 0 or preempt.should_stop:
                save_checkpoint(ckpt_dir, step + 1, state, keep=args.keep)
                if preempt.should_stop:
                    print(f"[train] preempted; checkpointed at {step + 1}")
                    break

    os.makedirs(ckpt_dir, exist_ok=True)
    with open(os.path.join(ckpt_dir, "metrics.json"), "w") as f:
        json.dump(metrics_log, f, indent=1)
    print(f"[train] done on {device}; final loss "
          f"{metrics_log[-1]['loss'] if metrics_log else float('nan'):.4f}")
    return metrics_log


if __name__ == "__main__":
    main()
