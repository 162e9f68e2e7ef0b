"""LM training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Counterpart of ``repro/launch/train.py``: the architecture's reduced
config unless ``--full`` (which also recomputes each layer in the
backward, ``remat="layer"``), ``adamw(warmup_cosine(lr, 10, steps),
fused=True)`` (one ``fused_adam`` launch a step on the card, its plain
version on the CPU), a fresh dummy batch every step, and one line a step
with its loss and synchronised ms. Runs on CUDA unless ``--device cpu``.
``--ckpt-dir`` resumes from the latest checkpoint there and saves
``(params, opt_state)`` every ``--ckpt-every`` steps, in the JAX
package's format; a resumed run draws the batches an uninterrupted run
draws. Every step's time goes to a one-rank ``HeartbeatMonitor``, as the
JAX launcher feeds it.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, list_archs
from repro_torch.models.model_zoo import build_model, make_dummy_batch, make_train_step
from repro_torch.runtime.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.runtime.failure import HeartbeatMonitor
from repro_torch.training.optimizer import adamw
from repro_torch.training.schedule import warmup_cosine


def main(argv: Optional[Sequence[str]] = None) -> list:
    """Train and return the per-step losses (Python floats)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full", action="store_true",
                    help="the published config (on the card)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    model = build_model(cfg, remat="layer" if args.full else "none")
    opt = adamw(warmup_cosine(args.lr, 10, args.steps), fused=True)
    step = make_train_step(model, opt, microbatches=args.microbatches)

    params = model.init(torch.Generator(device=device).manual_seed(0), device=device)
    opt_state = opt.init(params)
    start = 0
    if args.ckpt_dir:
        (params, opt_state), restored = restore_checkpoint(
            args.ckpt_dir, (params, opt_state))
        if restored:
            start = restored
            print(f"[train] resumed from step {restored}")
    gen = torch.Generator(device=device).manual_seed(1)
    for _ in range(start):  # the batches the steps before the resume drew
        make_dummy_batch(cfg, args.batch, args.seq, generator=gen)
    monitor = HeartbeatMonitor(n_ranks=1)
    losses = []
    for i in range(start, args.steps):
        batch = make_dummy_batch(cfg, args.batch, args.seq, generator=gen)
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))  # waits for the step
        dt = time.perf_counter() - t0
        monitor.heartbeat(0, step_time=dt)
        print(f"[train] step {i + 1}/{args.steps} loss={losses[-1]:.4f} "
              f"({dt * 1e3:.0f} ms)")
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, i + 1, (params, opt_state))
    print("[train] done")
    return losses


if __name__ == "__main__":
    main()
