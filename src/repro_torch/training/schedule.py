"""Learning-rate schedules for the training loops.

Counterpart of ``repro/training/schedule.py``. Each schedule maps a step
(a host int) to a Python float computed in float32 with numpy, the
arithmetic the JAX package does on the device, so
``training/optimizer.py:bias_corrected_lr`` folds it on the host and a
step reads nothing back from the card.
"""
from __future__ import annotations

import numpy as np

f32 = np.float32


def constant(lr: float):
    return lambda step: float(f32(lr))


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def fn(step):
        step = f32(step)
        warm = f32(peak_lr) * step / f32(max(warmup_steps, 1))
        progress = np.clip((step - f32(warmup_steps))
                           / f32(max(total_steps - warmup_steps, 1)), f32(0), f32(1))
        cos = f32(peak_lr) * (f32(final_frac) + f32((1 - final_frac) * 0.5)
                              * (f32(1) + np.cos(f32(np.pi) * progress)))
        return float(warm if step < warmup_steps else cos)

    return fn


def linear_warmup(peak_lr: float, warmup_steps: int):
    def fn(step):
        step = f32(step)
        return float(f32(peak_lr) * np.minimum(step / f32(max(warmup_steps, 1)), f32(1)))

    return fn
