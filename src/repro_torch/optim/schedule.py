"""LR schedules as plain Python on the host's integer step (counterpart of
``repro/optim/schedule.py``), including the paper's two policies:

- AlexNet: "scaling down by a factor of 10 every 20 epochs" -> step_decay
- GoogLeNet: eta = eta0 * (1 - iter/max_iter)^0.5           -> poly_decay

The JAX versions compute in fp32 on a traced step; these return Python
floats, which the kernels round to fp32 when they read lr.
"""
from __future__ import annotations

import math


def constant(lr: float):
    return lambda step: float(lr)


def step_decay(lr0: float, steps_per_drop: int, factor: float = 0.1):
    def f(step):
        return float(lr0) * factor ** math.floor(step / steps_per_drop)
    return f


def poly_decay(lr0: float, max_steps: int, power: float = 0.5):
    def f(step):
        frac = min(max(step / max_steps, 0.0), 1.0)
        return float(lr0) * (1.0 - frac) ** power
    return f


def warmup_cosine(lr0: float, warmup: int, max_steps: int,
                  min_frac: float = 0.1):
    def f(step):
        wu = min(step / max(warmup, 1), 1.0)
        prog = min(max((step - warmup) / max(max_steps - warmup, 1), 0.0),
                   1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + math.cos(math.pi * prog))
        return float(lr0) * wu * cos
    return f
