"""Learning-rate schedules as ``schedule(step) -> float`` on the host.

Counterpart of ``ppt_tpu/train/schedules.py``. The reference evaluates
its schedule in f32 inside the jitted update; here the same expressions
run in numpy f32 on the host, once per step, and the value is handed to
the optimizer.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

_f = np.float32


def cosine_with_warmup(base_lr: float, final_lr: float, epochs: int, steps_per_epoch: int,
                       warmup_epochs: int = 0, warmup_start_lr: float = 0.0) -> Callable:
    """Linear warmup ``[warmup_start_lr, base_lr]`` over
    ``warmup_epochs * steps_per_epoch`` steps, then a cosine leg over the
    remaining steps ending at ``final_lr``; per iteration
    (``train/schedules.py:15-46``)."""
    warmup_steps = warmup_epochs * steps_per_epoch
    total_steps = epochs * steps_per_epoch
    decay_steps = max(total_steps - warmup_steps, 1)
    base, final, start = _f(base_lr), _f(final_lr), _f(warmup_start_lr)

    def schedule(step) -> float:
        step = _f(step)
        if step < warmup_steps:
            return float(start + (base - start) * (step / _f(max(warmup_steps, 1))))
        t = np.clip((step - _f(warmup_steps)) / _f(decay_steps), _f(0.0), _f(1.0))
        return float(final + _f(0.5) * (base - final) * (_f(1.0) + np.cos(_f(np.pi) * t)))

    return schedule


def constant_with_warmup(base_lr: float, warmup_steps: int = 0,
                         warmup_start_lr: float = 0.0) -> Callable:
    """``optax.linear_schedule(start, base, warm)`` joined to a constant
    (``train/optim.py:68-69``, ``:111-113``)."""
    base, start = _f(base_lr), _f(warmup_start_lr)

    def schedule(step) -> float:
        if step < warmup_steps:
            frac = _f(1.0) - _f(step) / _f(warmup_steps)
            return float((start - base) * frac + base)
        return float(base)

    return schedule
