"""Learning-rate schedules as ``schedule(step) -> float`` on the host.

Counterpart of ``ppt_tpu/train/schedules.py``. The reference evaluates
its schedule in f32 inside the jitted update; here the same expressions
run in numpy f32 on the host, once per step, and the value is handed to
the optimizer.
"""

from __future__ import annotations

from typing import Callable, Sequence

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
    base, rise = _f(base_lr), _f(warmup_start_lr - base_lr)  # optax subtracts in f64

    def schedule(step) -> float:
        if step < warmup_steps:
            frac = _f(1.0) - _f(step) / _f(warmup_steps)
            return float(rise * frac + base)
        return float(base)

    return schedule


def join_warmup(schedule: Callable, base_lr: float, warmup_steps: int,
                warmup_start_lr: float) -> Callable:
    """``optax.join_schedules([linear_schedule(start, base, warm), schedule],
    [warm])``: the linear leg below ``warm``, then ``schedule(step - warm)``."""
    if not warmup_steps:
        return schedule
    warm = constant_with_warmup(base_lr, warmup_steps, warmup_start_lr)

    def joined(step) -> float:
        return warm(step) if step < warmup_steps else schedule(step - warmup_steps)

    return joined


def multistep(base_lr: float, boundaries: Sequence[int], gamma: float) -> Callable:
    """``optax.piecewise_constant_schedule(base, {b: gamma})``: the rate
    times ``gamma`` once for each boundary the step has reached."""
    bounds = sorted(set(int(b) for b in boundaries))
    base, g = _f(base_lr), _f(gamma)

    def schedule(step) -> float:
        v = base
        for b in bounds:
            if step >= b:
                v = g * v
        return float(v)

    return schedule


def step_decay(base_lr: float, transition_steps: int, gamma: float) -> Callable:
    """``optax.exponential_decay(base, transition_steps, gamma, staircase=True)``."""
    base, g = _f(base_lr), _f(gamma)

    def schedule(step) -> float:
        if step <= 0:
            return float(base)
        p = np.floor(_f(step) / _f(transition_steps))
        return float(base * np.power(g, p))

    return schedule


def poly(base_lr: float, final_lr: float, power: float, transition_steps: int) -> Callable:
    """``optax.polynomial_schedule(base, final, power, transition_steps)``."""
    if transition_steps <= 0:
        return lambda step: float(_f(base_lr))
    span = _f(base_lr - final_lr)
    p, final = _f(power), _f(final_lr)

    def schedule(step) -> float:
        count = min(max(int(step), 0), transition_steps)
        frac = _f(1.0) - _f(count) / _f(transition_steps)
        return float(span * frac ** p + final)

    return schedule


def tanh_decay(base_lr: float, final_lr: float, span: int, lower: float = -7.0,
               upper: float = 3.0) -> Callable:
    """timm's ``TanhLRScheduler`` curve as the reference writes it
    (``train/optim.py:85-96``): ``final + (base - final) / 2 * (1 - tanh(lb
    (1 - t) + ub t))`` with ``t = clip(step / span, 0, 1)``."""
    half = _f(0.5 * (base_lr - final_lr))
    final, lb, ub = _f(final_lr), _f(lower), _f(upper)

    def schedule(step) -> float:
        tr = np.clip(_f(step) / _f(span), _f(0.0), _f(1.0))
        return float(final + half * (_f(1.0) - np.tanh(lb * (_f(1.0) - tr) + ub * tr)))

    return schedule


def cosine_restarts(base_lr: float, final_lr: float, warmup_start_lr: float, warmup_steps: int,
                    cycle_steps: int, n_cycles: int) -> Callable:
    """``optax.sgdr_schedule`` of ``n_cycles`` equal cycles, each
    ``optax.warmup_cosine_decay_schedule(start, base, warmup_steps,
    cycle_steps, final)``; past the last boundary the last cycle goes on."""
    alpha = 0.0 if base_lr == 0.0 else final_lr / base_lr
    base, rise, a, keep = _f(base_lr), _f(warmup_start_lr - base_lr), _f(alpha), _f(1.0 - alpha)
    decay = float(cycle_steps - warmup_steps)
    if not decay > 0:
        raise ValueError(f"cosine_restarts: a cycle of {cycle_steps} steps leaves no decay "
                         f"after {warmup_steps} warmup steps")

    def cycle(step) -> float:
        if step < warmup_steps:
            frac = _f(1.0) - _f(min(max(step, 0), warmup_steps)) / _f(warmup_steps)
            return rise * frac + base
        count = min(_f(step - warmup_steps), _f(decay))
        cos = _f(0.5) * (_f(1.0) + np.cos(_f(np.pi) * count / _f(decay)))
        return base * (keep * cos + a)

    def schedule(step) -> float:
        k = min(max(int(step), 0) // cycle_steps, n_cycles - 1)
        return float(cycle(step - k * cycle_steps))

    return schedule
