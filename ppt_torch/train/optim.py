"""Optimizer and schedule factories behind the reference's string names.

Counterpart of ``ppt_tpu/train/optim.py`` for what the PPT-Base recipe
uses: the ``cosine`` and ``constant`` schedules (with warmup) and
``adamw``. The rest of the reference's zoo is named and refused, not
silently replaced.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple

import torch

from ppt_torch.train.schedules import constant_with_warmup, cosine_with_warmup

_SCHEDULES_TO_PORT = ("multistep", "step", "poly", "tanh", "tanhlr", "cosine_restarts", "sgdr",
                      "plateau")
_OPTIMIZERS_TO_PORT = (
    "adam", "sgd", "nesterov", "momentum", "lamb", "lars", "adabelief", "adafactor", "radam",
    "nadam", "adamax", "adadelta", "adagrad", "novograd", "nvnovograd", "rmsprop", "rmsproptf",
    "rmsprop_tf", "madgrad", "sgdp", "adamp", "adahessian",
)


def build_schedule(name: str, base_lr: float, epochs: int, steps_per_epoch: int, *,
                   final_lr: float = 0.0, warmup_epochs: int = 0,
                   warmup_start_lr: float = 0.0) -> Callable:
    name = name.lower()
    if name in ("cosine", "coslr"):
        return cosine_with_warmup(base_lr, final_lr, epochs, steps_per_epoch,
                                  warmup_epochs=warmup_epochs, warmup_start_lr=warmup_start_lr)
    if name == "constant":
        return constant_with_warmup(base_lr, warmup_epochs * steps_per_epoch, warmup_start_lr)
    if name in _SCHEDULES_TO_PORT:
        raise NotImplementedError(f"schedule {name!r} is not ported yet; have: cosine constant")
    raise KeyError(f"unknown schedule {name!r}; supported: cosine constant "
                   f"(still to port: {' '.join(_SCHEDULES_TO_PORT)})")


class AdamW:
    """``optax.adamw`` on a fixed list of named tensors, updated in place.

    One step, with ``count`` the number of steps taken BEFORE it::

        mu = b1 mu + (1 - b1) g            nu = b2 nu + (1 - b2) g^2
        u  = (mu / (1 - b1^(count+1))) / (sqrt(nu / (1 - b2^(count+1))) + eps)
        p -= schedule(count) * (u + weight_decay * p)

    The decay is decoupled, scaled by the learning rate, and applies to
    every leaf it is given (prompt tokens included); the learning rate is
    read at ``count`` before it is incremented. Moments are f32.
    ``torch.optim.AdamW`` differs in each of these unless driven by hand.
    With ``grad_norm_clip > 0`` the gradients are first clipped by their
    global L2 norm (``optax.clip_by_global_norm``, ``train/optim.py:394-400``):
    scaled by ``clip / norm`` when the norm is not below ``clip``.
    """

    def __init__(self, params: Iterable[Tuple[str, torch.Tensor]], schedule: Callable,
                 weight_decay: float = 0.1, betas: Tuple[float, float] = (0.9, 0.98),
                 eps: float = 1e-8, grad_norm_clip: float = 0.0):
        self.params: Dict[str, torch.Tensor] = dict(params)
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.b1, self.b2 = betas
        self.eps = eps
        self.grad_norm_clip = grad_norm_clip
        self.count = 0
        self.mu = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in self.params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        lr = self.schedule(self.count)
        t = self.count + 1
        c1, c2 = 1.0 - self.b1 ** t, 1.0 - self.b2 ** t
        if self.grad_norm_clip > 0.0:
            grads = clip_by_global_norm(grads, self.grad_norm_clip)
        for name, p in self.params.items():
            g = grads[name].float()
            mu, nu = self.mu[name], self.nu[name]
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            update = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            p.sub_((update + self.weight_decay * p).to(p.dtype), alpha=lr)
        self.count = t

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": dict(self.mu), "nu": dict(self.nu)}

    def load_state_dict(self, state: Dict) -> None:
        for slot in ("mu", "nu"):
            have, got = getattr(self, slot), state[slot]
            if set(have) != set(got):
                raise ValueError(f"optimizer state {slot!r} has leaves {sorted(got)}, the "
                                 f"trainable partition has {sorted(have)}")
            for k, v in got.items():
                have[k].copy_(v)
        self.count = int(state["count"])


def clip_by_global_norm(grads: Dict[str, torch.Tensor], clip: float) -> Dict[str, torch.Tensor]:
    """``optax.clip_by_global_norm``: every gradient times ``clip / norm``
    when the f32 L2 norm over all of them is at least ``clip``, else as
    given. Decided on the card: no wait for the host."""
    gs = {k: g.float() for k, g in grads.items()}
    norm = torch.sqrt(sum((g * g).sum() for g in gs.values()))
    keep = norm < clip
    return {k: torch.where(keep, g, g / norm * clip) for k, g in gs.items()}


def build_optimizer(name: str, params: Iterable[Tuple[str, torch.Tensor]], schedule: Callable,
                    *, weight_decay: float = 0.1, betas: Tuple[float, float] = (0.9, 0.98),
                    eps: float = 1e-8, grad_norm_clip: float = 0.0) -> AdamW:
    """The optimizer ``name`` over the named trainable tensors, after a
    global-norm clip of the gradients when ``grad_norm_clip > 0``."""
    name = name.lower()
    if name == "adamw":
        return AdamW(params, schedule, weight_decay=weight_decay, betas=tuple(betas), eps=eps,
                     grad_norm_clip=grad_norm_clip)
    if name in _OPTIMIZERS_TO_PORT:
        raise NotImplementedError(f"optimizer {name!r} is not ported yet; have: adamw")
    raise KeyError(f"unknown optimizer {name!r}; supported: adamw "
                   f"(still to port: {' '.join(_OPTIMIZERS_TO_PORT)})")
