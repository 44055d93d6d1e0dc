"""Label-smoothed cross entropy, AdamW and the recipe's learning rate, plainly.

- Loss: the mean over the batch of ``-sum_k t_k log softmax(z)_k`` with the
  target ``t = (1 - s) onehot + s / K``.
- AdamW (Loshchilov and Hutter, as ``optax.adamw``): ``m = b1 m + (1 - b1)
  g``, ``v = b2 v + (1 - b2) g^2``, the update ``-lr (m / (1 - b1^t)) /
  (sqrt(v / (1 - b2^t)) + eps) - lr wd p``.
- Rate: linear from ``lr_start`` to ``lr`` over the warm-up epochs, then a
  cosine to ``lr_end``; the rate of step ``t`` (from 0) is read before
  the step.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def smoothed_ce(logits: torch.Tensor, labels: torch.Tensor, s: float) -> torch.Tensor:
    K = logits.shape[-1]
    target = torch.nn.functional.one_hot(labels, K).float() * (1.0 - s) + s / K
    return -(target * torch.log_softmax(logits, -1)).sum(-1).mean()


def learning_rate(step: int, t: Dict, steps_per_epoch: int) -> float:
    warm = t["warmup_epochs"] * steps_per_epoch
    if step < warm:
        return t["lr_start"] + (t["lr"] - t["lr_start"]) * step / warm
    total = t["epochs"] * steps_per_epoch
    frac = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return t["lr_end"] + 0.5 * (t["lr"] - t["lr_end"]) * (1.0 + math.cos(math.pi * frac))


class AdamW:
    def __init__(self, t: Dict):
        self.b1, self.b2 = t["betas"]
        self.eps, self.wd = t["eps"], t["wd"]
        self.m = self.v = None
        self.count = 0

    @torch.no_grad()
    def step(self, p: torch.Tensor, g: torch.Tensor, lr: float) -> torch.Tensor:
        """The new value of ``p`` after one step on the gradient ``g``."""
        if self.m is None:
            self.m, self.v = torch.zeros_like(p), torch.zeros_like(p)
        self.count += 1
        self.m = self.b1 * self.m + (1 - self.b1) * g
        self.v = self.b2 * self.v + (1 - self.b2) * g * g
        m_hat = self.m / (1 - self.b1 ** self.count)
        v_hat = self.v / (1 - self.b2 ** self.count)
        return p - lr * (m_hat / (torch.sqrt(v_hat) + self.eps) + self.wd * p)
