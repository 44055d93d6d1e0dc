"""Losses of the task scripts (counterpart of ``ppt_tpu/models/losses.py``;
the pretraining contrastive loss comes with the pretraining slice)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def smoothed_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           smoothing: float = 0.0) -> torch.Tensor:
    """Mean label-smoothed cross entropy in f32: the target is
    ``1 - s`` on the true class plus ``s / K`` uniform
    (``models/losses.py:23-35``), written out rather than handed to
    ``F.cross_entropy`` so that it follows the reference op by op."""
    num_classes = logits.shape[-1]
    logp = F.log_softmax(logits.float(), dim=-1)
    onehot = F.one_hot(labels.long(), num_classes).to(torch.float32)
    target = onehot * (1.0 - smoothing) + smoothing / num_classes
    return -(target * logp).sum(-1).mean()
