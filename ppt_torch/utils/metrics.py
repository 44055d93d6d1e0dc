"""Recognition and part-segmentation metrics (counterpart of
``ppt_tpu/utils/metrics.py``)."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                  topk: Sequence[int] = (1,)) -> Tuple[torch.Tensor, ...]:
    """Top-k accuracies in percent, one 0-d f32 tensor per ``k``
    (``utils/utils.py:376-398``): a sample counts for ``k`` when its label
    is among its ``k`` largest logits."""
    pred = torch.topk(logits, max(topk), dim=-1).indices  # [B, maxk]
    correct = pred == labels[:, None]
    return tuple(100.0 * correct[:, :k].any(dim=1).float().mean() for k in topk)


def per_class_accuracy(preds: np.ndarray, labels: np.ndarray, num_classes: int) -> np.ndarray:
    """[num_classes] accuracy per class in percent; NaN for absent classes."""
    out = np.full(num_classes, np.nan)
    for c in range(num_classes):
        m = labels == c
        if m.any():
            out[c] = 100.0 * np.mean(preds[m] == labels[m])
    return out


def refine_partseg_logits(logits: torch.Tensor, category: torch.Tensor,
                          part_ranges: torch.Tensor) -> torch.Tensor:
    """[B, N] part predictions, each sample's argmax taken over its object
    category's part range only (``main_partseg.py:219-225``): ``logits``
    [B, N, P], ``category`` [B], ``part_ranges`` [K, 2] (start, end)."""
    part_ids = torch.arange(logits.shape[-1], device=logits.device)
    lo = part_ranges[category, 0][:, None]  # [B, 1]
    hi = part_ranges[category, 1][:, None]
    valid = (part_ids[None, :] >= lo) & (part_ids[None, :] < hi)  # [B, P]
    masked = torch.where(valid[:, None, :], logits, torch.full_like(logits, float("-inf")))
    return masked.argmax(-1)


def partseg_ious(preds: torch.Tensor, labels: torch.Tensor, category: torch.Tensor,
                 part_ranges: torch.Tensor, num_categories: int) -> Dict[str, torch.Tensor]:
    """Accuracy, instance and category mIoU in percent, as masked
    reductions (``main_partseg.py:317-344``): per sample and part of its
    category, IoU = intersection / union, 1 when the part is neither
    predicted nor labelled; a sample's IoU is the mean over its category's
    parts; instance mIoU averages samples, category mIoU the categories'
    means, a category without samples NaN (``category_ious``) and left out."""
    P = int(part_ranges[:, 1].max())
    part_ids = torch.arange(P, device=preds.device)
    lo = part_ranges[category, 0][:, None]
    hi = part_ranges[category, 1][:, None]
    in_range = (part_ids[None, :] >= lo) & (part_ids[None, :] < hi)  # [B, P]
    pred_oh = preds[:, :, None] == part_ids[None, None, :]  # [B, N, P]
    gt_oh = labels[:, :, None] == part_ids[None, None, :]
    inter = (pred_oh & gt_oh).sum(1, dtype=torch.int32)  # [B, P]
    union = (pred_oh | gt_oh).sum(1, dtype=torch.int32)
    iou = torch.where(union > 0, inter / torch.clamp_min(union, 1), 1.0)
    n_parts = in_range.sum(1, dtype=torch.int32)
    sample_iou = torch.where(in_range, iou, 0.0).sum(1) / n_parts  # [B]
    cat_oh = torch.nn.functional.one_hot(category.long(), num_categories).float()  # [B, K]
    cat_counts = cat_oh.sum(0)
    cat_means = torch.where(cat_counts > 0, (cat_oh.t() @ sample_iou)
                            / torch.clamp_min(cat_counts, 1), float("nan"))
    return {
        "accuracy": 100.0 * (preds == labels).float().mean(),
        "instance_miou": 100.0 * sample_iou.mean(),
        "category_miou": 100.0 * torch.nanmean(cat_means),
        "category_ious": 100.0 * cat_means,
    }


class Meter:
    """Host-side running average (the reference's ``AverageMeter``)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.reset()

    def reset(self) -> None:
        self.sum = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1) -> None:
        self.sum += float(value) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)

    def __repr__(self) -> str:
        return f"{self.name}: {self.avg:.4f} (n={self.count})"
