"""Recognition metrics (counterpart of ``ppt_tpu/utils/metrics.py``)."""

from __future__ import annotations

import numpy as np


def per_class_accuracy(preds: np.ndarray, labels: np.ndarray, num_classes: int) -> np.ndarray:
    """[num_classes] accuracy per class in percent; NaN for absent classes."""
    out = np.full(num_classes, np.nan)
    for c in range(num_classes):
        m = labels == c
        if m.any():
            out[c] = 100.0 * np.mean(preds[m] == labels[m])
    return out


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
