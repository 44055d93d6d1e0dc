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
