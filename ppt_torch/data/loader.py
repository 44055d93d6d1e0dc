"""Batch loader: fixed-shape numpy batches with a validity mask.

Counterpart of ``ppt_tpu/data/loader.py`` for evaluation, without JAX:
datasets are materialised arrays, so batching is slicing, in order. The
final batch is padded to ``batch_size`` with its last item and ``valid``
marks the real rows. Shuffling and multi-process striding come with the
training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from ppt_torch.data.datasets import ArrayDataset


@dataclasses.dataclass
class Loader:
    dataset: ArrayDataset
    batch_size: int

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n, bs = len(self.dataset), self.batch_size
        for start in range(0, n, bs):
            idx = np.arange(start, min(start + bs, n))
            valid = np.ones(bs, dtype=bool)
            if len(idx) < bs:
                valid[len(idx):] = False
                idx = np.concatenate([idx, np.full(bs - len(idx), idx[-1])])
            yield {"pc": self.dataset.points[idx], "label": self.dataset.labels[idx],
                   "valid": valid}
