"""Batch loader: shuffling, fixed-shape numpy batches, a validity mask.

Counterpart of ``ppt_tpu/data/loader.py`` without JAX: datasets are
materialised arrays, so batching is slicing. With ``shuffle`` the order
of epoch ``e`` is ``np.random.RandomState(seed * 100003 + e).permutation``,
the reference's own (``data/loader.py:58-65``), so both packages see the
same batches. ``drop_last`` (training) keeps shapes fixed; otherwise the
final batch is padded to ``batch_size`` with its last item and ``valid``
marks the real rows. Multi-process striding comes with the parallelism
slice.
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
    shuffle: bool = False
    drop_last: bool = False
    seed: int = 0

    def __post_init__(self):
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle seed per epoch (DistributedSampler.set_epoch parity)."""
        self._epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            return np.random.RandomState(self.seed * 100003 + self._epoch).permutation(n)
        return np.arange(n)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order, bs = self.indices(), self.batch_size
        n = len(order)
        stop = n - n % bs if self.drop_last else n
        for start in range(0, stop, bs):
            idx = order[start:start + bs]
            valid = np.ones(bs, dtype=bool)
            if len(idx) < bs:
                valid[len(idx):] = False
                idx = np.concatenate([idx, np.full(bs - len(idx), idx[-1])])
            yield {"pc": self.dataset.points[idx], "label": self.dataset.labels[idx],
                   "valid": valid}
