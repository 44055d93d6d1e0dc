"""Batch loader: shuffling, fixed-shape numpy batches, a validity mask.

Counterpart of ``ppt_tpu/data/loader.py`` without JAX: datasets are
materialised arrays, so batching is slicing. With ``shuffle`` the order
of epoch ``e`` is ``np.random.RandomState(seed * 100003 + e).permutation``,
the reference's own (``data/loader.py:58-65``), so both packages see the
same batches. ``drop_last`` (training) keeps shapes fixed; otherwise the
final batch is padded to ``batch_size`` with its last item and ``valid``
marks the real rows. A dataset with part labels yields them per point,
with the object category and its one-hot.

Multi-process striding (``DistributedSampler``'s role, the reference's
``order[process::num_processes]``, ``data/loader.py:33-66``): process
``process_index`` of ``num_processes`` reads every ``num_processes``-th
item of the epoch's order, from its own offset, in batches of
``batch_size``. Both default to the process group's rank and world size,
or 0 and 1 without a group. The task drivers read the global batch on
every rank instead (``num_processes=1``) and take their rows with
``parallel.shard_batch``, so that every draw of a step is one process's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch.distributed as dist

from ppt_torch.data.datasets import ArrayDataset


@dataclasses.dataclass
class Loader:
    dataset: ArrayDataset
    batch_size: int
    shuffle: bool = False
    drop_last: bool = False
    seed: int = 0
    num_processes: Optional[int] = None
    process_index: Optional[int] = None

    def __post_init__(self):
        self._epoch = 0
        grouped = dist.is_available() and dist.is_initialized()
        self._n_proc = self.num_processes if self.num_processes is not None else (
            dist.get_world_size() if grouped else 1)
        self._proc = self.process_index if self.process_index is not None else (
            dist.get_rank() if grouped else 0)

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle seed per epoch (DistributedSampler.set_epoch parity)."""
        self._epoch = epoch

    def __len__(self) -> int:
        n = len(self.indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def indices(self) -> np.ndarray:
        """This process's items of the epoch, in order."""
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.RandomState(self.seed * 100003 + self._epoch).permutation(n)
        else:
            order = np.arange(n)
        return order if self._n_proc == 1 else order[self._proc::self._n_proc]

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
            yield dict(self._batch(idx), valid=valid)

    def _batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        """``pc`` and ``label``; a dataset with part labels gives its object
        ``category``, the per-point ``label`` [B, N] and ``cls_onehot``
        [B, num_classes] instead (``data/loader.py:85-95``)."""
        ds = self.dataset
        if ds.seg_labels is None:
            return {"pc": ds.points[idx], "label": ds.labels[idx]}
        return {"pc": ds.points[idx], "label": ds.seg_labels[idx], "category": ds.labels[idx],
                "cls_onehot": np.eye(ds.num_classes, dtype=np.float32)[ds.labels[idx]]}
