"""Datasets for the recognition path: ModelNet loader, synthetic fallback.

Counterpart of ``ppt_tpu/data/datasets.py``, cut to what the recognition
and few-shot tasks need (train and test splits, ``*_fs`` few-shot
resampling of the train split). Loaders produce plain numpy; batching is in
``ppt_torch.data.loader``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import pickle
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

log = logging.getLogger(__name__)


def pc_normalize(pc: np.ndarray) -> np.ndarray:
    """Unit-sphere normalise one cloud (``pc_normalize``, :33-40)."""
    centered = pc - pc.mean(axis=0)
    return centered / np.sqrt((centered**2).sum(axis=1)).max()


def fps_numpy(points: np.ndarray, npoint: int, seed: Optional[int] = None) -> np.ndarray:
    """Host-side FPS used by the ModelNet loader (``:41-61``)."""
    N = points.shape[0]
    xyz = points[:, :3]
    rng = np.random.RandomState(seed) if seed is not None else np.random
    out = np.zeros(npoint, dtype=np.int64)
    dist = np.full(N, 1e10)
    farthest = rng.randint(0, N)
    for i in range(npoint):
        out[i] = farthest
        d = ((xyz - xyz[farthest]) ** 2).sum(axis=1)
        dist = np.minimum(dist, d)
        farthest = int(np.argmax(dist))
    return points[out]


@dataclasses.dataclass
class ArrayDataset:
    """A fully materialised dataset: fixed-shape numpy arrays + metadata."""

    points: np.ndarray  # [M, N, 3] float32 (normalised)
    labels: np.ndarray  # [M] int32
    classnames: List[str]
    name: str = ""

    def __len__(self) -> int:
        return len(self.labels)

    @property
    def num_classes(self) -> int:
        return len(self.classnames)


def generate_fewshot(dataset: ArrayDataset, nshots: int, seed: int = 0) -> ArrayDataset:
    """Sample ``nshots`` items per class, with replacement when a class is
    scarce (same generator and draws as the reference's, ``:214-236``)."""
    rng = np.random.RandomState(seed)
    idx: List[int] = []
    for c in range(dataset.num_classes):
        pool = np.flatnonzero(dataset.labels == c)
        if len(pool) == 0:
            continue
        idx.extend(rng.choice(pool, nshots, replace=len(pool) < nshots))
    idx = np.asarray(idx)
    return ArrayDataset(dataset.points[idx], dataset.labels[idx], dataset.classnames,
                        name=f"{dataset.name}_fs{nshots}")


def load_modelnet(root: str, split: str, npoints: int, num_category: int = 40,
                  source_npoints: int = 8192) -> ArrayDataset:
    """ModelNet from the pre-FPS'd pickle (``ModelNet``, :261-323), with
    the per-item numpy FPS of the reference."""
    with open(os.path.join(root, f"modelnet{num_category}_shape_names.txt")) as f:
        classnames = [line.strip() for line in f if line.strip()]
    path = os.path.join(root, f"modelnet{num_category}_{split}_{source_npoints}pts_fps.dat")
    with open(path, "rb") as f:
        list_of_points, list_of_labels = pickle.load(f)
    pts = np.zeros((len(list_of_labels), npoints, 3), dtype=np.float32)
    labels = np.zeros(len(list_of_labels), dtype=np.int32)
    for i, (p, lab) in enumerate(zip(list_of_points, list_of_labels)):
        p = np.asarray(p, dtype=np.float32)
        labels[i] = int(lab)
        if npoints < p.shape[0]:
            p = fps_numpy(p, npoints)
        pts[i] = pc_normalize(p[:, :3])
    return ArrayDataset(pts, labels, classnames, name=f"modelnet{num_category}")


def make_synthetic(num_classes: int = 40, samples_per_class: int = 8, npoints: int = 1024,
                   seed: int = 0, classnames: Optional[Sequence[str]] = None) -> ArrayDataset:
    """Structured random clouds: each class a distinct mixture of gaussian
    blobs (same generator and values as the reference's)."""
    rng = np.random.RandomState(seed)
    M = num_classes * samples_per_class
    pts = np.zeros((M, npoints, 3), dtype=np.float32)
    labels = np.zeros(M, dtype=np.int32)
    if classnames is None:
        classnames = [f"shape {i}" for i in range(num_classes)]
    for c in range(num_classes):
        class_rng = np.random.RandomState(1000 + c)
        n_blobs = 2 + c % 4
        centers = class_rng.randn(n_blobs, 3)
        for s in range(samples_per_class):
            i = c * samples_per_class + s
            blob = rng.randint(0, n_blobs, npoints)
            pts[i] = centers[blob] * 0.5 + rng.randn(npoints, 3) * 0.15
            pts[i] = pc_normalize(pts[i])
            labels[i] = c
    return ArrayDataset(pts, labels, list(classnames), name="synthetic")


def _synthetic(args, split: str) -> ArrayDataset:
    return make_synthetic(
        num_classes=getattr(args, "num_classes", 40),
        samples_per_class=getattr(args, "samples_per_class", 8),
        npoints=args.npoints,
        seed=0 if split == "train" else 1,
    )


def _modelnet40_fs(args, split: str) -> ArrayDataset:
    ds = load_modelnet(args.data_path, split, args.npoints, 40)
    if split == "train":
        ds = generate_fewshot(ds, args.nshots, seed=args.seed)
    return ds


DATASETS: Dict[str, Callable[..., ArrayDataset]] = {
    "modelnet40": lambda args, split: load_modelnet(args.data_path, split, args.npoints, 40),
    "modelnet40_fs": _modelnet40_fs,
    "synthetic": _synthetic,
}


def build_dataset(name: str, args, split: str) -> ArrayDataset:
    """Name -> dataset, falling back to synthetic data when the real files
    are missing (unless ``args.allow_synthetic_fallback`` is off)."""
    if name not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(DATASETS)}")
    try:
        return DATASETS[name](args, split)
    except (FileNotFoundError, ImportError, OSError) as e:
        if not getattr(args, "allow_synthetic_fallback", True):
            raise
        log.warning("dataset %s unavailable (%s); using synthetic fallback", name, e)
        return DATASETS["synthetic"](args, split)
