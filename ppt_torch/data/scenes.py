"""Scene-scale semantic-segmentation datasets: S3DIS, ScanNetV2,
SemanticKITTI, and the Matterport3D object set (MP40).

Counterpart of ``ppt_tpu/data/scenes.py:41-406``, numpy on
``np.random.RandomState`` as there, so every array equals the reference's
bit for bit for the same files and seed:

  - ``fnv_hash_vec`` / ``ravel_hash_vec`` / ``voxelize`` / ``crop_pc``:
    voxel hashing, one point per voxel, the crop to ``voxel_max`` points
    nearest a seed point;
  - S3DIS rooms as ``<root>/raw/Area_*.npy`` [N, 9] (xyz, rgb, label), the
    test area held out of train;
  - ScanNetV2 per-scene ``.pth`` tuples (coord, feat in [-1, 1], label),
    read with ``torch.load``, rgb rescaled by (f + 1) * 127.5;
  - SemanticKITTI velodyne ``.bin`` scans and packed ``.label`` files
    remapped to 19 classes with -1 ignored, sequences 00-07/09/10 train,
    08 val;
  - MP40 object ``.npy`` dicts {points, label} with generated 80/10/10
    split lists, FPS to ``npoints`` by the native host library
    (``ppt_torch.native.fps_batch``).

A loader gives a :class:`SceneDataset` (variable-size scenes);
:func:`materialize_crops` turns it into the fixed ``ArrayDataset`` the
training loop batches.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ppt_torch.data.datasets import ArrayDataset

# ---------------------------------------------------------------------------
# voxel hashing + crops (data_util.py ports)
# ---------------------------------------------------------------------------


def fnv_hash_vec(arr: np.ndarray) -> np.ndarray:
    """FNV64-1A over integer coordinate rows (``data_util.py:93-105``)."""
    assert arr.ndim == 2
    arr = arr.astype(np.uint64, copy=True)
    hashed = np.uint64(14695981039346656037) * np.ones(
        arr.shape[0], dtype=np.uint64
    )
    for j in range(arr.shape[1]):
        hashed *= np.uint64(1099511628211)
        hashed = np.bitwise_xor(hashed, arr[:, j])
    return hashed


def ravel_hash_vec(arr: np.ndarray) -> np.ndarray:
    """Fortran-ravel over min-shifted coords (``data_util.py:108-124``)."""
    assert arr.ndim == 2
    arr = arr.copy()
    arr -= arr.min(0)
    arr = arr.astype(np.uint64, copy=False)
    arr_max = arr.max(0).astype(np.uint64) + 1
    keys = np.zeros(arr.shape[0], dtype=np.uint64)
    for j in range(arr.shape[1] - 1):
        keys += arr[:, j]
        keys *= arr_max[j + 1]
    keys += arr[:, -1]
    return keys


def voxelize(
    coord: np.ndarray,
    voxel_size: float = 0.05,
    hash_type: str = "fnv",
    mode: int = 0,
    rng: Optional[np.random.RandomState] = None,
):
    """One index per occupied voxel (``data_util.py:127-143``).

    mode 0 (train): a random member of each voxel. mode 1 (val):
    returns (idx_sort, voxel_idx, count) for full-coverage evaluation.
    """
    discrete = np.floor(coord / np.array(voxel_size))
    key = fnv_hash_vec(discrete) if hash_type == "fnv" else ravel_hash_vec(discrete)
    idx_sort = np.argsort(key)
    key_sort = key[idx_sort]
    _, voxel_idx, count = np.unique(
        key_sort, return_counts=True, return_inverse=True
    )
    if mode == 0:
        rng = rng or np.random
        idx_select = (
            np.cumsum(np.insert(count, 0, 0)[0:-1])
            + rng.randint(0, count.max(), count.size) % count
        )
        return idx_sort[idx_select]
    return idx_sort, voxel_idx, count


def crop_pc(
    coord: np.ndarray,
    feat: Optional[np.ndarray],
    label: Optional[np.ndarray],
    split: str = "train",
    voxel_size: float = 0.04,
    voxel_max: Optional[int] = None,
    downsample: bool = True,
    variable: bool = True,
    shuffle: bool = True,
    rng: Optional[np.random.RandomState] = None,
):
    """Voxel downsample + crop to ``voxel_max`` around a seed point
    (``data_util.py:146-176``): random seed point at train, the middle
    point otherwise; short clouds pad by resampling when not variable."""
    rng = rng or np.random
    if voxel_size and downsample:
        coord = coord - coord.min(0)
        uniq_idx = voxelize(coord, voxel_size, rng=rng)
        coord = coord[uniq_idx]
        feat = feat[uniq_idx] if feat is not None else None
        label = label[uniq_idx] if label is not None else None
    if voxel_max is not None:
        crop_idx = None
        N = len(coord)
        if N >= voxel_max:
            init_idx = rng.randint(N) if "train" in split else N // 2
            crop_idx = np.argsort(
                np.sum(np.square(coord - coord[init_idx]), 1)
            )[:voxel_max]
        elif not variable:
            pad = rng.choice(N, voxel_max - N)
            crop_idx = np.hstack([np.arange(N), pad])
        if crop_idx is None:
            crop_idx = np.arange(coord.shape[0])
        if shuffle:
            crop_idx = crop_idx[rng.permutation(len(crop_idx))]
        coord = coord[crop_idx]
        feat = feat[crop_idx] if feat is not None else None
        label = label[crop_idx] if label is not None else None
    coord = coord - coord.min(0)
    return (
        coord.astype(np.float32),
        feat.astype(np.float32) if feat is not None else None,
        label.astype(np.int64) if label is not None else None,
    )


# ---------------------------------------------------------------------------
# scene container
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SceneDataset:
    """Variable-size scenes: per-scene (coord [Ni,3], feat [Ni,F] | None,
    label [Ni])."""

    scenes: List[Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]]
    classnames: List[str]
    name: str
    ignored_labels: Tuple[int, ...] = ()

    def __len__(self) -> int:
        return len(self.scenes)


def materialize_crops(
    ds: SceneDataset,
    voxel_max: int,
    split: str = "train",
    crops_per_scene: int = 1,
    voxel_size: float = 0.0,  # scenes are usually pre-voxelized
    seed: int = 0,
) -> ArrayDataset:
    """Fixed-size crops -> the framework's ArrayDataset (points carry
    xyz + features channels; labels per point in ``seg_labels``)."""
    rng = np.random.RandomState(seed)
    pts, labels, segs = [], [], []
    for coord, feat, label in ds.scenes:
        for _ in range(crops_per_scene):
            c, f, l = crop_pc(
                coord.copy(), None if feat is None else feat.copy(),
                label.copy(), split=split, voxel_size=voxel_size,
                voxel_max=voxel_max, downsample=bool(voxel_size),
                variable=False, rng=rng,
            )
            x = c if f is None else np.concatenate([c, f], axis=1)
            pts.append(x.astype(np.float32))
            labels.append(0)
            segs.append(l.astype(np.int32))
    return ArrayDataset(
        points=np.stack(pts),
        labels=np.asarray(labels, np.int32),
        classnames=ds.classnames,
        seg_labels=np.stack(segs),
        name=f"{ds.name}_crops{voxel_max}",
    )


# ---------------------------------------------------------------------------
# S3DIS
# ---------------------------------------------------------------------------

S3DIS_CLASSES = [
    "ceiling", "floor", "wall", "beam", "column", "window", "door",
    "chair", "table", "bookcase", "sofa", "board", "clutter",
]


def load_s3dis(
    root: str,
    split: str = "train",
    test_area: int = 5,
    voxel_size: float = 0.04,
    seed: int = 0,
) -> SceneDataset:
    """Rooms from ``<root>/raw/Area_*.npy`` [N, 9] = xyz, rgb, label
    (s3dis.py:58-118); the test area is held out of train."""
    raw = os.path.join(root, "raw")
    items = sorted(
        f[:-4] for f in os.listdir(raw) if "Area_" in f and f.endswith(".npy")
    )
    if not items:
        raise FileNotFoundError(f"no Area_*.npy under {raw}")
    tag = f"Area_{test_area}"
    items = [i for i in items if (tag in i) == (split != "train")]
    rng = np.random.RandomState(seed)
    scenes = []
    for item in items:
        cdata = np.load(os.path.join(raw, item + ".npy")).astype(np.float32)
        cdata[:, :3] -= cdata[:, :3].min(0)
        coord, feat, label = cdata[:, 0:3], cdata[:, 3:6], cdata[:, 6]
        if voxel_size:
            uniq = voxelize(coord, voxel_size, rng=rng)
            coord, feat, label = coord[uniq], feat[uniq], label[uniq]
        scenes.append((coord, feat, label.astype(np.int64)))
    return SceneDataset(scenes, S3DIS_CLASSES, "s3dis")


# ---------------------------------------------------------------------------
# ScanNetV2
# ---------------------------------------------------------------------------

SCANNET_CLASSES = [
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "desk", "curtain",
    "refrigerator", "shower curtain", "toilet", "sink", "bathtub",
    "otherfurniture",
]


def load_scannetv2(root: str, split: str = "train") -> SceneDataset:
    """Per-scene ``.pth`` tuples (coord, feat in [-1,1], label) under
    ``<root>/<split>/`` (scannet.py:95-103); rgb rescaled (f+1)*127.5
    (:141)."""
    import torch  # .pth containers

    if split == "trainval":
        files = sorted(
            glob.glob(os.path.join(root, "train", "*.pth"))
            + glob.glob(os.path.join(root, "val", "*.pth"))
        )
    else:
        files = sorted(glob.glob(os.path.join(root, split, "*.pth")))
    if not files:
        raise FileNotFoundError(f"no .pth scenes under {root}/{split}")
    scenes = []
    for f in files:
        data = torch.load(f, weights_only=False)
        coord, feat, label = data[0:3]
        coord = np.asarray(coord, np.float32)
        feat = (np.asarray(feat, np.float32) + 1) * 127.5
        label = np.asarray(label).astype(np.int64).squeeze()
        scenes.append((coord, feat, label))
    return SceneDataset(scenes, SCANNET_CLASSES, "scannetv2")


# ---------------------------------------------------------------------------
# SemanticKITTI
# ---------------------------------------------------------------------------

KITTI_CLASSES = [
    "car", "bicycle", "motorcycle", "truck", "other-vehicle", "person",
    "bicyclist", "motorcyclist", "road", "parking", "sidewalk",
    "other-ground", "building", "fence", "vegetation", "trunk", "terrain",
    "pole", "traffic-sign",
]

# label remap (semantickitti.py:59-87): raw sensor ids -> 0..19 where 0
# is 'unlabeled' (then -1 so unlabeled becomes the -1 ignore index)
_KITTI_REMAP = np.zeros(260, dtype=np.int32)
for raw, mapped in {
    10: 1, 11: 2, 15: 3, 18: 4, 20: 5, 30: 6, 31: 7, 32: 8, 40: 9,
    44: 10, 48: 11, 49: 12, 50: 13, 51: 14, 70: 15, 71: 16, 72: 17,
    80: 18, 81: 19, 13: 5, 16: 5, 52: 0, 60: 9, 99: 0, 252: 1, 253: 7,
    254: 6, 255: 8, 256: 5, 257: 5, 258: 4, 259: 5,
}.items():
    _KITTI_REMAP[raw] = mapped

TRAIN_SEQS = ("00", "01", "02", "03", "04", "05", "06", "07", "09", "10")


def load_pc_kitti(path: str) -> np.ndarray:
    scan = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    return scan[:, 0:3]  # (semantickitti.py:13-17 drops remission)


def load_label_kitti(path: str) -> np.ndarray:
    label = np.fromfile(path, dtype=np.uint32).reshape(-1)
    sem = label & 0xFFFF  # lower half = semantic (:19-25)
    return (_KITTI_REMAP[np.minimum(sem, 259)] - 1).astype(np.int32)


def load_semantic_kitti(
    root: str, split: str = "train", max_scans: Optional[int] = None
) -> SceneDataset:
    """``<root>/sequences/<seq>/{velodyne,labels}`` scans; sequences
    00-07,09,10 train / 08 val (semantickitti.py:28-56). Labels are
    remapped to 19 classes with -1 = ignored."""
    seq_root = os.path.join(root, "sequences")
    if not os.path.isdir(seq_root):
        raise FileNotFoundError(f"no sequences/ under {root}")
    seqs = TRAIN_SEQS if split == "train" else ("08",)
    scenes = []
    for seq in seqs:
        vel = os.path.join(seq_root, seq, "velodyne")
        if not os.path.isdir(vel):
            continue
        for f in sorted(os.listdir(vel)):
            if not f.endswith(".bin"):
                continue
            coord = load_pc_kitti(os.path.join(vel, f))
            lab = load_label_kitti(
                os.path.join(seq_root, seq, "labels", f.replace(".bin", ".label"))
            )
            scenes.append((coord, None, lab.astype(np.int64)))
            if max_scans and len(scenes) >= max_scans:
                break
        if max_scans and len(scenes) >= max_scans:
            break
    if not scenes:
        raise FileNotFoundError(f"no velodyne scans under {seq_root}")
    return SceneDataset(scenes, KITTI_CLASSES, "semantic_kitti",
                        ignored_labels=(-1,))


# ---------------------------------------------------------------------------
# Matterport3D objects (MP40) — classification
# ---------------------------------------------------------------------------


def load_mp40(
    root: str, split: str = "train", npoints: int = 1024, seed: int = 0
) -> ArrayDataset:
    """Object ``.npy`` dicts {points, label} under ``<root>/raw`` with
    generated 80/10/10 split lists (matterport3d.py:88-112); FPS to
    ``npoints`` via the native batched kernel."""
    raw = os.path.join(root, "raw")
    list_path = os.path.join(root, f"mattportobject_{split}_list.txt")
    if not os.path.exists(list_path):
        files = sorted(f for f in os.listdir(raw) if f.endswith(".npy"))
        if not files:
            raise FileNotFoundError(f"no object .npy under {raw}")
        rng = np.random.RandomState(seed)
        files = list(np.asarray(files)[rng.permutation(len(files))])
        n = len(files)
        n_tr, n_val = int(0.8 * n), int(0.1 * n)
        splits = {
            "train": files[:n_tr],
            "val": files[n_tr : n_tr + n_val],
            "test": files[n_tr + n_val :],
        }
        for sp, names in splits.items():
            with open(os.path.join(root, f"mattportobject_{sp}_list.txt"), "w") as f:
                f.write("\n".join(names))
    with open(list_path) as f:
        names = [l for l in f.read().splitlines() if l]

    pts, labels = [], []
    for name in names:
        d = np.load(os.path.join(raw, name), allow_pickle=True).item()
        p = np.asarray(d["points"], np.float32)[:, :3]
        if p.shape[0] > npoints:
            from ppt_torch.native import fps_batch

            sel = fps_batch(p[None], npoints)[0]
            p = p[sel]
        elif p.shape[0] < npoints:
            pad = np.random.RandomState(seed).choice(
                p.shape[0], npoints - p.shape[0]
            )
            p = np.concatenate([p, p[pad]], axis=0)
        centroid = p.mean(0)
        p = p - centroid
        p = p / np.sqrt((p**2).sum(1)).max()
        pts.append(p)
        labels.append(int(d["label"]))
    # Fixed 40-way class count (Matterport-40): deriving it from
    # max(labels)+1 of THIS split would misalign logits/confusion-matrix
    # shapes across splits whenever a split lacks the highest class id.
    num_classes = max(40, max(labels) + 1) if labels else 40
    classnames = [f"class {i}" for i in range(num_classes)]
    return ArrayDataset(
        points=np.stack(pts),
        labels=np.asarray(labels, np.int32),
        classnames=classnames,
        name="mp40",
    )
