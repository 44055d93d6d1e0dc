"""Datasets for the recognition, part-segmentation, scene-segmentation and
pretraining paths: ModelNet10/40, ScanObjectNN, ShapeNetPart and
ShapeNet-55 loaders, the scene datasets' crops (``data/scenes.py``),
synthetic fallback.

Counterpart of ``ppt_tpu/data/datasets.py``, cut to what the recognition,
few-shot, part-segmentation and ULIP pretraining tasks need (train and
test splits, ``*_fs`` few-shot resampling of the train split, ShapeNetPart's
per-point part labels, ShapeNet-55's clouds with their taxonomy names). Loaders produce plain numpy; batching is in
``ppt_torch.data.loader``. ScanObjectNN's ``.h5`` files need ``h5py``,
imported only where such a file is read: without it the loader raises
``ImportError`` and ``build_dataset`` falls back to synthetic clouds with
the reference's warning.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import pickle
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

log = logging.getLogger(__name__)

# part-label spans per object category, in the canonical 16-category
# ShapeNetPart order (the reference's ``category2part`` map)
SHAPENETPART_CATEGORIES = [
    "Airplane", "Bag", "Cap", "Car", "Chair", "Earphone", "Guitar",
    "Knife", "Lamp", "Laptop", "Motorbike", "Mug", "Pistol", "Rocket",
    "Skateboard", "Table",
]
SHAPENETPART_PART_RANGES = np.array(
    [
        [0, 4], [4, 6], [6, 8], [8, 12], [12, 16], [16, 19], [19, 22],
        [22, 24], [24, 28], [28, 30], [30, 36], [36, 38], [38, 41],
        [41, 44], [44, 47], [47, 50],
    ],
    dtype=np.int32,
)
SHAPENETPART_NUM_PARTS = 50

# the 50 part names (category_part); the prompts come from assets/labels.json
SHAPENETPART_PART_NAMES = [
    "airplane body", "airplane wing", "airplane tail", "airplane engine",
    "bag handle", "bag body",
    "cap panel", "cap peak",
    "car roof", "car hood", "car wheel", "car body",
    "chair back", "chair seat", "chair leg", "chair arm",
    "earphone earcup", "earphone headband", "earphone wire",
    "guitar head", "guitar neck", "guitar body",
    "knife blade", "knife handle",
    "lamp base", "lamp shade", "lamp bulb", "lamp tube",
    "laptop keyboard", "laptop screen",
    "motorbike wheel", "motorbike seat", "motorbike gas tank",
    "motorbike handle", "motorbike light", "motorbike frame",
    "mug handle", "mug body",
    "pistol barrel", "pistol handle", "pistol trigger",
    "rocket body", "rocket fin", "rocket nose",
    "skateboard wheel", "skateboard deck", "skateboard bar",
    "table top", "table leg", "table drawer",
]


def pc_normalize(pc: np.ndarray) -> np.ndarray:
    """Unit-sphere normalise one cloud (``pc_normalize``, :33-40)."""
    centered = pc - pc.mean(axis=0)
    return centered / np.sqrt((centered**2).sum(axis=1)).max()


def read_pcd(path: str) -> np.ndarray:
    """Uncompressed ``.pcd`` (PCD v0.7, ``DATA ascii`` or ``binary``) ->
    ``[N, 3]`` f64 xyz (``read_pcd``, ``:81-149``); ``binary_compressed`` is
    refused by name, as the reference refuses it."""
    np_types = {("F", 4): "f4", ("F", 8): "f8", ("I", 1): "i1", ("I", 2): "i2",
                ("I", 4): "i4", ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4"}
    header: Dict[str, List[str]] = {}
    with open(path, "rb") as f:
        while True:
            raw = f.readline()
            if not raw:
                raise ValueError(f"{path}: truncated PCD header")
            line = raw.decode("ascii", "ignore").strip()
            if not line or line.startswith("#"):
                continue
            key, _, rest = line.partition(" ")
            header[key.upper()] = rest.split()
            if key.upper() == "DATA":
                break
        fields = header.get("FIELDS", [])
        sizes = [int(v) for v in header.get("SIZE", [])]
        types = header.get("TYPE", [])
        counts = [int(v) for v in header.get("COUNT", [])] or [1] * len(fields)
        npts = int(header.get("POINTS", ["0"])[0]) or (
            int(header.get("WIDTH", ["0"])[0]) * int(header.get("HEIGHT", ["0"])[0]))
        mode = header["DATA"][0].lower() if header["DATA"] else ""
        if mode == "ascii":
            flat = np.loadtxt(f, dtype=np.float64, ndmin=2)
            offsets = np.cumsum([0] + counts)
            col = {name: flat[:, offsets[k]] for k, name in enumerate(fields)}
            xyz = np.stack([col["x"], col["y"], col["z"]], axis=1)
        elif mode == "binary":
            dtype = np.dtype([(name, np_types[(t, s)], (c,)) if c > 1
                              else (name, np_types[(t, s)])
                              for name, s, t, c in zip(fields, sizes, types, counts)])
            rec = np.frombuffer(f.read(npts * dtype.itemsize), dtype=dtype)
            xyz = np.stack([rec["x"], rec["y"], rec["z"]], axis=1)
        else:
            raise ValueError(f"{path}: unsupported PCD DATA mode {mode!r} (ascii and binary "
                             "only, as the reference)")
    return np.ascontiguousarray(xyz.astype(np.float64))


def read_cloud(path: str) -> np.ndarray:
    """A cloud file by extension (``read_cloud``, ``:156-171``): ``.npy``,
    ``.pcd``, ``.h5`` (its ``data`` array; needs ``h5py``) or ``.txt``."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        return np.load(path)
    if ext == ".pcd":
        return read_pcd(path)
    if ext == ".h5":
        import h5py

        with h5py.File(path, "r") as f:
            return f["data"][()]
    if ext == ".txt":
        return np.loadtxt(path)
    raise ValueError(f"Unsupported file extension: {ext}")


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
    labels: np.ndarray  # [M] int32: the class (cls) or the object category (partseg)
    classnames: List[str]
    name: str = ""
    seg_labels: Optional[np.ndarray] = None  # [M, N] int32 part labels (partseg)

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
        labels[i] = int(np.asarray(lab).reshape(-1)[0])  # a [1] array in the pickles
        if npoints < p.shape[0]:
            p = fps_numpy(p, npoints)
        pts[i] = pc_normalize(p[:, :3])
    return ArrayDataset(pts, labels, classnames, name=f"modelnet{num_category}")


def load_scanobjectnn(root: str, split: str, npoints: int,
                      sonn_type: str = "hardest") -> ArrayDataset:
    """ScanObjectNN from its ``.h5`` files (``load_scanobjectnn``, ``:299-318``):
    ``{root}/{sonn_type}/{split}_objectdataset.h5`` for ``obj_only`` and
    ``obj_bg``, ``..._augmentedrot_scale75.h5`` for ``hardest``; each cloud
    truncated to its first ``npoints`` points; class names from
    ``shape_names.txt``."""
    import h5py  # only where a file is read: the fallback covers its absence

    name = (f"{split}_objectdataset_augmentedrot_scale75.h5" if sonn_type == "hardest"
            else f"{split}_objectdataset.h5")
    with h5py.File(os.path.join(root, sonn_type, name), "r") as f:
        data = f["data"][:].astype(np.float32)
        labels = f["label"][:].astype(np.int32)
    with open(os.path.join(root, "shape_names.txt")) as f:
        classnames = [line.strip() for line in f if line.strip()]
    return ArrayDataset(data[:, :npoints, :3], labels, classnames,
                        name=f"scanobjectnn_{sonn_type}")


def load_shapenet55(root: str, split: str, npoints: int, pc_dirname: str = "shapenet_pc",
                    whole: bool = True, seed: int = 0) -> ArrayDataset:
    """ShapeNet-55 ULIP pretraining clouds (``load_shapenet55``, ``:368-416``):
    files from ``{split}.txt`` (``taxonomy-model.npy``; the train split
    also takes ``test.txt`` when ``whole``), each subsampled at random to
    ``npoints`` and normalised to the unit sphere; labels index the
    taxonomy names of ``taxonomy.json`` in order of first appearance."""
    with open(os.path.join(root, "taxonomy.json")) as f:
        taxonomy = json.load(f)
    synset_names = {d["synsetId"]: d["name"].split(",")[0] for d in taxonomy}

    lines: List[str] = []
    with open(os.path.join(root, f"{split}.txt")) as f:
        lines += [line.strip() for line in f if line.strip()]
    if whole and split == "train":
        test_list = os.path.join(root, "test.txt")
        if os.path.exists(test_list):
            with open(test_list) as f:
                lines += [line.strip() for line in f if line.strip()]

    classnames: List[str] = []
    name_to_idx: Dict[str, int] = {}
    rng = np.random.RandomState(seed)
    pts = np.zeros((len(lines), npoints, 3), dtype=np.float32)
    labels = np.zeros(len(lines), dtype=np.int32)
    for i, line in enumerate(lines):
        name = synset_names.get(line.split("-")[0], line.split("-")[0])
        if name not in name_to_idx:
            name_to_idx[name] = len(classnames)
            classnames.append(name)
        data = read_cloud(os.path.join(root, pc_dirname, line)).astype(np.float32)
        if npoints < data.shape[0]:
            choice = rng.permutation(data.shape[0])[:npoints]
        else:
            choice = rng.randint(0, data.shape[0], npoints)
        pts[i] = pc_normalize(data[choice, :3])
        labels[i] = name_to_idx[name]
    return ArrayDataset(pts, labels, classnames, name="shapenet55")


def load_shapenetpart(root: str, split: str, npoints: int, seed: int = 0) -> ArrayDataset:
    """ShapeNetPart from its per-shape ``.txt`` clouds (``load_shapenetpart``,
    ``:321-367``): categories from ``synsetoffset2category.txt``, the split's
    shape ids from ``train_test_split/shuffled_{split}_file_list.json``
    (``trainval`` joins train and val), each cloud normalised to the unit
    sphere and resampled with replacement to ``npoints`` from one generator
    at ``seed``, its last column the part label."""
    cat: Dict[str, str] = {}
    with open(os.path.join(root, "synsetoffset2category.txt")) as f:
        for line in f:
            name, synset = line.strip().split()
            cat[name] = synset
    split_map = {"train": ["train"], "val": ["val"], "test": ["test"],
                 "trainval": ["train", "val"]}
    ids = set()
    for s in split_map[split]:
        with open(os.path.join(root, "train_test_split", f"shuffled_{s}_file_list.json")) as f:
            ids |= {d.split("/")[2] for d in json.load(f)}
    rng = np.random.RandomState(seed)
    pts_list, cat_list, seg_list = [], [], []
    for ci, name in enumerate(SHAPENETPART_CATEGORIES):
        dir_point = os.path.join(root, cat[name])
        for fn in sorted(os.listdir(dir_point)):
            if os.path.splitext(fn)[0] not in ids:
                continue
            data = np.loadtxt(os.path.join(dir_point, fn)).astype(np.float32)
            seg = data[:, -1].astype(np.int32)
            choice = rng.choice(len(seg), npoints, replace=True)
            pts_list.append(pc_normalize(data[:, :3])[choice])
            cat_list.append(ci)
            seg_list.append(seg[choice])
    return ArrayDataset(np.stack(pts_list), np.asarray(cat_list, dtype=np.int32),
                        list(SHAPENETPART_CATEGORIES), name="shapenetpart",
                        seg_labels=np.stack(seg_list))


def make_synthetic(num_classes: int = 40, samples_per_class: int = 8, npoints: int = 1024,
                   seed: int = 0, partseg: bool = False,
                   classnames: Optional[Sequence[str]] = None) -> ArrayDataset:
    """Structured random clouds: each class a distinct mixture of gaussian
    blobs (same generator and values as the reference's). ``partseg``:
    at most 16 categories, named as ShapeNetPart's 16 (the one-hot is
    16 wide whatever has samples), each point labelled ``lo + blob % (hi -
    lo)`` within its category's part range."""
    if partseg:
        num_classes = min(num_classes, len(SHAPENETPART_CATEGORIES))
    rng = np.random.RandomState(seed)
    M = num_classes * samples_per_class
    pts = np.zeros((M, npoints, 3), dtype=np.float32)
    labels = np.zeros(M, dtype=np.int32)
    seg = np.zeros((M, npoints), dtype=np.int32) if partseg else None
    if classnames is None:
        classnames = (SHAPENETPART_CATEGORIES if partseg
                      else [f"shape {i}" for i in range(num_classes)])
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
            if partseg:
                lo, hi = SHAPENETPART_PART_RANGES[c % 16]
                seg[i] = lo + blob % (hi - lo)
    return ArrayDataset(pts, labels, list(classnames), name="synthetic", seg_labels=seg)


def _synthetic(args, split: str) -> ArrayDataset:
    return make_synthetic(
        num_classes=getattr(args, "num_classes", 40),
        samples_per_class=getattr(args, "samples_per_class", 8),
        npoints=args.npoints,
        seed=0 if split == "train" else 1,
        partseg=getattr(args, "task", "cls") == "partseg",
    )


def _few_shot(load: Callable[..., ArrayDataset]) -> Callable[..., ArrayDataset]:
    """The ``*_fs`` split of a loader: ``nshots`` per class drawn from its
    train split at ``args.seed`` (``:477-525``); the test split as is."""

    def build(args, split: str) -> ArrayDataset:
        ds = load(args, split)
        return generate_fewshot(ds, args.nshots, seed=args.seed) if split == "train" else ds

    return build


def _modelnet(num_category: int) -> Callable[..., ArrayDataset]:
    return lambda args, split: load_modelnet(args.data_path, split, args.npoints, num_category)


def _scanobjectnn(args, split: str) -> ArrayDataset:
    return load_scanobjectnn(args.data_path, split, args.npoints, args.sonn_type)


def _s3dis(args, split: str) -> ArrayDataset:
    from ppt_torch.data.scenes import load_s3dis, materialize_crops

    scenes = load_s3dis(args.data_path, split, test_area=getattr(args, "test_area", 5),
                        voxel_size=getattr(args, "voxel_size", 0.04))
    return materialize_crops(scenes, voxel_max=getattr(args, "voxel_max", args.npoints),
                             split=split, seed=getattr(args, "seed", 0))


def _scannetv2(args, split: str) -> ArrayDataset:
    from ppt_torch.data.scenes import load_scannetv2, materialize_crops

    return materialize_crops(load_scannetv2(args.data_path, split),
                             voxel_max=getattr(args, "voxel_max", args.npoints), split=split,
                             voxel_size=getattr(args, "voxel_size", 0.04),
                             seed=getattr(args, "seed", 0))


def _semantic_kitti(args, split: str) -> ArrayDataset:
    from ppt_torch.data.scenes import load_semantic_kitti, materialize_crops

    return materialize_crops(load_semantic_kitti(args.data_path, split),
                             voxel_max=getattr(args, "voxel_max", args.npoints), split=split,
                             voxel_size=getattr(args, "voxel_size", 0.06),
                             seed=getattr(args, "seed", 0))


def _mp40(args, split: str) -> ArrayDataset:
    from ppt_torch.data.scenes import load_mp40

    return load_mp40(args.data_path, split, args.npoints, seed=getattr(args, "seed", 0))


DATASETS: Dict[str, Callable[..., ArrayDataset]] = {
    "modelnet40": _modelnet(40),
    "modelnet10": _modelnet(10),
    "scanobjectnn": _scanobjectnn,
    "modelnet40_fs": _few_shot(_modelnet(40)),
    "modelnet10_fs": _few_shot(_modelnet(10)),
    "scanobjectnn_fs": _few_shot(_scanobjectnn),
    "shapenetpart": lambda args, split: load_shapenetpart(args.data_path, split, args.npoints),
    "shapenet": lambda args, split: load_shapenet55(args.data_path, split, args.npoints),
    "s3dis": _s3dis,
    "scannetv2": _scannetv2,
    "semantic_kitti": _semantic_kitti,
    "matterport3d": _mp40,  # the MP40 objects, under the reference's key
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
