"""Port vs reference: the scene datasets, the confusion matrix, the S3DIS
6-fold tool and the native host FPS.

``ppt_torch.data.scenes`` is numpy on ``np.random.RandomState`` as
``ppt_tpu.data.scenes`` is, so for the same files and seed every array
must be the reference's bit for bit: the voxel hashes, ``voxelize`` in
both modes, ``crop_pc``, the four loaders on fixtures written in their
on-disk formats (S3DIS rooms as ``tests/test_sceneseg_task.py`` writes
them, ScanNetV2 ``.pth`` tuples, SemanticKITTI ``.bin``/``.label`` scans,
MP40 object ``.npy`` dicts), ``materialize_crops`` and the registry's
crops. ``ConfusionMatrix`` and ``s3dis_6fold.aggregate`` give the
reference's numbers exactly.
"""

import os

import numpy as np
import pytest
import torch

from test_sceneseg_task import _fixture

from ppt_torch.data import datasets as tds
from ppt_torch.data import scenes as ts

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores


class _Args:
    def __init__(self, **kw):
        self.allow_synthetic_fallback = False
        self.seed = 0
        for k, v in kw.items():
            setattr(self, k, v)


def same(got, want, path="x"):
    """Equal structure, dtypes and bits (arrays, tuples, lists, None)."""
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{path}[{i}]")
        return
    if want is None:
        assert got is None, path
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=path)


def same_scenes(got, want):
    assert (got.classnames, got.name, got.ignored_labels) == (
        want.classnames, want.name, want.ignored_labels)
    same(got.scenes, want.scenes, "scenes")


def same_arrays(got, want):
    assert (got.classnames, got.name) == (want.classnames, want.name)
    for k in ("points", "labels", "seg_labels"):
        same(getattr(got, k), getattr(want, k), k)


@pytest.mark.parametrize("fn", ["fnv_hash_vec", "ravel_hash_vec"])
def test_voxel_hashes(fn):
    from ppt_tpu.data import scenes as js

    arr = np.floor(np.random.RandomState(0).rand(300, 3) * 17).astype(np.float64)
    same(getattr(ts, fn)(arr), getattr(js, fn)(arr))


@pytest.mark.parametrize("hash_type", ["fnv", "ravel"])
@pytest.mark.parametrize("voxel_size", [0.05, 0.2])
def test_voxelize_both_modes(hash_type, voxel_size):
    from ppt_tpu.data import scenes as js

    coord = np.random.RandomState(1).rand(800, 3).astype(np.float32) * 2
    same(ts.voxelize(coord, voxel_size, hash_type, mode=0, rng=np.random.RandomState(3)),
         js.voxelize(coord, voxel_size, hash_type, mode=0, rng=np.random.RandomState(3)))
    same(ts.voxelize(coord, voxel_size, hash_type, mode=1),
         js.voxelize(coord, voxel_size, hash_type, mode=1))


@pytest.mark.parametrize("split,n,variable,feat", [
    ("train", 300, False, True), ("val", 300, False, True), ("train", 20, False, False),
    ("train", 20, True, True), ("test", 300, True, False)])
@pytest.mark.parametrize("voxel_size", [0.0, 0.1])
def test_crop_pc(split, n, variable, feat, voxel_size):
    from ppt_tpu.data import scenes as js

    rng = np.random.RandomState(2)
    coord = rng.rand(n, 3).astype(np.float32)
    f = rng.rand(n, 3).astype(np.float32) * 255 if feat else None
    label = rng.randint(0, 13, n)
    kw = dict(split=split, voxel_size=voxel_size, voxel_max=64, downsample=bool(voxel_size),
              variable=variable)
    same(ts.crop_pc(coord, f, label, rng=np.random.RandomState(5), **kw),
         js.crop_pc(coord, f, label, rng=np.random.RandomState(5), **kw))


@pytest.mark.parametrize("split", ["train", "val"])
def test_s3dis_loader_crops_and_registry(split, tmp_path):
    from ppt_tpu.data import datasets as jds
    from ppt_tpu.data import scenes as js

    _fixture(str(tmp_path), np.random.RandomState(0))
    for vs in (0.0, 0.1):
        same_scenes(ts.load_s3dis(str(tmp_path), split, test_area=5, voxel_size=vs, seed=3),
                    js.load_s3dis(str(tmp_path), split, test_area=5, voxel_size=vs, seed=3))
    scenes = ts.load_s3dis(str(tmp_path), split, voxel_size=0.1)
    same_arrays(ts.materialize_crops(scenes, 128, split, crops_per_scene=2, seed=4),
                js.materialize_crops(js.load_s3dis(str(tmp_path), split, voxel_size=0.1), 128,
                                     split, crops_per_scene=2, seed=4))
    args = _Args(data_path=str(tmp_path), npoints=128, voxel_size=0.1, voxel_max=128,
                 test_area=5, seed=1)
    got = tds.build_dataset("s3dis", args, split)
    same_arrays(got, jds.build_dataset("s3dis", args, split))
    assert got.points.shape == (2, 128, 6) and got.seg_labels.shape == (2, 128)


def _scannet(root, rng):
    for split in ("train", "val"):
        os.makedirs(os.path.join(root, split))
        for i in range(2):
            n = 300
            data = (rng.rand(n, 3).astype(np.float32), rng.rand(n, 3).astype(np.float32) * 2 - 1,
                    rng.randint(0, 20, (n, 1)))
            torch.save(data, os.path.join(root, split, f"scene{i}.pth"))


def _kitti(root, rng):
    for seq in ("00", "08"):
        for sub in ("velodyne", "labels"):
            os.makedirs(os.path.join(root, "sequences", seq, sub))
        for i in range(2):
            rng.rand(200, 4).astype(np.float32).tofile(
                os.path.join(root, "sequences", seq, "velodyne", f"{i:06d}.bin"))
            lab = rng.choice([10, 40, 48, 70, 0, 252, 300], 200).astype(np.uint32)
            (lab | (np.uint32(5) << 16)).tofile(
                os.path.join(root, "sequences", seq, "labels", f"{i:06d}.label"))


@pytest.mark.parametrize("name", ["scannetv2", "semantic_kitti"])
def test_scannet_and_kitti_loaders_and_registry(name, tmp_path):
    from ppt_tpu.data import datasets as jds
    from ppt_tpu.data import scenes as js

    (_scannet if name == "scannetv2" else _kitti)(str(tmp_path), np.random.RandomState(1))
    load = "load_scannetv2" if name == "scannetv2" else "load_semantic_kitti"
    for split in (("train", "val", "trainval") if name == "scannetv2" else ("train", "val")):
        same_scenes(getattr(ts, load)(str(tmp_path), split),
                    getattr(js, load)(str(tmp_path), split))
    for kw in ({}, {"voxel_size": 0.05}):
        args = _Args(data_path=str(tmp_path), npoints=64, voxel_max=64, **kw)
        same_arrays(tds.build_dataset(name, args, "train"), jds.build_dataset(name, args, "train"))


def test_kitti_label_remap():
    from ppt_tpu.data import scenes as js

    same(ts._KITTI_REMAP, js._KITTI_REMAP)


def test_mp40_loader_and_registry(tmp_path):
    """Objects sampled by the native host FPS (``ppt_torch.native.fps_batch``)
    and padded, the split lists written once and read back."""
    from ppt_tpu.data import datasets as jds
    from ppt_tpu.data import scenes as js

    rng = np.random.RandomState(3)
    os.makedirs(tmp_path / "raw")
    for i in range(10):
        n = 200 if i % 3 else 40  # some objects shorter than npoints: padded
        np.save(tmp_path / "raw" / f"obj{i}.npy",
                {"points": rng.rand(n, 6).astype(np.float32), "label": i % 4},
                allow_pickle=True)
    for split in ("train", "val", "test"):
        same_arrays(ts.load_mp40(str(tmp_path), split, npoints=64, seed=2),
                    js.load_mp40(str(tmp_path), split, npoints=64, seed=2))
    args = _Args(data_path=str(tmp_path), npoints=64)
    same_arrays(tds.build_dataset("matterport3d", args, "train"),
                jds.build_dataset("matterport3d", args, "train"))


def test_native_fps_batch_matches_the_reference_binding():
    from ppt_tpu.native import fps_batch as jax_fps

    from ppt_torch.native import fps_batch

    pts = np.random.RandomState(4).rand(3, 300, 3).astype(np.float32)
    pts[1, 5] = pts[1, 6]  # a duplicate point
    for npoint, start in ((1, 0), (64, 0), (300, 7), (400, 0)):
        same(fps_batch(pts, npoint, start), jax_fps(pts, npoint, start))


def test_missing_scene_files_fall_back_or_raise(tmp_path):
    """The registry keeps ``build_dataset``'s synthetic fallback."""
    args = _Args(data_path=str(tmp_path), npoints=64, voxel_max=64, num_classes=4,
                 samples_per_class=2)
    with pytest.raises(FileNotFoundError):
        tds.build_dataset("scannetv2", args, "train")
    args.allow_synthetic_fallback = True
    assert tds.build_dataset("scannetv2", args, "train").name == "synthetic"


def test_confusion_matrix_matches_the_reference():
    from ppt_tpu.utils.metrics import ConfusionMatrix as JaxCM

    from ppt_torch.utils.metrics import ConfusionMatrix

    rng = np.random.RandomState(5)
    got, want = ConfusionMatrix(6), JaxCM(6)
    for _ in range(3):
        preds, labels = rng.randint(0, 6, 500), rng.randint(0, 5, 500)  # class 5 absent
        got.update(preds, labels)
        want.update(preds, labels)
    same(got.matrix, want.matrix)
    assert got.matrix.dtype == np.int64
    for k in ("overall_accuracy", "mean_accuracy", "miou"):
        assert getattr(got, k) == getattr(want, k), k
    same(got.class_accuracy, want.class_accuracy)
    same(got.ious, want.ious)


def test_s3dis_6fold_matches_the_reference(tmp_path, capsys):
    import json

    from ppt_tpu.tools.s3dis_6fold import aggregate as jax_aggregate

    from ppt_torch.tools import s3dis_6fold
    from ppt_torch.utils.metrics import ConfusionMatrix

    rng = np.random.RandomState(6)
    for fold in range(3):
        cm = ConfusionMatrix(4)
        cm.update(rng.randint(0, 4, 300), rng.randint(0, 4, 300))
        np.savez(tmp_path / f"a{fold}.npz", matrix=cm.matrix,
                 classnames=np.asarray(["a", "b", "c", "d"], dtype=object))
    paths = sorted(str(p) for p in tmp_path.glob("a*.npz"))
    want = jax_aggregate(paths)
    assert s3dis_6fold.aggregate(paths) == want
    assert s3dis_6fold.main([str(tmp_path / "a*.npz")]) == want
    assert json.loads(capsys.readouterr().out) == want
    with pytest.raises(ValueError, match="no confusion"):
        s3dis_6fold.aggregate([])
