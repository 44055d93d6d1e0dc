"""Port vs reference: the dataset loaders, readers and augmentations.

The loaders run on small files written here, once through the port and
once through ``ppt_tpu.data.datasets``: a ModelNet10 pickle (npoints equal
to the file's, so no FPS draw), a ScanObjectNN ``.h5`` for each variant
(``obj_only``, ``obj_bg``, ``hardest``), ``.pcd`` files in ASCII and binary,
``.txt`` and ``.h5`` clouds. Arrays are compared exactly (the same numpy
operations on both sides), and the ``*_fs`` splits are equal at one seed.
Without ``h5py`` ScanObjectNN falls back to synthetic clouds with the
reference's warning. The seven augmentations are checked by their
invariants and distributions, as ``tests/test_data.py:24-80`` checks the
reference's (means within 4 standard errors): the numbers come from
another generator.
"""

import logging
import math
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from ppt_torch.data import augment as A
from ppt_torch.data import datasets as D
from ppt_torch.tasks.args import TaskArgs


def _cloud(rng, n, c=3):
    return rng.randn(n, c).astype(np.float32)


def _write_modelnet(root, rng, n_per_class=3, npts=64):
    names = [f"shape_{i}" for i in range(10)]
    with open(os.path.join(root, "modelnet10_shape_names.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    for split in ("train", "test"):
        pts = [_cloud(rng, npts, 6) for _ in range(10 * n_per_class)]
        labels = [np.asarray([i // n_per_class]) for i in range(10 * n_per_class)]
        with open(os.path.join(root, f"modelnet10_{split}_8192pts_fps.dat"), "wb") as f:
            pickle.dump((pts, labels), f)


def _write_sonn(root, rng, n=30, npts=80):
    import h5py

    with open(os.path.join(root, "shape_names.txt"), "w") as f:
        f.write("\n".join(f"object_{i}" for i in range(15)) + "\n")
    for variant in ("obj_only", "obj_bg", "hardest"):
        os.makedirs(os.path.join(root, variant), exist_ok=True)
        for split in ("train", "test"):
            name = (f"{split}_objectdataset_augmentedrot_scale75.h5" if variant == "hardest"
                    else f"{split}_objectdataset.h5")
            with h5py.File(os.path.join(root, variant, name), "w") as f:
                f["data"] = rng.randn(n, npts, 3).astype(np.float32)
                f["label"] = rng.randint(0, 15, n).astype(np.int64)


def _args(root, **kw):
    base = dict(data_path=str(root), npoints=64, nshots=2, seed=3,
                allow_synthetic_fallback=False)
    base.update(kw)
    return TaskArgs(**base)


def _same(got, want):
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.classnames == want.classnames and got.name == want.name


@pytest.mark.parametrize("name", ["modelnet10", "modelnet10_fs"])
@pytest.mark.parametrize("split", ["train", "test"])
def test_modelnet10_loads_as_the_reference(tmp_path, name, split):
    from ppt_tpu.data.datasets import build_dataset

    _write_modelnet(str(tmp_path), np.random.RandomState(0))
    got = D.build_dataset(name, _args(tmp_path), split)
    _same(got, build_dataset(name, _args(tmp_path), split))
    assert got.points.shape[1:] == (64, 3) and got.num_classes == 10
    if name.endswith("_fs") and split == "train":
        assert len(got) == 10 * 2  # nshots per class


@pytest.mark.parametrize("variant", ["obj_only", "obj_bg", "hardest"])
@pytest.mark.parametrize("name", ["scanobjectnn", "scanobjectnn_fs"])
def test_scanobjectnn_loads_as_the_reference(tmp_path, variant, name):
    from ppt_tpu.data.datasets import build_dataset

    _write_sonn(str(tmp_path), np.random.RandomState(1))
    for split in ("train", "test"):
        args = _args(tmp_path, sonn_type=variant)
        got = D.build_dataset(name, args, split)
        _same(got, build_dataset(name, args, split))
        assert got.points.shape[1:] == (64, 3) and got.name.startswith(f"scanobjectnn_{variant}")
        if name.endswith("_fs") and split == "train":
            present = len(np.unique(D.build_dataset("scanobjectnn", args, "train").labels))
            assert len(got) == present * 2 and got.name.endswith("_fs2")


@pytest.mark.parametrize("name", ["modelnet40_fs", "modelnet10_fs", "scanobjectnn_fs"])
def test_fewshot_splits_equal_the_reference_at_one_seed(name):
    from ppt_tpu.data.datasets import generate_fewshot, make_synthetic

    ds = make_synthetic(num_classes=6, samples_per_class=5, npoints=16)
    port = D.ArrayDataset(ds.points, ds.labels, ds.classnames, name=name)
    for nshots, seed in ((3, 0), (7, 11)):  # 7 > 5: drawn with replacement
        got = D.generate_fewshot(port, nshots, seed=seed)
        want = generate_fewshot(ds, nshots, seed=seed)
        np.testing.assert_array_equal(got.points, want.points)
        np.testing.assert_array_equal(got.labels, want.labels)
        assert got.name == f"{name}_fs{nshots}" and len(got) == 6 * nshots


def test_scanobjectnn_without_h5py_falls_back_with_the_reference_warning(tmp_path, monkeypatch,
                                                                        caplog):
    monkeypatch.setitem(sys.modules, "h5py", None)
    args = _args(tmp_path, allow_synthetic_fallback=True)
    args.num_classes, args.samples_per_class = 3, 2
    with caplog.at_level(logging.WARNING):
        ds = D.build_dataset("scanobjectnn", args, "train")
    assert ds.name == "synthetic" and len(ds) == 6
    assert "dataset scanobjectnn unavailable" in caplog.text and "synthetic fallback" in caplog.text
    with pytest.raises(ImportError):
        D.build_dataset("scanobjectnn", _args(tmp_path), "train")


def test_h5py_is_imported_only_where_a_file_is_read():
    import inspect

    src = inspect.getsource(D)
    assert "\nimport h5py" not in src and "\nfrom h5py" not in src
    assert src.count("import h5py") == 2  # read_cloud's .h5 branch, load_scanobjectnn


def _write_pcd(path, xyz, mode, extra_count=1):
    n = len(xyz)
    extra = np.arange(n * extra_count, dtype=np.float32).reshape(n, extra_count)
    header = ("# .PCD v0.7\nVERSION 0.7\nFIELDS x y z rgb\nSIZE 4 4 4 4\nTYPE F F F F\n"
              f"COUNT 1 1 1 {extra_count}\nWIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
              f"POINTS {n}\nDATA {mode}\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        rows = np.concatenate([xyz, extra], axis=1).astype(np.float32)
        if mode == "ascii":
            f.write("\n".join(" ".join(repr(float(v)) for v in r) for r in rows).encode() + b"\n")
        elif mode == "binary":
            f.write(rows.tobytes())
        else:
            f.write(b"\x00" * 16)


@pytest.mark.parametrize("mode,count", [("ascii", 1), ("ascii", 3), ("binary", 1),
                                        ("binary", 2)])
def test_pcd_reads_as_the_reference(tmp_path, mode, count):
    from ppt_tpu.data.datasets import read_cloud, read_pcd

    xyz = np.random.RandomState(2).randn(37, 3).astype(np.float32)
    path = str(tmp_path / "c.pcd")
    _write_pcd(path, xyz, mode, count)
    got = D.read_cloud(path)
    np.testing.assert_array_equal(got, read_pcd(path))
    np.testing.assert_array_equal(got, read_cloud(path))
    np.testing.assert_allclose(got, xyz, rtol=0, atol=0 if mode == "binary" else 1e-7)
    assert got.dtype == np.float64 and got.shape == (37, 3)


def test_compressed_pcd_is_refused_as_by_the_reference(tmp_path):
    from ppt_tpu.data.datasets import read_pcd

    path = str(tmp_path / "c.pcd")
    _write_pcd(path, np.zeros((4, 3), np.float32), "binary_compressed")
    with pytest.raises(ValueError, match="binary_compressed"):
        D.read_cloud(path)
    with pytest.raises(ValueError, match="binary_compressed"):
        read_pcd(path)


def test_txt_h5_npy_clouds_read_as_the_reference(tmp_path):
    import h5py

    from ppt_tpu.data.datasets import read_cloud

    pts = np.random.RandomState(4).randn(20, 6).astype(np.float32)
    np.savetxt(tmp_path / "c.txt", pts)
    np.save(tmp_path / "c.npy", pts)
    with h5py.File(tmp_path / "c.h5", "w") as f:
        f["data"] = pts
    for ext in ("txt", "npy", "h5"):
        path = str(tmp_path / f"c.{ext}")
        got = D.read_cloud(path)
        np.testing.assert_array_equal(got, read_cloud(path))
        np.testing.assert_allclose(got, pts, rtol=1e-6)
    with pytest.raises(ValueError, match="Unsupported"):
        D.read_cloud(str(tmp_path / "c.ply"))


# ---------------------------------------------------------------------------
# augmentations
# ---------------------------------------------------------------------------

def _clouds(B=2048, N=16, seed=0):
    return torch.rand(B, N, 3, generator=torch.Generator().manual_seed(seed)) - 0.5


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _mean_ok(x, mean, std):
    x = np.asarray(x, np.float64).ravel()
    assert abs(x.mean() - mean) <= 4 * std / math.sqrt(x.size), (x.mean(), mean)


def test_normalize_to_unit_sphere_as_the_reference():
    import jax.numpy as jnp

    from ppt_tpu.data.augment import normalize_to_unit_sphere

    pc = np.random.RandomState(5).randn(3, 50, 3).astype(np.float32) * 5 + 2
    got = A.normalize_to_unit_sphere(torch.from_numpy(pc)).numpy()
    np.testing.assert_allclose(got, np.asarray(normalize_to_unit_sphere(jnp.asarray(pc))),
                               rtol=1e-5, atol=1e-6)
    for b in range(3):
        np.testing.assert_allclose(got[b].mean(0), 0, atol=1e-5)
        assert abs(np.linalg.norm(got[b], axis=1).max() - 1.0) < 1e-5
        np.testing.assert_allclose(got[b], D.pc_normalize(pc[b]), rtol=1e-4, atol=1e-5)


def test_rotate_y_keeps_norms_and_y_with_a_uniform_angle():
    pc = _clouds(B=4096, N=8)
    out = A.rotate_y(_gen(1), pc)
    torch.testing.assert_close(out.norm(dim=-1), pc.norm(dim=-1), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(out[..., 1], pc[..., 1], rtol=0, atol=1e-6)
    # the angle of each cloud from its first point's xz rotation
    a = torch.atan2(pc[:, 0, 2], pc[:, 0, 0]) - torch.atan2(out[:, 0, 2], out[:, 0, 0])
    ang = torch.remainder(a, 2 * math.pi).numpy()
    _mean_ok(ang, math.pi, 2 * math.pi / math.sqrt(12))
    _mean_ok(np.cos(ang), 0.0, math.sqrt(0.5))
    assert ang.min() < 0.05 and ang.max() > 2 * math.pi - 0.05  # the whole circle


def test_rotate_perturbation_is_a_small_rotation():
    pc = _clouds(B=4096, N=8)
    out = A.rotate_perturbation(_gen(2), pc)
    torch.testing.assert_close(out.norm(dim=-1), pc.norm(dim=-1), rtol=1e-5, atol=1e-6)
    # R = pinv(pc) out per cloud: a rotation whose angle is at most that of
    # three clipped angles of 0.18
    r = torch.linalg.lstsq(pc.double(), out.double()).solution
    eye = torch.eye(3, dtype=torch.float64).expand_as(r)
    torch.testing.assert_close(r.transpose(1, 2) @ r, eye, atol=1e-5, rtol=0)
    angle = torch.arccos(torch.clamp((torch.diagonal(r, dim1=1, dim2=2).sum(-1) - 1) / 2, -1, 1))
    assert float(angle.max()) <= math.sqrt(3) * 0.18 + 1e-4
    assert float(angle.mean()) > 0.05  # not the identity


def test_jitter_is_clipped_gaussian_noise():
    pc = _clouds(B=512, N=64)
    d = (A.jitter(_gen(3), pc) - pc).numpy()
    assert np.abs(d).max() <= 0.05 + 1e-7
    _mean_ok(d, 0.0, 0.01)
    assert abs(d.std() - 0.01) < 2e-4


def test_random_scale_is_one_isotropic_uniform_scale_per_cloud():
    pc = _clouds() + 1.0  # away from 0, so the ratio is defined
    out = A.random_scale(_gen(4), pc)
    s = (out / pc).numpy()
    np.testing.assert_allclose(s, s[:, :1, :1] * np.ones_like(s), rtol=1e-6)
    s = s[:, 0, 0]
    assert s.min() >= 0.8 - 1e-6 and s.max() <= 1.25 + 1e-6
    _mean_ok(s, (0.8 + 1.25) / 2, 0.45 / math.sqrt(12))


def test_shift_is_one_uniform_shift_per_cloud():
    pc = _clouds()
    t = (A.shift(_gen(5), pc) - pc).numpy()
    np.testing.assert_allclose(t, np.broadcast_to(t[:, :1], t.shape), atol=1e-6)
    t = t[:, 0]
    assert np.abs(t).max() <= 0.1 + 1e-6
    _mean_ok(t, 0.0, 0.2 / math.sqrt(12))
    assert np.std(t[:, 0] - t[:, 1]) > 0.05  # the three axes draw apart


def test_random_point_dropout_replaces_with_the_first_point():
    pc = _clouds(B=1024, N=64)
    out = A.random_point_dropout(_gen(6), pc)
    changed = ~(out == pc).all(-1)
    first = pc[:, :1].expand_as(pc)
    assert torch.equal(out[changed], first[changed])
    assert not changed[:, 0].any()
    frac = changed.float().mean(1).numpy()
    # the ratio is U[0, 1) * 0.875 per cloud: a mean of 0.4375 over clouds
    _mean_ok(frac, 0.4375, 0.875 / math.sqrt(12) + 0.07)
    assert frac.max() > 0.7 and frac.min() < 0.1
