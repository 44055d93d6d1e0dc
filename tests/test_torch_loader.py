"""Port vs reference: the batch loader and the few-shot split.

Both packages shuffle with ``np.random.RandomState(seed * 100003 +
epoch).permutation``, so they must yield the same batches in the same
order, epoch by epoch (exact). ``generate_fewshot`` draws with the same
generator, so the few-shot train split is the same too (exact).
"""

import numpy as np
import pytest
import torch

from ppt_tpu.data import Loader as JaxLoader
from ppt_tpu.data.datasets import generate_fewshot as jax_fewshot
from ppt_tpu.data.datasets import make_synthetic as jax_synthetic
from ppt_torch.data.datasets import build_dataset, generate_fewshot, make_synthetic
from ppt_torch.data.loader import Loader
from ppt_torch.tasks.args import TaskArgs

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores


def _pair(n_per_class=5):
    kw = dict(num_classes=4, samples_per_class=n_per_class, npoints=16, seed=3)
    return make_synthetic(**kw), jax_synthetic(**kw)


@pytest.mark.parametrize("seed", [0, 7])
def test_shuffled_batches_match_reference_for_three_epochs(seed):
    ds, jds = _pair()
    np.testing.assert_array_equal(ds.points, jds.points)
    loader = Loader(ds, batch_size=6, shuffle=True, drop_last=True, seed=seed)
    jloader = JaxLoader(jds, batch_size=6, shuffle=True, drop_last=True, seed=seed,
                        num_processes=1, process_index=0)
    orders = []
    for epoch in range(3):
        loader.set_epoch(epoch)
        jloader.set_epoch(epoch)
        got, want = list(loader), list(jloader)
        assert len(got) == len(want) == len(loader) == len(jloader) == 3  # 20 // 6
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["pc"], w["pc"])
            np.testing.assert_array_equal(g["label"], w["label"])
            assert g["valid"].all()
        orders.append(np.concatenate([g["label"] for g in got]).tolist())
        want_idx = np.random.RandomState(seed * 100003 + epoch).permutation(20)
        np.testing.assert_array_equal(loader.indices(), want_idx)
    assert orders[0] != orders[1]  # reshuffled per epoch


def test_unshuffled_loader_pads_the_last_batch_like_the_reference():
    ds, jds = _pair()
    got = list(Loader(ds, batch_size=8))
    want = list(JaxLoader(jds, batch_size=8, num_processes=1, process_index=0))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for key in ("pc", "label", "valid"):
            np.testing.assert_array_equal(g[key], w[key])
    assert got[-1]["valid"].sum() == 4
    assert len(Loader(ds, batch_size=8, drop_last=True)) == 2


def test_fewshot_split_matches_reference():
    ds, jds = _pair(n_per_class=6)
    for nshots in (2, 9):  # 9 > 6 per class: with replacement
        got, want = generate_fewshot(ds, nshots, seed=1), jax_fewshot(jds, nshots, seed=1)
        np.testing.assert_array_equal(got.points, want.points)
        np.testing.assert_array_equal(got.labels, want.labels)
        assert got.name == want.name == f"synthetic_fs{nshots}" and len(got) == 4 * nshots
        assert np.bincount(got.labels).tolist() == [nshots] * 4


def test_modelnet40_fs_is_registered_and_falls_back_to_synthetic():
    args = TaskArgs(dataset_name="modelnet40_fs", npoints=16, data_path="/nonexistent")
    assert build_dataset("modelnet40_fs", args, "train").name == "synthetic"
    assert TaskArgs(dataset_name="modelnet40_fs").load_classnames()[0] == "airplane"
    args.allow_synthetic_fallback = False
    with pytest.raises(OSError):
        build_dataset("modelnet40_fs", args, "train")
