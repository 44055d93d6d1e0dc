"""The port's train-time augmentation, by its distribution.

The reference draws from ``jax.random`` and the port from a
``torch.Generator``, so the numbers differ by construction; the
distributions are the reference's (``data/augment.py:40-46``, ``:114-141``):
per-cloud anisotropic scale in [2/3, 3/2] and shift in [-0.2, 0.2], both
uniform (means within 4 standard errors), then a per-cloud permutation of
the points.
"""

import numpy as np
import torch

from ppt_torch.data.augment import (append_height, shuffle_points, train_augment,
                                    translate_pointcloud)

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores


def _clouds(B=2048, N=16, seed=0):
    return torch.rand(B, N, 3, generator=torch.Generator().manual_seed(seed)) - 0.5


def test_translate_pointcloud_scale_and_shift_ranges():
    pc = _clouds()
    out = translate_pointcloud(torch.Generator().manual_seed(1), pc)
    assert out.shape == pc.shape and out.dtype == pc.dtype
    # a positive scale keeps each axis' order, so its extent gives the scale:
    # [B, 3], one per cloud and axis (recovered in f64)
    o, p = out.double(), pc.double()
    scale = (o.amax(1) - o.amin(1)) / (p.amax(1) - p.amin(1))
    shift = o.mean(1) - p.mean(1) * scale
    # the same scale and shift for every point of a cloud
    torch.testing.assert_close(o, p * scale[:, None] + shift[:, None], atol=1e-6, rtol=0)
    assert float(scale.min()) >= 2 / 3 - 1e-4 and float(scale.max()) <= 3 / 2 + 1e-4
    assert float(shift.min()) >= -0.2 - 1e-4 and float(shift.max()) <= 0.2 + 1e-4
    n = scale.numel()
    lo, hi = 2 / 3, 3 / 2
    assert abs(float(scale.mean()) - (lo + hi) / 2) <= 4 * (hi - lo) / np.sqrt(12 * n)
    assert abs(float(shift.mean())) <= 4 * 0.4 / np.sqrt(12 * n)
    assert float(scale.min()) < 0.70 and float(scale.max()) > 1.45  # the range is used
    # anisotropic: the three axes of a cloud get different scales
    assert float((scale[:, 0] - scale[:, 1]).abs().mean()) > 0.1


def test_shuffle_points_permutes_each_cloud():
    pc = _clouds(B=8, N=64)
    out = shuffle_points(torch.Generator().manual_seed(2), pc)
    assert not torch.equal(out, pc)
    key = lambda t: t[torch.argsort(t[:, 0])]
    for b in range(8):
        assert torch.equal(key(out[b]), key(pc[b]))  # same points, another order
    first = (out[:, 0] == pc[:, 0]).all(-1).float().mean()
    assert float(first) < 0.5  # the FPS seed point changes


def test_append_height():
    pc = _clouds(B=3, N=10)
    out = append_height(pc)
    assert tuple(out.shape) == (3, 10, 4) and torch.equal(out[..., :3], pc)
    torch.testing.assert_close(out[..., 3], pc[..., 1] - pc[..., 1].amin(1, keepdim=True))
    assert float(out[..., 3].min()) == 0.0


def test_train_augment_is_deterministic_under_its_generator():
    pc = _clouds(B=4, N=32)
    a = train_augment(torch.Generator().manual_seed(3), pc)
    b = train_augment(torch.Generator().manual_seed(3), pc)
    c = train_augment(torch.Generator().manual_seed(4), pc)
    assert torch.equal(a, b) and not torch.equal(a, c) and a.shape == pc.shape
    assert tuple(train_augment(torch.Generator().manual_seed(3), pc, True).shape) == (4, 32, 4)
