"""Port vs reference: the packed (offset) point ops.

``ppt_torch.ops.ragged`` against ``ppt_tpu.ops.ragged`` on clouds of equal
and of unequal sizes, the same numpy inputs through both. The port computes
each cloud's block of the reference's expanded-form distance on its own:
on a 1/64 lattice every such distance is exact in f32 on both sides, so kNN
indices (ties to the lower index) and distances must be equal; on uniform
random clouds the two products round alike only up to the last bit, so
the neighbourhoods are compared as sets. FPS must give the reference's
indices exactly (each cloud from its first point, through the
``fps_batched`` wrapper: one call for equal clouds, one a cloud
otherwise), the ball query too; the interpolation within 1e-5 of the
output's magnitude on the lattice.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pointnet2 import lattice_cloud

from ppt_torch.kernels import group as kgroup
from ppt_torch.ops import ragged as tr

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores

SIZES = {"equal": [64, 64, 64], "unequal": [40, 64, 28]}


def packed(kind, seed=0, lattice=True, n_scale=1):
    sizes = [n * n_scale for n in SIZES[kind]]
    if lattice:
        pts = lattice_cloud(1, sum(sizes), seed)[0]
    else:
        pts = np.random.RandomState(seed).rand(sum(sizes), 3).astype(np.float32)
    return pts, np.cumsum(sizes).astype(np.int32)


def both(fn_name, *args, **kw):
    from ppt_tpu.ops import ragged as jr

    want = getattr(jr, fn_name)(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                  for a in args], **kw)
    got = getattr(tr, fn_name)(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                                 for a in args], **kw)
    return got, want


@pytest.mark.parametrize("kind", ["equal", "unequal"])
def test_segment_ids(kind):
    pts, off = packed(kind)
    got, want = both("segment_ids_from_offsets", off, pts.shape[0])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32
    # a sequence of ints gives the same ids as the tensor
    assert torch.equal(tr.segment_ids_from_offsets(off.tolist(), pts.shape[0]), got)


@pytest.mark.parametrize("kind", ["equal", "unequal"])
@pytest.mark.parametrize("nsample", [1, 8, 16])
def test_knn_on_the_lattice_is_exact(kind, nsample):
    pts, off = packed(kind, seed=1)
    q, qoff = packed(kind, seed=2)
    (gi, gd), (wi, wd) = both("knn_query_packed", nsample, pts, off, q, qoff)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    assert gi.dtype == torch.int32


@pytest.mark.parametrize("kind", ["equal", "unequal"])
def test_knn_on_random_clouds_as_sets(kind):
    pts, off = packed(kind, seed=3, lattice=False)
    (gi, gd), (wi, wd) = both("knn_query_packed", 8, pts, off, pts, off)
    wi = np.asarray(wi)
    same = [set(a) == set(b) for a, b in zip(gi.numpy().tolist(), wi.tolist())]
    assert np.mean(same) >= 0.99
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=0, atol=1e-6)


def test_knn_pads_a_cloud_smaller_than_nsample_as_the_reference():
    """A cloud of fewer points than ``nsample``: the masked top-k's +inf
    columns, the lowest indices outside the cloud."""
    sizes = [5, 20, 3]
    pts = lattice_cloud(1, sum(sizes), 4)[0]
    off = np.cumsum(sizes).astype(np.int32)
    (gi, gd), (wi, wd) = both("knn_query_packed", 6, pts, off, pts, off)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


@pytest.mark.parametrize("kind,calls", [("equal", 1), ("unequal", 3)])
@pytest.mark.parametrize("npoint", [1, 16, 28])
def test_fps_is_exact_through_the_wrapper(kind, calls, npoint, monkeypatch):
    pts, off = packed(kind, seed=5)
    seen = []
    real = kgroup.fps_batched
    monkeypatch.setattr(kgroup, "fps_batched",
                        lambda x, n: seen.append(tuple(x.shape)) or real(x, n))
    got, want = both("farthest_point_sample_packed", pts, off, npoint)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32 and got.shape == (3, npoint)
    assert len(seen) == calls
    if kind == "equal":
        assert seen == [(3, 64, 3)]


@pytest.mark.parametrize("kind", ["equal", "unequal"])
@pytest.mark.parametrize("radius,nsample", [(0.1, 8), (0.25, 16), (0.01, 4), (2.0, 80)])
def test_ball_query_is_exact(kind, radius, nsample):
    pts, off = packed(kind, seed=6)
    q, qoff = packed(kind, seed=7)
    got, want = both("ball_query_packed", radius, nsample, pts, off, q, qoff)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32


@pytest.mark.parametrize("kind", ["equal", "unequal"])
@pytest.mark.parametrize("lattice", [True, False])
def test_interpolation(kind, lattice):
    """Euclidean inverse-distance weights over the three nearest, each
    cloud's own; coincident points (the queries include the sources on the
    lattice) take almost all the weight."""
    src, soff = packed(kind, seed=8, lattice=lattice)
    dst, doff = packed(kind, seed=9, lattice=lattice, n_scale=2)
    if lattice:  # every source is also a query
        starts = np.concatenate([[0], doff[:-1]])
        s0 = np.concatenate([[0], soff[:-1]])
        for a, b, e in zip(starts, s0, soff):
            dst[a:a + e - b] = src[b:e]
    feats = np.random.RandomState(10).randn(src.shape[0], 5).astype(np.float32)
    got, want = both("interpolation_packed", src, soff, dst, doff, feats)
    got, want = got.numpy(), np.asarray(want)
    rows, tol = np.ones(len(want), bool), 1e-5
    if not lattice:
        # off the lattice: the rows whose three neighbours agree as sets, and
        # 1e-3, since the expanded form's cancellation (|q|^2 + |p|^2 ~ 1 for
        # d ~ 1e-3) leaves each side's distances a last-bit rounding of ~1e-7
        # apart, which the sqrt-distance weights carry to ~1e-4 (measured)
        (gi, _), (wi, _) = both("knn_query_packed", 3, src, soff, dst, doff)
        rows = np.array([set(a) == set(b) for a, b in zip(gi.numpy().tolist(),
                                                          np.asarray(wi).tolist())])
        assert rows.mean() >= 0.98
        tol = 1e-3
    assert np.max(np.abs(got - want)[rows]) <= tol * np.max(np.abs(want))


def test_grouping_subtraction_aggregation():
    rng = np.random.RandomState(11)
    f = rng.randn(30, 6).astype(np.float32)
    g = rng.randn(12, 6).astype(np.float32)
    idx = rng.randint(0, 30, (12, 5)).astype(np.int32)
    w = rng.rand(12, 5, 6).astype(np.float32)
    got, want = both("grouping_packed", f, idx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got, want = both("subtraction_packed", g, f, idx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    vals = np.array(want)
    got, want = both("aggregation_packed", vals, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
