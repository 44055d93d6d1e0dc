"""Port vs reference: grouping kernels' plain versions and geometry ops.

The port's plain ``fps_batched`` / ``knn_gather`` (what the wrappers run
on CPU tensors, and what the CUDA kernels are held to on the card)
against the JAX package's Pallas kernels in interpret mode and its XLA
ops, on the same numpy inputs. Indices are compared exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppt_tpu import ops
from ppt_tpu.kernels.group import fps_batched as jax_fps_batched
from ppt_tpu.kernels.group import knn_gather as jax_knn_gather
from ppt_torch.kernels import group as tg
from ppt_torch.ops import geometry as tgeo


@pytest.mark.parametrize("B,N,G", [(2, 256, 32), (3, 200, 16), (1, 1024, 64)])
def test_fps_plain_matches_pallas_and_ops(B, N, G):
    xyz = np.random.RandomState(B * N + G).rand(B, N, 3).astype(np.float32)
    got = tg.fps_batched(torch.from_numpy(xyz), G).numpy()
    want_kernel = np.asarray(jax_fps_batched(jnp.asarray(xyz), G, interpret=True))
    want_ops = np.asarray(ops.farthest_point_sample(jnp.asarray(xyz), G))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want_kernel)
    np.testing.assert_array_equal(got, want_ops)
    np.testing.assert_array_equal(tgeo.farthest_point_sample(torch.from_numpy(xyz), G).numpy(),
                                  want_ops)


@pytest.mark.parametrize("B,N,S,k", [(2, 256, 32, 8), (2, 128, 16, 32)])
def test_knn_gather_plain_matches_pallas(B, N, S, k):
    rng = np.random.RandomState(N + k)
    xyz = rng.rand(B, N, 3).astype(np.float32)
    q_idx = np.asarray(ops.farthest_point_sample(jnp.asarray(xyz), S))
    q = np.take_along_axis(xyz, q_idx[..., None], axis=1)
    idx, nb = tg.knn_gather(k, torch.from_numpy(xyz), torch.from_numpy(q))
    want_idx, want_nb = jax_knn_gather(k, jnp.asarray(xyz), jnp.asarray(q), interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(nb.numpy(), np.asarray(want_nb), rtol=0, atol=1e-6)


def test_knn_ties_go_to_lowest_index():
    # duplicated points: every distance appears twice; the kernel contract
    # takes the lower index first
    base = np.random.RandomState(3).rand(1, 64, 3).astype(np.float32)
    xyz = np.concatenate([base, base], axis=1)  # [1, 128, 3]
    q = base[:, :8]
    idx, _ = tg.knn_gather(6, torch.from_numpy(xyz), torch.from_numpy(q))
    want_idx, _ = jax_knn_gather(6, jnp.asarray(xyz), jnp.asarray(q), interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    assert idx[0, 0, 0] == 0 and idx[0, 0, 1] == 64


def test_knn_centre_relative_coordinates():
    xyz = np.random.RandomState(5).rand(1, 128, 3).astype(np.float32)
    q = xyz[:, :8]
    idx, nb = tg.knn_gather(4, torch.from_numpy(xyz), torch.from_numpy(q))
    np.testing.assert_array_equal(nb[0].numpy(), xyz[0][idx[0].numpy()] - q[0][:, None, :])


def test_fused_group_matches_reference_group_points():
    from ppt_tpu.nn.pointbert import group_points

    xyz = np.random.RandomState(7).rand(2, 256, 3).astype(np.float32)
    nb, center = tg.fused_group(torch.from_numpy(xyz), 16, 8)
    want_nb, want_center = group_points(jnp.asarray(xyz), 16, 8)
    np.testing.assert_array_equal(center.numpy(), np.asarray(want_center))
    # the reference's CPU path ranks by the expanded-form distance; compare
    # the neighbourhoods as sets
    np.testing.assert_allclose(np.sort(nb.numpy(), axis=2), np.sort(np.asarray(want_nb), axis=2),
                               atol=1e-6)


def test_geometry_ops_match_reference():
    rng = np.random.RandomState(11)
    src = rng.randn(2, 40, 3).astype(np.float32)
    dst = rng.randn(2, 50, 3).astype(np.float32)
    np.testing.assert_allclose(
        tgeo.square_distance(torch.from_numpy(src), torch.from_numpy(dst)).numpy(),
        np.asarray(ops.square_distance(jnp.asarray(src), jnp.asarray(dst))), atol=1e-5)
    idx = rng.randint(0, 50, (2, 7, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        tgeo.index_points(torch.from_numpy(dst), torch.from_numpy(idx)).numpy(),
        np.asarray(ops.index_points(jnp.asarray(dst), jnp.asarray(idx))))
    got = tgeo.knn_point(5, torch.from_numpy(dst), torch.from_numpy(src)).numpy()
    want = np.asarray(ops.knn_point(5, jnp.asarray(dst), jnp.asarray(src)))
    np.testing.assert_array_equal(got, want)


def _lattice(B, N, seed):
    """Coordinates on a 1/64 lattice: squared distances are exact in f32 in
    the expanded form and in the exact-difference form alike, and none of
    the radii used here squares to a multiple of 1/4096."""
    return (np.random.RandomState(seed).randint(0, 65, (B, N, 3)) / 64.0).astype(np.float32)


@pytest.mark.parametrize("radius,K", [(0.2, 8), (0.05, 6), (0.7, 40)])
def test_query_ball_point_matches_reference(radius, K):
    xyz = np.random.RandomState(K).rand(2, 120, 3).astype(np.float32)
    q = xyz[:, ::5]
    got = tgeo.query_ball_point(radius, K, torch.from_numpy(xyz), torch.from_numpy(q))
    want = np.asarray(ops.query_ball_point(radius, K, jnp.asarray(xyz), jnp.asarray(q)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    far = np.full((2, 3, 3), 9.0, np.float32)  # no hit: the clamped sentinel
    got = tgeo.query_ball_point(radius, K, torch.from_numpy(xyz), torch.from_numpy(far))
    assert (got == 119).all()
    idx = np.random.RandomState(1).randint(0, 120, (2, 7, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        tgeo.group_points(torch.from_numpy(xyz), torch.from_numpy(idx)).numpy(),
        np.asarray(ops.group_points(jnp.asarray(xyz), jnp.asarray(idx))))


@pytest.mark.parametrize("with_points", [True, False])
def test_sample_and_group_matches_reference(with_points):
    """Through the kernels' wrappers (their plain versions here) against the
    reference's CPU path, on lattice clouds where the two distance forms
    agree exactly."""
    xyz = _lattice(2, 150, 3)
    pts = np.random.RandomState(4).randn(2, 150, 5).astype(np.float32) if with_points else None
    new_xyz, new_points = tgeo.sample_and_group(
        16, 0.3, 9, torch.from_numpy(xyz), None if pts is None else torch.from_numpy(pts))
    want_xyz, want_points = ops.sample_and_group(
        16, 0.3, 9, jnp.asarray(xyz), None if pts is None else jnp.asarray(pts))
    np.testing.assert_array_equal(new_xyz.numpy(), np.asarray(want_xyz))
    assert new_points.shape == (2, 16, 9, 8 if with_points else 3)
    np.testing.assert_array_equal(new_points.numpy(), np.asarray(want_points))


def test_sample_and_group_all_matches_reference():
    xyz = _lattice(2, 20, 5)
    pts = np.random.RandomState(6).randn(2, 20, 4).astype(np.float32)
    for p in (pts, None):
        new_xyz, grouped = tgeo.sample_and_group_all(
            torch.from_numpy(xyz), None if p is None else torch.from_numpy(p))
        want_xyz, want = ops.sample_and_group_all(
            jnp.asarray(xyz), None if p is None else jnp.asarray(p))
        np.testing.assert_array_equal(new_xyz.numpy(), np.asarray(want_xyz))
        np.testing.assert_array_equal(grouped.numpy(), np.asarray(want))
