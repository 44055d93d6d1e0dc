"""Port vs reference: the oracles of PointBERT's grouping kernels at the
edges the CUDA kernels run.

``knn_gather`` runs its selection over the cloud in chunks of
``group.CHUNK`` points, in passes of 64 picks past k = 64, and takes any
query count; ``fps_batched`` holds a few points a thread, padding the last
warp, at every stage size PointNeXt gives it. On the card each is held to
its plain version (``knn_gather_plain``, ``fps_plain``) bit for bit, so the
plain versions must be exact at those edges too: here each is held to the
JAX package's Pallas kernel in interpret mode on the same numpy inputs,
indices exact, coordinates within 1e-6 (the Pallas kernel gathers them
through a three-part bf16 product, exact in f32 but for the sum's order).
Clouds with duplicated points make exact distance ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppt_tpu.kernels.group import fps_batched as jax_fps_batched
from ppt_tpu.kernels.group import knn_gather as jax_knn_gather
from ppt_torch.kernels import group as kgroup

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores

CHUNK = kgroup.CHUNK


def cloud(b, n, seed, dup=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, n, 3).astype(np.float32)
    if dup:  # every fourth point repeats another: exact distance ties
        src = rng.randint(0, n, size=n // 4)
        x[:, 3::4][:, : src.size] = x[:, src]
    return x


def knn_case(b, n, s, k, dup, seed):
    x = cloud(b, n, seed, dup)
    q = cloud(b, s, seed + 1)
    if dup:  # queries on cloud points: zero distances and ties among the duplicates
        q[:, ::2] = x[:, : (s + 1) // 2]
    if n > CHUNK:  # a tie across the border: the first chunk's last point opens the next
        x[:, CHUNK] = x[:, CHUNK - 1]
        q[:, 1] = x[:, CHUNK]
    return x, q


# (b, n, s, k, dup): N just under, at and over the chunk (ties across its
# border); k = 40, 64 and 100 (one pair a lane, two, and passes of 64);
# N = k; S = 8 and 24 (the JAX kernel takes multiples of 8); duplicates
@pytest.mark.parametrize("b,n,s,k,dup", [
    (1, CHUNK - 1, 8, 32, True), (1, CHUNK, 8, 32, True), (1, CHUNK + 1, 24, 32, True),
    (1, 300, 24, 40, True), (2, 300, 8, 64, False), (1, 300, 8, 100, True),
    (2, 40, 8, 40, True), (1, 100, 24, 100, False), (2, 200, 8, 16, True),
    (1, CHUNK + 1, 8, 100, False),
])
def test_knn_gather_plain_matches_pallas_at_the_chunk_edges(b, n, s, k, dup):
    x, q = knn_case(b, n, s, k, dup, n + s + k)
    want_idx, want_nb = jax_knn_gather(k, jnp.asarray(x), jnp.asarray(q), interpret=True)
    idx, nb = kgroup.knn_gather(k, torch.from_numpy(x), torch.from_numpy(q))
    assert idx.dtype == torch.int32 and tuple(idx.shape) == (b, s, k)
    assert nb.dtype == torch.float32 and tuple(nb.shape) == (b, s, k, 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(nb.numpy(), np.asarray(want_nb), rtol=0, atol=1e-6)
    # the coordinates are the picks' own, minus the query, rounded once
    np.testing.assert_array_equal(
        nb.numpy(), np.take_along_axis(x[:, None], idx.numpy()[..., None].astype(np.int64),
                                       axis=2) - q[:, :, None, :])


def test_knn_gather_plain_nearest_first_with_ties_by_index():
    # a query on a point that appears three times: distance 0 at three
    # indices, taken in ascending order, then the rest by distance
    x = cloud(1, 64, 9)
    x[0, [10, 20, 30]] = x[0, 5]
    q = np.repeat(x[:, 5:6], 8, axis=1)
    idx, _ = kgroup.knn_gather_plain(6, torch.from_numpy(x), torch.from_numpy(q))
    want_idx, _ = jax_knn_gather(6, jnp.asarray(x), jnp.asarray(q), interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    assert idx[0, 0, :4].tolist() == [5, 10, 20, 30]


# (b, n, npoint, dup): N not a multiple of 32, npoint = N, duplicated points
@pytest.mark.parametrize("b,n,npoint,dup", [
    (2, 77, 9, False), (1, 300, 64, True), (2, 45, 45, False), (1, 96, 96, True),
    (3, 130, 40, True),
])
def test_fps_plain_matches_pallas_at_the_edges(b, n, npoint, dup):
    x = cloud(b, n, n + npoint, dup)
    want = np.asarray(jax_fps_batched(jnp.asarray(x), npoint, interpret=True))
    got = kgroup.fps_batched(torch.from_numpy(x), npoint)
    assert got.dtype == torch.int32 and tuple(got.shape) == (b, npoint)
    np.testing.assert_array_equal(got.numpy(), want)
    if npoint == n and not dup:  # distinct points: every one is visited once
        assert sorted(got[0].tolist()) == list(range(n))
    if npoint == n and dup:  # once the distinct points are taken, all distances are 0: index 0
        assert got[0, -1] == 0


# PointNeXt-S's four stages (N -> N / 2) at a small batch, each stage on the
# FPS subset of the one before, as the tower runs them
def test_fps_plain_matches_pallas_on_pointnext_stages():
    xyz = cloud(2, 1024, 5)
    for n in (1024, 512, 256, 128):
        assert xyz.shape[1] == n
        want = np.asarray(jax_fps_batched(jnp.asarray(xyz), n // 2, interpret=True))
        got = kgroup.fps_batched(torch.from_numpy(xyz), n // 2).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"stage N={n}")
        xyz = np.take_along_axis(xyz, got[..., None].astype(np.int64), axis=1)


# the kernel paths (the ops' CUDA implementations) refuse by name what the
# kernels do not take, before any build (meta tensors stand in for the card's;
# through the ops a meta tensor takes the fake implementation)
@pytest.mark.parametrize("call,msg", [
    (lambda: kgroup._fps_batched_cuda(
        torch.empty(1, kgroup.FPS_MAX_POINTS + 1, 3, device="meta"), 8),
     f"fps_batched: N={kgroup.FPS_MAX_POINTS + 1} exceeds"),
    (lambda: kgroup._fps_batched_cuda(torch.empty(2, 64, 3, device="meta"), 65),
     "fps_batched: npoint=65 > N=64"),
    (lambda: kgroup._knn_gather_cuda(65, torch.empty(1, 64, 3, device="meta"),
                                     torch.empty(1, 8, 3, device="meta")),
     r"knn_gather: k=65 must lie in \[1, N=64\]"),
    (lambda: kgroup._knn_gather_cuda(0, torch.empty(1, 64, 3, device="meta"),
                                     torch.empty(1, 8, 3, device="meta")),
     r"knn_gather: k=0 must lie in \[1, N=64\]"),
    (lambda: kgroup._knn_gather_cuda(4, torch.empty(2, 64, 3, device="meta"),
                                     torch.empty(1, 8, 3, device="meta")),
     "knn_gather: expects xyz"),
])
def test_grouping_kernel_paths_refuse_by_name(call, msg):
    with pytest.raises(ValueError, match=msg):
        call()
