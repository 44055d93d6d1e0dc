"""Port vs reference: single-cloud FPS and kNN (``fps_single``,
``knn_single``, the counterparts of ``fps_pallas`` and ``knn_pallas``).

On the CPU the wrappers take their plain versions; each is held to the
reference's Pallas kernel interpreted, with indices exact: both sides
take the exact-difference distance ``((x-c)^2 + (y-c)^2) + (z-c)^2`` in
f32 and break ties to the lowest index (unlike the reference's own test,
which holds ``knn_pallas`` to the expanded-form ``ops.knn_point`` and so
compares distances). Clouds with duplicated points make exact ties. The
same indices must come from the plain versions of ``fps_batched`` and
``knn_gather`` (rows 1 and 2 of the kernel table), and ``knn_single``
refuses by name the query counts ``knn_pallas`` asserts on.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppt_tpu.kernels import fps_pallas, knn_pallas
from ppt_torch.kernels import fps as kfps
from ppt_torch.kernels import group as kgroup
from ppt_torch.kernels import knn as kknn


def cloud(b, n, seed, dup=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, n, 3).astype(np.float32)
    if dup:  # every fourth point repeats another: exact distance ties
        src = rng.randint(0, n, size=n // 4)
        x[:, 3::4][:, : src.size] = x[:, src]
    return x


# the reference test's shapes (tests/test_pallas_kernels.py:16, :26), plus ties
@pytest.mark.parametrize("b,n,npoint,dup", [(2, 128, 16, False), (1, 300, 32, False),
                                            (3, 1024, 128, False), (2, 130, 64, False),
                                            (2, 300, 64, True)])
def test_fps_single_matches_fps_pallas(b, n, npoint, dup):
    x = cloud(b, n, n + npoint, dup)
    want = np.asarray(fps_pallas(jnp.asarray(x), npoint, interpret=True))
    got = kfps.fps_single(torch.from_numpy(x), npoint)
    assert got.dtype == torch.int32 and tuple(got.shape) == (b, npoint)
    np.testing.assert_array_equal(got.numpy(), want)
    # the batched kernel's plain version takes the same recurrence
    assert torch.equal(got, kgroup.fps_plain(torch.from_numpy(x), npoint))


def test_fps_single_takes_any_float_type():
    x = cloud(2, 200, 7)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = np.asarray(fps_pallas(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), 24,
                                 interpret=True))
    np.testing.assert_array_equal(kfps.fps_single(xb, 24).numpy(), want)


# the reference test's shapes (tests/test_pallas_kernels.py:27), plus S = 8 and
# 256 (two query tiles), k = 1 and 32, and ties; then the kernel's cloud chunk:
# N just under, at and over it (ties across its border), k = 64 (the queue's
# two pairs a lane), k past 64 (passes over the cloud) and N = k
CHUNK = kknn.CHUNK


@pytest.mark.parametrize("b,n,s,k,dup", [(2, 256, 128, 8, False), (1, 200, 128, 4, False),
                                         (2, 300, 8, 1, True), (1, 300, 256, 32, True),
                                         (2, 300, 128, 8, True), (1, CHUNK - 1, 128, 64, True),
                                         (1, CHUNK, 128, 32, True), (1, CHUNK + 1, 128, 40, True),
                                         (1, 300, 128, 100, True), (2, 48, 8, 48, True)])
def test_knn_single_matches_knn_pallas(b, n, s, k, dup):
    x = cloud(b, n, n + s + k, dup)
    q = cloud(b, s, n + s + k + 1)
    if dup:  # queries on cloud points: zero distances and ties among the duplicates
        q[:, ::2] = x[:, : (s + 1) // 2]
    if n > CHUNK:  # a tie across the border: the first chunk's last point opens the next
        x[:, CHUNK] = x[:, CHUNK - 1]
        q[:, 1] = x[:, CHUNK]
    want = np.asarray(knn_pallas(k, jnp.asarray(x), jnp.asarray(q), interpret=True))
    got = kknn.knn_single(k, torch.from_numpy(x), torch.from_numpy(q))
    assert got.dtype == torch.int32 and tuple(got.shape) == (b, s, k)
    np.testing.assert_array_equal(got.numpy(), want)
    # knn_gather's plain version picks the same neighbours in the same order
    idx, _ = kgroup.knn_gather_plain(k, torch.from_numpy(x), torch.from_numpy(q))
    assert torch.equal(got, idx)


def test_knn_single_self_query():
    x = cloud(1, 128, 3)
    got = kknn.knn_single(3, torch.from_numpy(x), torch.from_numpy(x))
    np.testing.assert_array_equal(got[0, :, 0].numpy(), np.arange(128))


@pytest.mark.parametrize("s", [200, 130])
def test_knn_single_refuses_what_knn_pallas_asserts(s):
    x, q = torch.from_numpy(cloud(1, 256, 0)), torch.from_numpy(cloud(1, s, 1))
    with pytest.raises(ValueError, match=rf"knn_single: S={s} must tile by 128"):
        kknn.knn_single(4, x, q)
    with pytest.raises(AssertionError, match=f"S={s} must tile by 128"):
        knn_pallas(4, jnp.asarray(x.numpy()), jnp.asarray(q.numpy()), interpret=True)


def test_knn_single_refuses_k_past_n():
    x, q = torch.from_numpy(cloud(1, 16, 0)), torch.from_numpy(cloud(1, 8, 1))
    with pytest.raises(ValueError, match="knn_single: k=17"):
        kknn.knn_single(17, x, q)
