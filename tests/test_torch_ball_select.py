"""Port vs reference at the edges of the ball-query walk (csrc/ball_select.cuh).

The CUDA kernels ``ball_query_kernel`` and ``ball_query_feats_kernel`` stage
the cloud in chunks of ``BALL_CHUNK`` points, test ``BALL_ROUND`` points a
warp a round (4 a lane), keep a warp's picks in a ring of 256 slots written
out 128 at a time, and serve tiles of 8 to 32 queries a CTA. On the card
``chip_smoke.py`` holds them to ``ball_query_gather_plain`` /
``ball_query_gather_feats_plain`` bit for bit; here those plain versions are
held to the JAX package's Pallas kernels in interpret mode on numpy inputs
made from a seed, at clouds built to put hits on those edges. Indices and
gathered features are exact; ``rel`` within 1e-6, because the Pallas kernel
rebuilds each coordinate from three bf16 parts (exact up to the last bit).
The placed clouds keep every squared distance far from ``radius**2``; the
lattice clouds put points at exactly the radius, where both forms are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppt_tpu.kernels import group as JG
from ppt_torch.kernels import group as tg

R = tg.BALL_ROUND
C = tg.BALL_CHUNK


def _placed(N, hits, radius, seed):
    """A cloud of N points far from every query but for ``hits[s]``, the
    indices placed inside query s's ball (less than half the radius from
    its centre); the centres lie 4 radii apart. Returns (xyz [1, N, 3], q [1, S, 3])."""
    rng = np.random.RandomState(seed)
    S = len(hits)
    q = np.zeros((1, S, 3), np.float32)
    q[0, :, 0] = 4 * radius * np.arange(S)
    xyz = (100 + rng.rand(1, N, 3)).astype(np.float32)
    for s, idx in enumerate(hits):
        off = rng.uniform(-0.25, 0.25, (len(idx), 3)) * radius
        xyz[0, list(idx)] = q[0, s] + off.astype(np.float32)
    return xyz, q


def _lattice(B, N, S, seed):
    """Points and centres on the 1/64 lattice of [0, 1/4): every squared
    distance is exact in f32, and many equal the radii below (4/64, 6/64)
    exactly."""
    rng = np.random.RandomState(seed)
    xyz = (rng.randint(0, 16, (B, N, 3)) / 64).astype(np.float32)
    q = xyz[:, rng.choice(N, S, replace=False)].copy()
    return xyz, q


def _t(a):
    return torch.from_numpy(np.array(a))


def _vs_pallas(radius, nsample, xyz, q):
    idx, rel = tg.ball_query_gather_plain(radius, nsample, _t(xyz), _t(q))
    want_idx, want_rel = JG.ball_query_gather(radius, nsample, jnp.asarray(xyz), jnp.asarray(q),
                                              interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(rel.numpy(), np.asarray(want_rel), rtol=0, atol=1e-6)
    return idx.numpy()


# each query's hits (disjoint sets), placed across the walk's edges: a round
# (128 points), a staging chunk (BALL_CHUNK), the nsample-th hit on a round's
# last lane (index 255: lane 31's fourth point of round 1), an empty ball
EDGE_HITS = [
    [R - 2, R - 1, R, R + 1],                     # straddles round 0 / round 1
    [C - 2, C - 1, C, C + 1],                     # straddles chunk 0 / chunk 1
    [R - 3, C + 2],                               # one hit each side: a padded row
    [R + 2, 200, 2 * R - 1, 2 * R, 3 * R - 1],    # full at 255 when nsample = 3
    [],                                           # empty ball: N - 1
    [0, C + 99],                                  # the first and the last point
    [C + 98],                                     # a single hit
    list(range(4 * R - 4, 4 * R + 4)) + [C + 50],  # 8 hits across a round, one past the chunk
]


@pytest.mark.parametrize("nsample", [1, 3, 4, 33])
def test_hits_across_rounds_and_chunks(nsample):
    N = C + 100  # two staging chunks, N not a multiple of 32 or of a round
    xyz, q = _placed(N, EDGE_HITS, 0.05, seed=nsample)
    idx = _vs_pallas(0.05, nsample, xyz, q)
    for s, hits in enumerate(EDGE_HITS):
        want = sorted(hits)[:nsample] if hits else [N - 1]
        want = want + [want[0]] * (nsample - len(want))
        np.testing.assert_array_equal(idx[0, s], want)


@pytest.mark.parametrize("N,nsample,S", [
    (200, 1, 40),     # N not a multiple of 32 or of a round; S ragged against a 32-query tile
    (200, 33, 40),    # nsample past a warp, odd
    (200, 128, 8),    # nsample = one flush of the ring
    (200, 200, 8),    # nsample == N
    (300, 300, 8),    # nsample == N past the ring's 256 slots: written out part way
    (129, 129, 24),   # one point past a round, taken whole
])
def test_nsample_and_ragged_shapes(N, nsample, S):
    xyz, q = _lattice(2, N, S, seed=N + nsample)
    for radius in (4 / 64, 6 / 64):  # both hit lattice distances exactly
        idx = _vs_pallas(radius, nsample, xyz, q)
        d = ((q[:, :, None, :] - xyz[:, None, :, :]) ** 2).sum(-1)
        assert (d == np.float32(radius * radius)).any()  # points at exactly the radius
        assert (idx[:, :, 0] == np.argmax(d <= np.float32(radius * radius), -1)).all()


def test_ball_filling_at_a_rounds_last_lane():
    """The third hit is point 127, the last of round 0: the walk stops there
    and round 1's hits (128, 255) are never taken."""
    hits = [[3, 60, R - 1, R, 2 * R - 1]] + [[]] * 7
    xyz, q = _placed(2 * R + 5, hits, 0.1, seed=3)
    idx = _vs_pallas(0.1, 3, xyz, q)
    np.testing.assert_array_equal(idx[0, 0], [3, 60, R - 1])


def test_empty_ball_gives_the_last_point_and_its_coordinates():
    xyz, q = _placed(R + 7, [[]] * 8, 0.1, seed=4)
    idx, rel = tg.ball_query_gather_plain(0.1, 5, _t(xyz), _t(q))
    _vs_pallas(0.1, 5, xyz, q)
    assert (idx.numpy() == R + 6).all()
    np.testing.assert_array_equal(rel.numpy()[0, 2, 4], xyz[0, R + 6] - q[0, 2])


# (torch dtype, F): feature rows of 2, 10, 24, 64 and 512 bytes
@pytest.mark.parametrize("dtype,F", [("bfloat16", 1), ("bfloat16", 5), ("float32", 6),
                                     ("bfloat16", 32), ("float32", 128)])
def test_feature_rows_of_every_copy_unit(dtype, F):
    B, N, S, radius, nsample = 2, 200, 16, 6 / 64, 33
    xyz, q = _lattice(B, N, S, seed=F)
    # the Pallas kernel gathers through a bf16 product: bf16-exact features
    feats = np.asarray(jnp.asarray(np.random.RandomState(F).randn(B, N, F).astype(np.float32))
                       .astype(jnp.bfloat16).astype(jnp.float32))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    idx, rel, fj = tg.ball_query_gather_feats_plain(radius, nsample, _t(xyz), _t(q),
                                                    _t(feats).to(tdt))
    want_idx, want_rel, want_fj = JG.ball_query_gather_feats(
        radius, nsample, jnp.asarray(xyz), jnp.asarray(q), jnp.asarray(feats).astype(jdt),
        interpret=True)
    assert fj.dtype == tdt and fj.shape == (B, S, nsample, F)
    assert F * fj.element_size() in (2, 10, 24, 64, 512)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(rel.numpy(), np.asarray(want_rel), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(fj.float().numpy(), np.asarray(want_fj.astype(jnp.float32)))


def test_feature_rows_across_a_chunk():
    """The feature kernel's picks come from the ring across a chunk's edge."""
    xyz, q = _placed(C + 100, EDGE_HITS, 0.05, seed=11)
    feats = np.asarray(jnp.asarray(np.random.RandomState(11).randn(1, C + 100, 8)
                                   .astype(np.float32)).astype(jnp.bfloat16).astype(jnp.float32))
    idx, rel, fj = tg.ball_query_gather_feats_plain(0.05, 4, _t(xyz), _t(q),
                                                    _t(feats).bfloat16())
    want_idx, _, want_fj = JG.ball_query_gather_feats(
        0.05, 4, jnp.asarray(xyz), jnp.asarray(q), jnp.asarray(feats).astype(jnp.bfloat16),
        interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(fj.float().numpy(), np.asarray(want_fj.astype(jnp.float32)))


@pytest.mark.parametrize("B,S,qw", [(128, 512, 4), (128, 128, 4), (128, 64, 2), (32, 512, 4),
                                    (32, 128, 1), (1, 37, 1)])
def test_ball_plan_keeps_two_ctas_an_sm(B, S, qw):
    """Queries a warp: 4 where the grid keeps 2 CTAs of 8 warps on each of
    an H100's 132 SMs, fewer where it would not; stages of BALL_CHUNK points,
    a whole number of rounds."""
    assert tg._ball_plan(B, S) == (qw, C)
    assert C % R == 0


def test_group_entry_points_have_their_argument_types():
    """Every ``csrc/group.cu`` entry point the wrappers call has its ctypes
    argument types, set once when the library loads (``_lib``), with one
    type per C parameter: an untyped pointer would be cut to 32 bits."""
    import inspect
    import re
    from pathlib import Path

    src = inspect.getsource(tg)
    called = set(re.findall(r"lib\.(ppt_\w+)\(", src))
    assert called <= set(tg._ARGTYPES), called - set(tg._ARGTYPES)
    assert src.count(".argtypes") == 1  # in _lib alone
    cu = (Path(tg.__file__).resolve().parent.parent / "csrc" / "group.cu").read_text()
    exported = {m.group(1): m.group(2) for m in
                re.finditer(r"PPT_EXPORT int (ppt_\w+)\(([^)]*)\)", cu)}
    for name, types in tg._ARGTYPES.items():
        assert len(exported[name].split(",")) == len(types), name
