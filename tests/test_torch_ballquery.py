"""Port vs reference: the ball-query kernels' plain versions.

``ball_query_gather_plain`` / ``ball_query_gather_feats_plain`` (what the
wrappers run on CPU tensors, and what the three CUDA kernels are held to
on the card) against the JAX package's Pallas kernels in interpret mode
(the shipped extraction kernel, the feature-gathering kernel and the rank
kernel), on the same numpy inputs: indices and gathered features exact,
relative coordinates within 1e-6 (both sides subtract f32 coordinates; the
Pallas kernel rebuilds each coordinate from three bf16 parts, which is
exact up to the last bit). Against the expanded-form CPU oracle
``ops.query_ball_point`` the indices are compared on clouds whose squared
distances keep a margin of 1e-5 from ``radius**2``, far above the 1e-7
rounding of either form on unit-cube coordinates.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ppt_tpu import ops
from ppt_tpu.kernels import group as JG
from ppt_torch.kernels import _build
from ppt_torch.kernels import group as tg
from ppt_torch.ops import geometry as tgeo

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores

MARGIN = 1e-5


def _cloud(B, N, S, radius, seed):
    """A unit-cube cloud and FPS centres whose squared distances all stay
    MARGIN away from radius**2 (points that do not are nudged away)."""
    rng = np.random.RandomState(seed)
    xyz = rng.rand(B, N, 3).astype(np.float32)
    for _ in range(20):
        q_idx = np.asarray(ops.farthest_point_sample(jnp.asarray(xyz), S))
        q = np.take_along_axis(xyz, q_idx[..., None], axis=1)
        d = ((q[:, :, None, :].astype(np.float64) - xyz[:, None, :, :]) ** 2).sum(-1)
        close = np.abs(d - radius * radius) < MARGIN
        if not close.any():
            return xyz, q
        xyz[close.any(1)] += np.float32(0.01)
    raise AssertionError("no margin-kept cloud found")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("B,N,S,radius,K", [
    (2, 200, 16, 0.2, 8),    # N not a multiple of 32
    (2, 200, 16, 0.05, 7),   # short rows, odd nsample
    (1, 128, 32, 0.4, 33),   # nsample above a warp, odd
    (2, 96, 8, 2.0, 5),      # every point is a hit: the first K in index order
])
def test_ball_query_plain_matches_pallas_and_ops(B, N, S, radius, K):
    xyz, q = _cloud(B, N, S, radius, seed=N + K)
    idx, rel = tg.ball_query_gather(radius, K, _t(xyz), _t(q))
    want_idx, want_rel = JG.ball_query_gather(radius, K, jnp.asarray(xyz), jnp.asarray(q),
                                              interpret=True)
    assert idx.dtype == torch.int32 and rel.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(rel.numpy(), np.asarray(want_rel), rtol=0, atol=1e-6)
    # the expanded-form oracles, the reference's and the port's, on a margin-kept cloud
    want_ops = np.asarray(ops.query_ball_point(radius, K, jnp.asarray(xyz), jnp.asarray(q)))
    np.testing.assert_array_equal(idx.numpy(), want_ops)
    np.testing.assert_array_equal(
        tgeo.query_ball_point(radius, K, _t(xyz), _t(q)).numpy(), want_ops)
    # ascending picks, then the first hit repeated
    first = idx[..., :1].numpy()
    assert np.all((np.diff(idx.numpy(), axis=-1) > 0) | (idx.numpy()[..., 1:] == first))
    rows = np.arange(B)[:, None, None]
    np.testing.assert_array_equal(rel.numpy(), xyz[rows, idx.numpy()] - q[:, :, None, :])


def test_query_with_no_hit_gives_the_last_point():
    rng = np.random.RandomState(1)
    xyz = (rng.rand(1, 100, 3) * 100).astype(np.float32)
    q = np.full((1, 8, 3), -1e3, np.float32)
    q[0, 5] = xyz[0, 17]  # one query that does hit, itself only
    idx, rel = tg.ball_query_gather(0.01, 4, _t(xyz), _t(q))
    want_idx, want_rel = JG.ball_query_gather(0.01, 4, jnp.asarray(xyz), jnp.asarray(q),
                                              interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    assert (idx[0, [0, 1, 2, 3, 4, 6, 7]] == 99).all() and (idx[0, 5] == 17).all()
    # the coordinates are the last point's minus the centre, not zeros
    np.testing.assert_array_equal(rel[0, 0, 0].numpy(), xyz[0, 99] - q[0, 0])
    np.testing.assert_allclose(rel.numpy(), np.asarray(want_rel), rtol=0, atol=1e-3)  # |x| ~ 1e3


def test_short_rows_pad_with_the_first_hit():
    xyz = np.zeros((1, 40, 3), np.float32)
    xyz[0, :, 0] = np.arange(40)  # points on a line, 1 apart
    q = np.zeros((1, 8, 3), np.float32)  # the Pallas tile wants 8 queries
    q[0, 0, 0] = 10.2
    idx, rel = tg.ball_query_gather(1.5, 5, _t(xyz), _t(q))
    np.testing.assert_array_equal(idx[0, 0].numpy(), [9, 10, 11, 9, 9])
    np.testing.assert_array_equal(idx[0, 1].numpy(), [0, 1, 0, 0, 0])
    np.testing.assert_allclose(rel[0, 0, :, 0].numpy(), [-1.2, -0.2, 0.8, -1.2, -1.2], atol=1e-6)
    want_idx, _ = JG.ball_query_gather(1.5, 5, jnp.asarray(xyz), jnp.asarray(q), interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))


def test_the_boundary_follows_the_kernel_form():
    """A point at distance exactly ``radius`` is a hit: the test is
    ``d <= f32(radius * radius)`` on the exact-difference distance."""
    xyz = np.array([[[0.0, 0, 0], [0.5, 0, 0], [0.5000001, 0, 0], [3.0, 0, 0]]], np.float32)
    q = np.zeros((1, 8, 3), np.float32)  # the Pallas tile wants 8 queries
    idx, _ = tg.ball_query_gather(0.5, 4, _t(xyz), _t(q))
    want_idx, _ = JG.ball_query_gather(0.5, 4, jnp.asarray(xyz), jnp.asarray(q), interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(idx[0, 0].numpy(), [0, 1, 0, 0])


@pytest.mark.parametrize("dtype,F", [("bfloat16", 32), ("float32", 6)])
def test_ball_query_feats_plain_matches_pallas(dtype, F):
    B, N, S, radius, K = 2, 160, 16, 0.25, 9
    xyz, q = _cloud(B, N, S, radius, seed=F)
    feats = np.random.RandomState(F).randn(B, N, F).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    idx, rel, fj = tg.ball_query_gather_feats(radius, K, _t(xyz), _t(q), _t(feats).to(tdt))
    # the Pallas kernel gathers through a bf16 product: feed it bf16-exact features
    want_idx, want_rel, want_fj = JG.ball_query_gather_feats(
        radius, K, jnp.asarray(xyz), jnp.asarray(q),
        jnp.asarray(feats).astype(jnp.bfloat16).astype(jdt), interpret=True)
    assert fj.dtype == tdt and fj.shape == (B, S, K, F)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(rel.numpy(), np.asarray(want_rel), rtol=0, atol=1e-6)
    got = tg.ball_query_gather_feats(radius, K, _t(xyz), _t(q),
                                     _t(feats).bfloat16().to(tdt))[2]
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want_fj.astype(jnp.float32)))
    # f32 features are copied exactly too (the copy has no bf16 gate)
    np.testing.assert_array_equal(
        fj.float().numpy(),
        _t(feats).to(tdt).float().numpy()[np.arange(B)[:, None, None], idx.numpy()])
    # the plain pair agrees with itself
    i2, r2 = tg.ball_query_gather(radius, K, _t(xyz), _t(q))
    assert torch.equal(i2, idx) and torch.equal(r2, rel)


def test_v2_rank_kernel_and_plain_agree():
    """The reference's rank kernel (called by nothing there, pinned by its
    own test to the shipped kernel), interpreted, against the port's plain
    version; ``ball_query_gather_v2`` on the CPU is that plain version."""
    B, N, S, K_, radius = 2, 256, 16, 8, 0.3
    rng = np.random.RandomState(5)
    xyz = rng.rand(B, N, 3).astype(np.float32)
    q = rng.rand(B, S, 3).astype(np.float32)
    xyz_t = jnp.swapaxes(jnp.asarray(xyz), 1, 2)
    out_spec = pl.BlockSpec((1, S, K_), lambda b: (b, 0, 0), memory_space=pltpu.VMEM)
    fshape = jax.ShapeDtypeStruct((B, S, K_), jnp.float32)
    idx, nx, ny, nz = pl.pallas_call(
        functools.partial(JG._ball_query_kernel_v2, K_, radius, N, True),
        grid=(B,),
        in_specs=[
            pl.BlockSpec((1, S, 3), lambda b: (b, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, 3, N), lambda b: (b, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, N, 9), lambda b: (b, 0, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=(out_spec, out_spec, out_spec, out_spec),
        out_shape=(jax.ShapeDtypeStruct((B, S, K_), jnp.int32), fshape, fshape, fshape),
        scratch_shapes=[pltpu.VMEM((S, N), jnp.float32)],
        interpret=True,
    )(jnp.asarray(q), xyz_t, JG._bf16x3_parts(jnp.swapaxes(xyz_t, 1, 2)))
    got_idx, got_rel = tg.ball_query_gather_v2(radius, K_, _t(xyz), _t(q))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(idx))
    want_rel = np.stack([np.asarray(nx), np.asarray(ny), np.asarray(nz)], -1)
    np.testing.assert_allclose(got_rel.numpy(), want_rel, rtol=0, atol=1e-6)
    v1_idx, v1_rel = tg.ball_query_gather(radius, K_, _t(xyz), _t(q))
    assert torch.equal(got_idx, v1_idx) and torch.equal(got_rel, v1_rel)


def test_fj_gradient_matches_jax_grad_of_the_cpu_path():
    """``fj`` carries the gather's gradient to ``feats`` (a scatter-add),
    compared with ``jax.grad`` through the reference's CPU path
    (``query_ball_point`` + ``index_points``); 1e-6: the sums add at most
    a handful of f32 cotangents per row."""
    B, N, S, radius, K, F = 2, 96, 12, 0.3, 6, 5
    xyz, q = _cloud(B, N, S, radius, seed=9)
    rng = np.random.RandomState(9)
    feats = rng.randn(B, N, F).astype(np.float32)
    cot = rng.randn(B, S, K, F).astype(np.float32)

    def loss(f):
        idx = ops.query_ball_point(radius, K, jnp.asarray(xyz), jnp.asarray(q))
        return jnp.sum(ops.index_points(f, idx) * cot)

    want = np.asarray(jax.grad(loss)(jnp.asarray(feats)))
    f = _t(feats).requires_grad_(True)
    before = dict(_build.LAUNCHES)
    idx, rel, fj = tg.ball_query_gather_feats(radius, K, _t(xyz), _t(q), f)
    assert fj.requires_grad and not idx.requires_grad and not rel.requires_grad
    (fj * _t(cot)).sum().backward()
    np.testing.assert_allclose(f.grad.numpy(), want, rtol=0, atol=1e-6)
    assert dict(_build.LAUNCHES) == before  # a CPU tensor launches nothing


def test_wrappers_refuse_what_the_kernels_do_not_take():
    xyz = torch.rand(1, 16, 3)
    with pytest.raises(ValueError, match="nsample"):
        tg._ball_args("ball_query_gather", 17, xyz, xyz[:, :2])
    with pytest.raises(ValueError, match=r"\[B, N, 3\]"):
        tg._ball_args("ball_query_gather", 4, torch.rand(1, 16, 4), xyz[:, :2])
    # no reference option survives that selects a schedule or absolute coordinates
    import inspect

    for fn in (tg.ball_query_gather, tg.ball_query_gather_feats, tg.ball_query_gather_v2):
        assert not {"mode", "relative", "interpret"} & set(inspect.signature(fn).parameters)
