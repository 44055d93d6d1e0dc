"""The 3-D loss kernels' plans and orders, as far as the CPU can hold them.

- ``auction_plain`` in the warp kernel's summation order (every sum four
  partial sums in index order, then paired) against the reference's XLA
  ``approx_match`` and ``approx_match_pallas`` interpreted, at the dVAE's
  8 x 32 and 32 x 32
  with B = 64 and at N or M of 1, 31, 32 and 33 around the warp kernel's
  limit: rtol 1e-3, atol 1e-4, as ``tests/test_emd_kernel.py`` holds those
  two to each other, but atol 4e-3 where both sides have 31 points or
  more: there the auction is ill-conditioned at B = 64 (a row whose bids
  nearly vanish), and the reference's own XLA and Pallas auctions differ
  by up to 3.69e-3 at 64 x 32 x 32 over 8 seeds (the port's plain version
  from either, 3.65e-3, in the warp order and in the block order alike);
  mass conservation in that order;
- the shape rule (``warp_auction``) that the wrapper launches by and the
  plain version sums by, and each summation order on values where order
  shows;
- ``nn_dists``'s plan (queries a thread, the support split) at its edges, and
  the kernel's range arithmetic (``csrc/losses3d.cu:nn_dists_kernel``)
  replayed in integers: every query's cloud is scanned once, whatever the
  split;
- every ``csrc/losses3d.cu`` entry point typed once, one ctypes type per C
  parameter.
"""

import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppt_torch.kernels import _build, _losses3d
from ppt_torch.kernels import chamfer as kchamfer
from ppt_torch.kernels import emd as kemd

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores

CU = (Path(kemd.__file__).resolve().parent.parent / "csrc" / "losses3d.cu").read_text()


def clouds(b, n, m, seed=0):
    rng = np.random.RandomState(seed)
    return rng.rand(b, n, 3).astype(np.float32), rng.rand(b, m, 3).astype(np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("n,m", [(8, 32), (32, 32), (1, 32), (32, 1), (31, 32), (32, 31),
                                 (33, 32), (32, 33)])
def test_auction_plain_in_the_warp_order_matches_the_reference(n, m):
    from ppt_tpu.kernels.emd import approx_match_pallas
    from ppt_tpu.ops.losses3d import approx_match

    x1, x2 = clouds(64, n, m, seed=n * 40 + m)
    want = np.asarray(approx_match(jnp.asarray(x1), jnp.asarray(x2)))
    want_pallas = np.asarray(approx_match_pallas(jnp.asarray(x1), jnp.asarray(x2),
                                                 interpret=True))
    got = kemd.approx_match_plain(t(x1), t(x2))
    assert got.shape == (64, n, m) and got.dtype == torch.float32
    atol = 4e-3 if min(n, m) >= 31 else 1e-4
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=atol)
    np.testing.assert_allclose(got.numpy(), want_pallas, rtol=1e-3, atol=atol)


def test_the_bound_at_b64_is_the_references_own_spread():
    """Where the 4e-3 bound comes from: over 8 seeds of 64 clouds of 32 x 32
    points the reference's XLA and Pallas auctions differ by more than
    rtol 1e-3 / atol 1e-4 allow (up to 3.69e-3), and the port's plain
    version lies within 4e-3 of both."""
    from ppt_tpu.kernels.emd import approx_match_pallas
    from ppt_tpu.ops.losses3d import approx_match

    spread, port = 0.0, 0.0
    over = False
    for seed in range(100, 108):
        x1, x2 = clouds(64, 32, 32, seed=seed)
        want = np.asarray(approx_match(jnp.asarray(x1), jnp.asarray(x2)))
        want_pallas = np.asarray(approx_match_pallas(jnp.asarray(x1), jnp.asarray(x2),
                                                     interpret=True))
        got = kemd.approx_match_plain(t(x1), t(x2)).numpy()
        over |= bool((np.abs(want - want_pallas) > 1e-4 + 1e-3 * np.abs(want_pallas)).any())
        spread = max(spread, float(np.abs(want - want_pallas).max()))
        port = max(port, float(np.abs(got - want).max()), float(np.abs(got - want_pallas).max()))
    assert over and 3e-3 < spread < 4e-3
    assert port < 4e-3


@pytest.mark.parametrize("n,m", [(8, 32), (32, 32), (32, 8)])
def test_warp_order_conserves_mass(n, m):
    """Supplies and capacities balance at these shapes (n multi_l = m
    multi_r): every left point ships its supply multi_l and every right
    point takes its multi_r, within 1e-3 of a unit."""
    x1, x2 = clouds(64, n, m, seed=3)
    match = kemd.approx_match_plain(t(x1), t(x2))
    multi_l, multi_r = kemd.supplies(n, m)
    assert n * multi_l == m * multi_r
    np.testing.assert_allclose(match.sum(2).numpy(), multi_l, atol=1e-3)
    np.testing.assert_allclose(match.sum(1).numpy(), multi_r, atol=1e-3)


def test_warp_auction_is_the_shape_rule(monkeypatch):
    """Both sides up to WARP_MAX take the warp kernel and its sequential row
    sums; one point more on either side takes the block kernel's lane and
    butterfly order."""
    assert kemd.WARP_MAX == int(re.search(r"constexpr int kAmWarpMax = (\d+);", CU).group(1))
    for n, m, warp in [(1, 1, True), (8, 32, True), (32, 32, True), (32, 8, True),
                       (33, 32, False), (32, 33, False), (1, 33, False), (4096, 1, False)]:
        assert kemd.warp_auction(n, m) is warp, (n, m)
    calls = []
    block_sum = kemd._row_sum
    monkeypatch.setattr(kemd, "_row_sum", lambda x: calls.append(x.shape) or block_sum(x))
    for n, m in [(32, 32), (8, 32), (32, 1)]:
        kemd.auction_plain(torch.rand(2, n, m), *kemd.supplies(n, m))
    assert calls == []
    kemd.auction_plain(torch.rand(2, 33, 32), *kemd.supplies(33, 32))
    assert len(calls) == 2 * len(kemd.LEVELS)


def _np_seq(v):
    s = np.float32(0.0)
    for x in v:
        s = np.float32(s + x)
    return s


def _np_sum4(v):
    s = [_np_seq(v[j::4]) for j in range(4)]
    return np.float32(np.float32(s[0] + s[1]) + np.float32(s[2] + s[3]))


def _np_lanes(v):
    lanes = np.zeros(32, np.float32)
    for i, x in enumerate(v):
        lanes[i % 32] = np.float32(lanes[i % 32] + x)
    for o in (16, 8, 4, 2, 1):
        lanes = (lanes + lanes[np.arange(32) ^ o]).astype(np.float32)
    return lanes[0]


@pytest.mark.parametrize("m", [1, 3, 31, 32, 33, 70])
def test_each_summation_order_is_the_kernels(m):
    """Values spread over 16 orders of magnitude, so that the order shows:
    ``_sum4`` (the warp kernel's) adds four partial sums in index order and
    pairs them, ``_seq_sum`` (the block kernel's columns) adds in index
    order, ``_row_sum`` (its rows) in 32 lanes then a butterfly; the three
    differ here."""
    rng = np.random.RandomState(m)
    v = (rng.rand(5, m) * 10.0 ** rng.randint(-8, 8, (5, m))).astype(np.float32)
    four = kemd._sum4(t(v), -1).numpy()
    seq = kemd._seq_sum(t(v), -1).numpy()
    lanes = kemd._row_sum(t(v)).numpy()
    for i in range(5):
        assert four[i] == _np_sum4(v[i]) and seq[i] == _np_seq(v[i])
        assert lanes[i] == _np_lanes(v[i])
    assert np.array_equal(kemd._sum4(t(v.T), 0).numpy(), four)
    assert np.array_equal(kemd._seq_sum(t(v.T), 0).numpy(), seq)
    if m >= 32:
        assert not np.array_equal(four, seq) and not np.array_equal(seq, lanes)


def test_the_nn_constants_are_the_kernels():
    for name, value in [("kNnThreads", kchamfer.THREADS), ("kNnMaxSplit", kchamfer.MAX_SPLIT),
                        ("kNnMaxQ", max(kchamfer.QUERIES))]:
        assert int(re.search(rf"constexpr int {name} = (\d+);", CU).group(1)) == value
    # nn_instance's cases: 1, 2 and kNnMaxQ
    assert set(kchamfer.QUERIES) == {1, 2, max(kchamfer.QUERIES)}
    assert all(f"return nn_dists_kernel<{q}>;" in CU for q in (1, 2, "kNnMaxQ"))


@pytest.mark.parametrize("B,N,Q,blocks", [(1, 1, 1, 1), (128, 1, 1, 1), (129, 1, 1, 2),
                                          (128, 4, 4, 1), (129, 4, 4, 2), (128, 8, 4, 2),
                                          (16, 33, 4, 2), (1, 1025, 4, 3), (4096, 32, 2, 512),
                                          (4096, 8, 2, 128), (4, 16384, 4, 128), (8, 2048, 2, 64)])
def test_nn_blocks_counts_query_groups(B, N, Q, blocks):
    assert kchamfer.nn_blocks(B, N, Q) == blocks


@pytest.mark.parametrize("shapes,plan", [
    ([(4096, 8, 32), (4096, 32, 8)], (2, 1)),          # the dVAE's coarse clouds, both ways
    ([(4096, 32, 32), (4096, 32, 32)], (2, 1)),        # and its fine ones
    ([(8, 2048, 2048), (8, 2048, 2048)], (2, 8)),      # kernel_check's shape
    ([(4, 16384, 16384), (4, 16384, 16384)], (4, 8)),  # 256 blocks of 4 queries a thread
    ([(3, 1001, 777), (3, 777, 1001)], (1, 8)),        # no grid reaches the target
    ([(5, 37, 1), (5, 1, 37)], (1, 1)),                # M = 1 splits nothing
    ([(1, 100, 127)], (1, 1)),                         # under two chunks of MIN_CHUNK
    ([(1, 100, 128)], (1, 2)),
    ([(1, 100, 511)], (1, 4)),
    ([(1, 100, 512)], (1, 8)),                         # MAX_SPLIT
    ([(1, 100, 4096), (1, 4096, 100)], (1, 1)),        # the smaller M bounds both directions
    ([(1, 100, 4096), (0, 4096, 100)], (1, 8)),        # a direction with no queries counts for nothing
    ([(528 * 128, 4, 8)], (4, 1)),                     # 528 blocks reach the target unsplit
    ([(527 * 128, 4, 8)], (2, 1)),                     # 527 do not: 1054 of two queries a thread
    ([(66 * 32, 16, 512)], (4, 8)),                    # 66 blocks split 8 ways reach it
    ([(65 * 32, 16, 512)], (2, 8)),                    # 65 do not
])
def test_nn_plan_at_its_edges(shapes, plan):
    assert kchamfer.nn_plan(shapes) == plan


def test_nn_plan_stays_within_its_limits():
    for shapes in ([(1, 8, 64)], [(2, 300, 5000)], [(8, 2048, 2048)], [(64, 1024, 600)],
                   [(4096, 32, 32), (4096, 32, 32)], [(3, 5, 2000), (3, 2000, 5)]):
        queries, split = kchamfer.nn_plan(shapes)
        assert queries in kchamfer.QUERIES
        assert 1 <= split <= kchamfer.MAX_SPLIT and split & (split - 1) == 0
        assert split == 1 or all(M >= split * kchamfer.MIN_CHUNK for _, _, M in shapes)


def _scanned(B, N, M, Q, split):
    """How often each (query group, support point) pair is scanned, replaying
    ``nn_dists_kernel``'s range arithmetic for every CTA (x, y) and thread:
    its cloud's range [b M, b M + M) cut by the CTA's chunk of the block's
    range. Returns [groups total, B * M] counts."""
    T = kchamfer.THREADS
    groups = -(-N // Q)
    total = B * groups
    seen = np.zeros((total, B * M), np.int32)
    for bx in range(kchamfer.nn_blocks(B, N, Q)):
        g0 = bx * T
        g_last = min(g0 + T, total) - 1
        s_begin, s_end = (g0 // groups) * M, (g_last // groups + 1) * M
        chunk = -(-(s_end - s_begin) // split)
        for y in range(split):
            c_begin = min(s_end, s_begin + y * chunk)
            c_end = min(s_end, c_begin + chunk)
            for gid in range(g0, g_last + 1):
                b = gid // groups
                lo, hi = max(b * M, c_begin), min(b * M + M, c_end)
                if lo < hi:
                    seen[gid, lo:hi] += 1
    return seen


@pytest.mark.parametrize("B,N,M,Q,split", [(3, 37, 300, 4, 1), (3, 37, 300, 4, 2),
                                           (3, 37, 301, 2, 8), (200, 8, 5, 1, 1),
                                           (200, 8, 5, 4, 8), (40, 33, 1, 4, 4),
                                           (1, 1030, 2049, 4, 8), (2, 7, 3, 2, 3),
                                           (300, 3, 70, 1, 2)])
def test_nn_kernel_ranges_scan_each_cloud_once(B, N, M, Q, split):
    """Ragged N and M (not multiples of the query group, the block or the
    chunk), M = 1, more chunks than points: every query group scans each
    point of its own cloud exactly once and no other cloud's."""
    seen = _scanned(B, N, M, Q, split)
    groups = -(-N // Q)
    want = np.zeros_like(seen)
    for gid in range(B * groups):
        b = gid // groups
        want[gid, b * M:(b + 1) * M] = 1
    assert np.array_equal(seen, want)


def test_nn_dists_both_on_the_cpu_is_the_plain_version_both_ways():
    _build.reset_launches()
    a, b = clouds(3, 37, 20, seed=9)
    d1, d2 = kchamfer.nn_dists_both(t(a), t(b))
    assert torch.equal(d1, kchamfer.nn_dists_plain(t(a), t(b)))
    assert torch.equal(d2, kchamfer.nn_dists_plain(t(b), t(a)))
    assert sum(_build.LAUNCHES.values()) == 0


def test_losses3d_entry_points_have_their_argument_types():
    """Every ``csrc/losses3d.cu`` entry point has its ctypes argument types,
    set once when the library loads (``_losses3d.lib``), one type per C
    parameter; the wrappers call only typed ones."""
    exported = {m.group(1): m.group(2) for m in
                re.finditer(r"PPT_EXPORT int (ppt_\w+)\(([^)]*)\)", CU)}
    assert set(exported) == set(_losses3d._ARGTYPES)
    for name, types in _losses3d._ARGTYPES.items():
        assert len(exported[name].split(",")) == len(types), name
    assert inspect.getsource(_losses3d).count(".argtypes") == 1
    for module in (kchamfer, kemd):
        src = inspect.getsource(module)
        assert ".argtypes" not in src
        called = set(re.findall(r"lib\.(ppt_\w+)\(", src))
        assert called and called <= set(_losses3d._ARGTYPES), called
