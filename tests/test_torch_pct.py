"""Port vs reference: PCT (``LocalOp``, ``OffsetAttention``,
``_subsample_group``, ``Pct``).

Against ``ppt_tpu/nn/pct.py`` at full width, random weights carried across
by the weight bridge (``test_torch_classic.pair``), the same numpy inputs
through both; tolerances as ``test_torch_classic.py``. The clouds lie on
a 1/64 lattice (``test_torch_pointnet2.lattice_cloud``): every squared
distance in the expanded form is then exact in f32 in both packages, so
kNN orders its neighbours alike, ties to the lower index in both (on
uniform random clouds 2% of the queries swap two neighbours whose
distances differ in the last bit). FPS is the grouping kernel's wrapper
(``kernels/group.py:fps_batched``), here on its plain version: its indices
must be the plain FPS's and the reference's exactly. The trunk's training
mode runs 32 clouds: its head's BatchNorms normalise over the batch's
rows, and over 16 they magnify the other summation order to 3e-3 of the
output (6e-4 over 32, measured).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_classic import dts, eval_and_train, no_dropout, pair  # noqa: F401 (a fixture)
from test_torch_pointnet2 import lattice_cloud

from ppt_torch.kernels import group as kgroup
from ppt_torch.nn import pct as tpct
from ppt_torch.ops import geometry as ops

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_local_op_matches_flax(dtype):
    import ppt_tpu.nn.pct as jpct

    tdt, jdt = dts(dtype)
    x = np.random.RandomState(1).randn(16, 12, 8, 20).astype(np.float32)
    jmod = jpct.LocalOp(24, dtype=jdt)
    variables, tmod = pair(jmod, tpct.LocalOp(20, 24, dtype=tdt), x)
    got = eval_and_train(jmod, tmod, variables, [x], dtype)
    assert got.shape == (16, 12, 24) and got.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_offset_attention_matches_flax(dtype):
    import ppt_tpu.nn.pct as jpct

    tdt, jdt = dts(dtype)
    x = np.random.RandomState(2).randn(8, 40, 32).astype(np.float32)
    jmod = jpct.OffsetAttention(32, dtype=jdt)
    variables, tmod = pair(jmod, tpct.OffsetAttention(32, dtype=tdt), x)
    got = eval_and_train(jmod, tmod, variables, [x], dtype)
    assert got.shape == (8, 40, 32) and got.dtype == torch.float32
    assert not hasattr(tmod, "k_conv")  # q and k share one weight


def test_offset_attention_renormalises_by_column():
    """The row softmax divided by each column's sum plus 1e-9: every column
    of the map sums to 1 (to rounding), which ``scaled_dot_product_attention``
    would not give."""
    tmod = tpct.OffsetAttention(16)
    torch.manual_seed(0)
    with torch.no_grad():  # scores of order 1: no column's sum is near its 1e-9
        for p in tmod.parameters():
            p.normal_(std=0.1)
    x = torch.randn(2, 10, 16)
    maps = []
    real_bmm = torch.bmm

    def spy(a, b):
        if a.shape[-1] == a.shape[-2] == 10:
            maps.append(a)
        return real_bmm(a, b)

    torch.bmm = spy
    try:
        with torch.no_grad():
            tmod(x)
    finally:
        torch.bmm = real_bmm
    torch.testing.assert_close(maps[0].sum(1), torch.ones(2, 10), rtol=0, atol=1e-6)


@pytest.mark.parametrize("npoint,nsample", [(512, 32), (64, 8)])
def test_subsample_group_matches_flax(npoint, nsample, monkeypatch):
    """``[grouped - center, center]`` over FPS + kNN, and the FPS wrapper's
    indices equal to the plain FPS's and to the reference's."""
    from ppt_tpu.nn.pct import _subsample_group as jax_group
    from ppt_tpu.ops import geometry as jops

    xyz = lattice_cloud(3, 1024 if npoint == 512 else 200, 5)
    feats = np.random.RandomState(6).randn(*xyz.shape[:2], 7).astype(np.float32)
    calls = []
    real = kgroup.fps_batched
    monkeypatch.setattr(kgroup, "fps_batched", lambda x, n: calls.append((x, n)) or real(x, n))
    new_xyz, grouped = tpct._subsample_group(torch.from_numpy(xyz), torch.from_numpy(feats),
                                             npoint, nsample)
    want_xyz, want = jax_group(jnp.asarray(xyz), jnp.asarray(feats), npoint, nsample)
    assert len(calls) == 1 and calls[0][1] == npoint
    idx = real(*calls[0])
    assert torch.equal(idx, ops.farthest_point_sample(calls[0][0], npoint))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jops.farthest_point_sample(
        jnp.asarray(xyz), npoint)))
    np.testing.assert_array_equal(new_xyz.numpy(), np.asarray(want_xyz))
    assert grouped.shape == (3, npoint, nsample, 14)
    np.testing.assert_array_equal(grouped.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pct_matches_flax_and_runs_fps_twice(dtype, no_dropout, monkeypatch):
    """The whole trunk at full width on 32 clouds of 600 points (its FPS
    stages take 512 and 256), eval and (f32) training mode; FPS through the
    wrapper at 600 -> 512 and 512 -> 256."""
    import ppt_tpu.nn.pct as jpct

    tdt, jdt = dts(dtype)
    x = lattice_cloud(32, 600, 7)
    shapes = []
    real = kgroup.fps_batched
    monkeypatch.setattr(kgroup, "fps_batched",
                        lambda p, n: shapes.append((p.shape[1], n)) or real(p, n))
    jmod = jpct.Pct(dtype=jdt)
    variables, tmod = pair(jmod, tpct.Pct(dtype=tdt), x)
    got = eval_and_train(jmod, tmod, variables, [x], dtype)
    assert got.shape == (32, 256) and got.dtype == torch.float32
    assert shapes[:2] == [(600, 512), (512, 256)]
