"""Port vs reference: the graph towers (``BallDgcnn``, ``DeepGcn``,
``GroupPointNet``) and their shared pieces.

Against ``ppt_tpu/nn/gcn.py``, random weights carried across by the weight
bridge (``test_torch_classic.pair``), the same numpy inputs through both,
tolerances as ``test_torch_classic.py``. The clouds lie on a 1/64 lattice:
the expanded-form distances are exact in both packages, so the ball
queries and the coordinate kNN pick the same points (the radii square to no
multiple of 1/4096). DeepGCN's later graphs are kNN over random features:
no two distances tie. Its stochastic graph draws from the reference's
``graph`` rng, which no driver reaches: training mode is compared with
``use_stochastic=False``, and the port's stochastic draw on its own.
GroupPointNet's FPS is the grouping kernel's wrapper, here on its plain
version: its indices must be the plain FPS's and the reference's exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_classic import dts, eval_and_train, pair
from test_torch_pointnet2 import close, lattice_cloud

from ppt_torch.kernels import group as kgroup
from ppt_torch.nn import gcn as tgcn
from ppt_torch.ops import geometry as ops

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores


def test_edge_features_are_center_then_offset():
    from ppt_tpu.nn.gcn import _edge_features as jax_edges

    rng = np.random.RandomState(0)
    feats = rng.randn(2, 12, 5).astype(np.float32)
    idx = rng.randint(0, 12, (2, 12, 4)).astype(np.int32)
    got = tgcn._edge_features(torch.from_numpy(feats), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_edges(jnp.asarray(feats),
                                                                    jnp.asarray(idx))))
    np.testing.assert_array_equal(got[..., :5].numpy(),
                                  np.broadcast_to(feats[:, :, None], (2, 12, 4, 5)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("order,act", [("can", ("lrelu", 0.2)), ("cna", ("relu", 0.0))])
def test_conv_block_matches_flax(order, act, dtype):
    from ppt_tpu.nn.gcn import _ConvBlock as JaxConvBlock

    tdt, jdt = dts(dtype)
    x = np.random.RandomState(1).randn(16, 20, 6, 10).astype(np.float32)
    jmod = JaxConvBlock(24, order=order, act=act, dtype=jdt)
    variables, tmod = pair(jmod, tgcn._ConvBlock(10, 24, order=order, act=act, dtype=tdt), x)
    got = eval_and_train(jmod, tmod, variables, [x], dtype)
    assert got.shape == (16, 20, 6, 24) and got.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", ["ballquery", "knn"])
def test_ball_dgcnn_matches_flax(group, dtype):
    """Full width (64, 64, 128, 256 -> 1024), the static graph of the
    coordinates by ball query (radius 0.1) or kNN, then ``cls_feat``."""
    from ppt_tpu.nn.gcn import BallDgcnn as JaxBallDgcnn

    tdt, jdt = dts(dtype)
    x = lattice_cloud(8, 96, 2)
    jmod = JaxBallDgcnn(group=group, dtype=jdt)
    variables, tmod = pair(jmod, tgcn.BallDgcnn(group=group, dtype=tdt), x)
    want = jmod.apply(variables, jnp.asarray(x), method=jmod.cls_feat)
    with torch.no_grad():
        feat = tmod.cls_feat(torch.from_numpy(x))
    assert feat.shape == (8, 2048)
    close(feat.numpy(), want, 1e-5 if dtype == "float32" else 2e-2)
    got = eval_and_train(jmod, tmod, variables, [x], dtype)  # training moves the statistics
    assert got.shape == (8, 96, 1024) and got.dtype == torch.float32


def _deepgcn_cfg(block, **kw):
    return dict(n_blocks=4, k=6, block=block, **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", ["res", "dense", "plain"])
def test_deep_gcn_matches_flax(block, dtype, monkeypatch):
    """Four blocks (dilations 1-3: kNN of 6, 12 and 18 strided), 64 wide,
    the fusion at 1024; eval with the stochastic graph configured (eval
    never draws), training mode without it. The dense wiring's training
    mode is chaotic in its graphs: its later kNN run over up to 192
    concatenated batch-normalised features whose sorted distances sit as
    close as 1e-6 apart: scaling the cloud by 1 + 1e-7 swaps 605 of 3072
    indices at the last block and moves the output by a quarter (measured
    on the port alone), and the other summation order does as much. There
    the reference is given the port's graphs (its
    ``ops.knn_point`` returns the port's indices, call by call), and
    everything else is held at 1e-3; eval holds the graphs themselves."""
    import ppt_tpu.ops as jops
    from ppt_tpu.nn.gcn import DeepGcn as JaxDeepGcn
    from ppt_tpu.nn.gcn import DeepGcnConfig as JaxConfig

    tdt, jdt = dts(dtype)
    x = lattice_cloud(8, 64, 3)
    jmod = JaxDeepGcn(JaxConfig(**_deepgcn_cfg(block)), dtype=jdt)
    tmod = tgcn.DeepGcn(tgcn.DeepGcnConfig(**_deepgcn_cfg(block)), dtype=tdt)
    variables, tmod = pair(jmod, tmod, x)
    got = eval_and_train(jmod, tmod, variables, [x], dtype, train=False)
    assert got.shape == (8, 64, 1024) and got.dtype == torch.float32
    if dtype != "float32":
        return
    jmod = JaxDeepGcn(JaxConfig(**_deepgcn_cfg(block, use_stochastic=False)))
    tmod.config = tgcn.DeepGcnConfig(**_deepgcn_cfg(block, use_stochastic=False))
    if block != "dense":
        eval_and_train(jmod, tmod, variables, [x], dtype)
        return
    graphs = []
    real = tgcn.ops.knn_point
    monkeypatch.setattr(tgcn.ops, "knn_point", lambda k, a, b: graphs.append(real(k, a, b))
                        or graphs[-1])
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), train=True)
    given = iter(graphs)
    monkeypatch.setattr(jops, "knn_point", lambda k, a, b: jnp.asarray(next(given).numpy()))
    want, mutated = jmod.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
    assert next(given, None) is None  # as many graphs asked as the port built
    close(got.numpy(), want, 1e-3)
    from test_torch_pointnet2 import np_tree, stats_close

    stats_close(tmod, np_tree(mutated["batch_stats"]), variables["batch_stats"])


def test_deep_gcn_stochastic_graph_draws_from_its_generator():
    """In training the stochastic graph takes a random k-subset of the
    dilated neighbourhood with probability epsilon, from the ``graph``
    generator, and refuses without one."""
    cfg = tgcn.DeepGcnConfig(**_deepgcn_cfg("res", epsilon=1.0))
    tmod = tgcn.DeepGcn(cfg)
    from test_torch_classic import randomise

    randomise(tmod, 4)
    feats = torch.from_numpy(np.random.RandomState(5).randn(2, 40, 8).astype(np.float32))
    idx = tmod._dilated_knn(feats, 3, True, torch.Generator().manual_seed(1))
    full = ops.knn_point(18, feats, feats)
    assert idx.shape == (2, 40, 6)
    assert all(set(idx[b, n].tolist()) <= set(full[b, n].tolist())
               for b in range(2) for n in range(40))
    assert not torch.equal(idx, full[:, :, ::3])  # epsilon 1: always the random subset
    assert torch.equal(idx, tmod._dilated_knn(feats, 3, True, torch.Generator().manual_seed(1)))
    with pytest.raises(ValueError, match="'graph' generator"):
        tmod(torch.from_numpy(lattice_cloud(2, 40, 6)), train=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", ["ballquery", "knn"])
def test_group_pointnet_matches_flax(group, dtype, monkeypatch):
    """FPS to a quarter of the cloud (the wrapper: its indices the plain
    FPS's and the reference's), one grouping, three conv blocks, the max
    over each group; ``cls_feat`` pools the groups."""
    from ppt_tpu.nn.gcn import GroupPointNet as JaxGroupPointNet
    from ppt_tpu.ops import geometry as jops

    tdt, jdt = dts(dtype)
    x = lattice_cloud(8, 128, 4)
    calls = []
    real = kgroup.fps_batched
    monkeypatch.setattr(kgroup, "fps_batched", lambda p, n: calls.append((p, n)) or real(p, n))
    jmod = JaxGroupPointNet(group=group, dtype=jdt)
    variables, tmod = pair(jmod, tgcn.GroupPointNet(group=group, dtype=tdt), x)
    want = jmod.apply(variables, jnp.asarray(x), method=jmod.cls_feat)
    with torch.no_grad():
        feat = tmod.cls_feat(torch.from_numpy(x))
    assert feat.shape == (8, 128)
    close(feat.numpy(), want, 1e-5 if dtype == "float32" else 2e-2)
    got = eval_and_train(jmod, tmod, variables, [x], dtype)  # training moves the statistics
    assert got.shape == (8, 32, 64) and got.dtype == torch.float32
    assert [n for _, n in calls] == [32] * len(calls) and calls
    idx = real(*calls[0])
    assert torch.equal(idx, ops.farthest_point_sample(calls[0][0], 32))
    np.testing.assert_array_equal(idx.numpy(),
                                  np.asarray(jops.farthest_point_sample(jnp.asarray(x), 32)))


def test_towers_take_a_height_channel():
    """A 4-channel input (``--use_height``): the first layers widen, the
    graphs and groupings stay on the coordinates where the reference's do."""
    from ppt_tpu.nn.gcn import DeepGcn as JaxDeepGcn
    from ppt_tpu.nn.gcn import DeepGcnConfig as JaxConfig
    from ppt_tpu.nn.gcn import GroupPointNet as JaxGroupPointNet

    x = lattice_cloud(8, 64, 5, channels=4)
    for jmod, tmod in ((JaxGroupPointNet(), tgcn.GroupPointNet(in_channels=4)),
                       (JaxDeepGcn(JaxConfig(**_deepgcn_cfg("res", in_channels=4))),
                        tgcn.DeepGcn(tgcn.DeepGcnConfig(**_deepgcn_cfg("res", in_channels=4))))):
        variables, tmod = pair(jmod, tmod, x)
        eval_and_train(jmod, tmod, variables, [x], "float32", train=False)
