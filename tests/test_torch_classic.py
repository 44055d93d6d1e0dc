"""Port vs reference: PointNet (with and without T-Nets) and DGCNN.

``PointNetClassic``, ``Tnet``, ``PointNetEncoder`` and ``DgcnnClassifier``
against ``ppt_tpu/nn/classic.py``: random weights drawn on the port's
modules and carried into the flax tree by the weight bridge's name rule
(the tree's shapes from ``jax.eval_shape``), ``convert.from_jax`` back, the
same numpy inputs through both. This file also holds the helpers the other
tower files of this slice share (``pair``, ``no_dropout``).

Tolerances: eval f32 within 1e-5 of the output's max magnitude, bf16
within 2e-2 (the Dense products round to bf16 on both sides, summed in
another order); training mode in f32 within 1e-3 of the output's scale
(BatchNorms over the batch's statistics magnify the other summation
order), running statistics within 1e-5, as ``test_torch_pointmlp.py``
holds them. The heads' dropouts cannot be matched draw for draw: wherever
training mode is compared, both packages' dropouts are the identity.
DGCNN's kNN runs in feature space: the features are random, so no two
distances tie.
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flax import traverse_util

from test_torch_pointnet2 import close, np_tree, stats_close

from ppt_torch.convert import _port_key, from_jax
from ppt_torch.nn import classic as tcl
from ppt_torch.nn import curvenet as tcv
from ppt_torch.nn import pct as tpct
from ppt_torch.nn import simpleview as tsv
from ppt_torch.nn.layers import init_dense_
from ppt_torch.nn.resnet import init_conv_

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def dts(name):
    return getattr(torch, name), getattr(jnp, name)


def cloud(B, N, seed, channels=3):
    return np.random.RandomState(seed).rand(B, N, channels).astype(np.float32)


@pytest.fixture
def no_dropout(monkeypatch):
    """Both packages' dropouts as the identity."""

    class Keep(flax.linen.Module):
        rate: float

        @flax.linen.compact
        def __call__(self, x, deterministic=True):
            return x

    monkeypatch.setattr(flax.linen, "Dropout", Keep)
    for mod in (tcl, tcv, tpct, tsv):
        monkeypatch.setattr(mod, "dropout", lambda x, rate, train, generator: x)


def randomise(tmodule, seed):
    """Dense and Conv kernels lecun-normal, the walks' kernels normal, and
    non-trivial BatchNorm affine and running statistics."""
    gen = torch.Generator().manual_seed(seed)
    init_dense_(tmodule, gen)
    init_conv_(tmodule, gen)
    with torch.no_grad():
        for name, t in tmodule.state_dict(keep_vars=True).items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("agent_kernel", "momentum_kernel"):
                t.copy_(torch.randn(t.shape, generator=gen) / t.shape[0] ** 0.5)
            elif name.endswith("bias") and t.dim() == 1 or leaf == "running_mean":
                t.copy_(0.1 * torch.randn(t.shape, generator=gen))
            elif leaf == "running_var":
                t.copy_(0.5 + torch.rand(t.shape, generator=gen))
            elif leaf == "weight":
                t.copy_(1 + 0.1 * torch.randn(t.shape, generator=gen))


def variables_from_port(shapes, tmodule):
    """The flax variables of tree ``shapes`` with the port module's values,
    each leaf taken by the weight bridge's name rule."""
    sd = tmodule.state_dict()
    out = {}
    for coll, tree in shapes.items():
        leaves = {}
        for path, leaf in traverse_util.flatten_dict(tree).items():
            got = sd[_port_key(path, coll == "batch_stats")].float().numpy().copy()
            assert got.shape == tuple(leaf.shape), (path, got.shape, leaf.shape)
            leaves[path] = got
        out[coll] = traverse_util.unflatten_dict(leaves)
    return out


def pair(jmodule, tmodule, *inputs, seed=2, **kw):
    """(flax variables, port module) with the same random weights; the
    flax tree's shapes by ``jax.eval_shape`` of its init on ``inputs`` and
    ``kw`` (nothing compiled)."""
    randomise(tmodule, seed)
    shapes = jax.eval_shape(lambda k, *x: jmodule.init(k, *x, **kw), jax.random.PRNGKey(0),
                            *[None if x is None else jnp.asarray(x) for x in inputs])
    variables = variables_from_port(shapes, tmodule)
    tmodule.load_state_dict(from_jax(variables.get("params", {}),
                                     variables.get("batch_stats", {}), tmodule))
    return variables, tmodule


def stats_close_batch(tmodule, new_stats, old_stats, atol=1e-5, batch_rel=0.0):
    """``stats_close``, each statistic within ``atol`` plus ``batch_rel``
    times the magnitude of the batch statistic that moved it
    (``(new - 0.99 old) / 0.01``): flax's fast variance ``E[x^2] - E[x]^2``
    rounds in proportion to it."""
    if not batch_rel:
        return stats_close(tmodule, new_stats, old_stats, atol)
    n = 0
    for name, buf in tmodule.named_buffers():
        *path, leaf = name.split(".")
        want, old = new_stats, old_stats
        for key in path:
            want, old = want[key], old[key]
        key = {"running_mean": "mean", "running_var": "var"}[leaf]
        want, old = np.asarray(want[key]), np.asarray(old[key])
        batch = np.abs(want - 0.99 * old) / 0.01
        assert np.all(np.abs(buf.numpy() - want) <= atol + batch_rel * batch), name
        n += 1
    assert n > 0


def eval_and_train(jmodule, tmodule, variables, inputs, dtype, train_tol=1e-3, jkw=None,
                   tkw=None, train=True, batch_rel=0.0):
    """Eval at ``TOL[dtype]``; then (f32) training mode within ``train_tol``
    of the output's scale and the running statistics within 1e-5
    (``stats_close_batch``)."""
    jkw, tkw = jkw or {}, tkw or {}
    jin = [jnp.asarray(x) for x in inputs]
    tin = [torch.from_numpy(x) for x in inputs]
    want = jax.jit(lambda v, *x: jmodule.apply(v, *x, **jkw))(variables, *jin)
    with torch.no_grad():
        got = tmodule(*tin, **tkw)
    close(got.float().numpy(), want, TOL[dtype])
    if dtype != "float32" or not train:
        return got
    want, mutated = jax.jit(lambda v, *x: jmodule.apply(v, *x, train=True, mutable=["batch_stats"],
                                                        **jkw))(variables, *jin)
    with torch.no_grad():
        got = tmodule(*tin, train=True, **tkw)
    close(got.float().numpy(), want, train_tol)
    stats_close_batch(tmodule, np_tree(mutated["batch_stats"]), variables["batch_stats"],
                      batch_rel=batch_rel)
    return got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("channels", [3, 4])
def test_pointnet_classic_matches_flax(dtype, channels, no_dropout):
    """The vanilla PointNet at full width; 4 channels is ``--use_height``'s
    input, whose first layer flax infers 4 wide."""
    import ppt_tpu.nn.classic as jcl

    tdt, jdt = dts(dtype)
    x = cloud(8, 64, 1, channels)
    jmod = jcl.PointNetClassic(dtype=jdt)
    variables, tmod = pair(jmod, tcl.PointNetClassic(channels, dtype=tdt), x)
    got = eval_and_train(jmod, tmod, variables, [x], dtype)
    assert got.shape == (8, 256) and got.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,channels", [(3, 3), (3, 5), (64, 64)])
def test_tnet_matches_flax_and_is_biased_to_the_identity(k, channels, dtype):
    import ppt_tpu.nn.classic as jcl

    tdt, jdt = dts(dtype)
    x = np.random.RandomState(k).randn(8, 40, channels).astype(np.float32)
    jmod = jcl.Tnet(k, dtype=jdt)
    variables, tmod = pair(jmod, tcl.Tnet(k, in_channels=channels, dtype=tdt), x)
    got = eval_and_train(jmod, tmod, variables, [x], dtype)
    assert got.shape == (8, k, k) and got.dtype == tdt
    with torch.no_grad():  # a zero last layer leaves exactly the identity
        tmod.fc3.kernel.zero_()
        tmod.fc3.bias.zero_()
        eye = tmod(torch.from_numpy(x))
    assert torch.equal(eye.float(), torch.eye(k).expand(8, k, k))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("channels", [3, 4])
def test_pointnet_encoder_matches_flax(dtype, channels):
    """Both T-Nets at full width. With 4 channels the input STN sees all 4
    and turns the 3 coordinates; the 4th channel passes untouched. The
    random feature transform (entries ~N(0, 1) plus the identity) leaves
    ``bn1`` a batch variance of up to 65.5, whose fast variance rounds at
    3.4e-5 of itself (2.2e-5 on the running variance, measured; every other
    statistic within 1e-6): the statistics are held within 1e-5 plus 1e-6
    of their batch statistic."""
    import ppt_tpu.nn.classic as jcl

    tdt, jdt = dts(dtype)
    x = cloud(32, 32, 2, channels)
    jmod = jcl.PointNetEncoder(dtype=jdt)
    variables, tmod = pair(jmod, tcl.PointNetEncoder(channels, dtype=tdt), x)
    got = eval_and_train(jmod, tmod, variables, [x], dtype, batch_rel=1e-6)
    assert got.shape == (32, 1024) and got.dtype == torch.float32
    assert (got < 0).any()  # no ReLU after the last BatchNorm
    if channels == 4:
        seen = []
        tmod.conv0_1.register_forward_hook(lambda m, a, o: seen.append(a[0]))
        with torch.no_grad():
            tmod(torch.from_numpy(x))
        torch.testing.assert_close(seen[0][..., 3].float(),
                                   torch.from_numpy(x[..., 3]).to(tdt).float(), rtol=0, atol=0)


@pytest.mark.parametrize("encoder", ["input", "feature"])
def test_pointnet_encoder_without_a_transform(encoder):
    import ppt_tpu.nn.classic as jcl

    kw = {f"{encoder}_transform": False}
    x = cloud(4, 32, 3)
    jmod = jcl.PointNetEncoder(**kw)
    variables, tmod = pair(jmod, tcl.PointNetEncoder(3, **kw), x)
    eval_and_train(jmod, tmod, variables, [x], "float32")
    assert not hasattr(tmod, "stn" if encoder == "input" else "fstn")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("trunk", [True, False])
def test_dgcnn_matches_flax(dtype, trunk, no_dropout):
    """DGCNN at full width (k=20, 64-64-128-256, emb 1024) over 48 points;
    without the trunk the pooled 2048-d features."""
    import ppt_tpu.nn.classic as jcl

    tdt, jdt = dts(dtype)
    x = cloud(6, 48, 4)
    jmod = jcl.DgcnnClassifier(trunk=trunk, dtype=jdt)
    variables, tmod = pair(jmod, tcl.DgcnnClassifier(3, trunk=trunk, dtype=tdt), x)
    got = eval_and_train(jmod, tmod, variables, [x], dtype)
    assert got.shape == (6, 256 if trunk else 2048) and got.dtype == torch.float32


def test_dgcnn_edge_feature_and_feature_space_graph():
    """The edge feature is ``[neighbor - center, center]`` and the second
    stage's graph is the kNN of the first stage's features."""
    x = torch.from_numpy(cloud(2, 30, 5))
    tmod = tcl.DgcnnClassifier(3, k=4)
    randomise(tmod, 3)
    seen = []
    tmod.edge0.register_forward_hook(lambda m, a, o: seen.append(a[0]))
    tmod.edge1.register_forward_hook(lambda m, a, o: seen.append(a[0]))
    stage1 = []
    tmod.bn0.register_forward_hook(lambda m, a, o: stage1.append(o))
    with torch.no_grad():
        tmod(x)
    from ppt_torch.ops import geometry as ops

    idx = ops.knn_point(4, x, x)
    nbrs = ops.index_points(x, idx)
    torch.testing.assert_close(seen[0], torch.cat([nbrs - x[:, :, None], x[:, :, None]
                                                   .expand_as(nbrs)], -1))
    feats = torch.nn.functional.leaky_relu(stage1[0], 0.2).amax(2)
    idx1 = ops.knn_point(4, feats, feats)
    torch.testing.assert_close(seen[1][..., 64:], feats[:, :, None].expand(-1, -1, 4, -1))
    torch.testing.assert_close(seen[1][..., :64], ops.index_points(feats, idx1) - feats[:, :, None])
