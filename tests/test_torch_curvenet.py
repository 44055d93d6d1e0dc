"""Port vs reference: CurveNet (``Walk``, ``CurveAggregation``, ``Lpfa``,
``Cic``, ``CurveNet``).

Against ``ppt_tpu/nn/curvenet.py``, random weights carried across by the
weight bridge (``test_torch_classic.pair``), the same numpy inputs through
both, tolerances as ``test_torch_classic.py``; the whole encoder at
``tests/test_curvenet.py``'s tiny config and once at full width. The
walks' Gumbel noise is the reference's own: its eval draws from
``PRNGKey(0)``, and in training the ``gumbel`` stream, here a known key a
block (the reference's ``Cic.make_rng`` stood in for), split into one key
a step and drawn as ``jax.random.uniform(key, (B, curve_num, k),
minval=1e-20, maxval=1.0)``; the port takes those uniforms. The clouds lie
on a 1/64 lattice: the expanded-form distances are exact in both
packages, so the ball queries and kNN pick the same points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_classic import dts, eval_and_train, no_dropout, pair  # noqa: F401 (a fixture)
from test_torch_pointnet2 import close, lattice_cloud, np_tree, stats_close

from ppt_torch.kernels import group as kgroup
from ppt_torch.nn import curvenet as tcv
from ppt_torch.ops import geometry as ops

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores

TINY = tcv.CurveNetConfig(k=8, stages=((128, 0.2, 8, 32, 2, (16, 4)),
                                       (32, 0.4, 8, 64, 2, None)))
CURVY = tcv.CurveNetConfig(k=8, stages=((128, 0.2, 8, 32, 2, (16, 4)),
                                        (128, 0.2, 8, 32, 4, (16, 4)),
                                        (32, 0.4, 8, 64, 2, (8, 3)),
                                        (8, 0.8, 7, 64, 2, None)))


def jax_config(cfg):
    from ppt_tpu.nn.curvenet import CurveNetConfig

    return CurveNetConfig(k=cfg.k, stages=cfg.stages)


def jax_uniforms(key, curve_length, shape):
    """The reference's draws of one walk from its ``rng``: ``[curve_length,
    *shape]``."""
    keys = jax.random.split(key, curve_length)
    return np.stack([np.asarray(jax.random.uniform(k, shape, minval=1e-20, maxval=1.0))
                     for k in keys])


def block_key(i):
    return jax.random.PRNGKey(100 + i)


@pytest.fixture
def gumbel_keys(monkeypatch):
    """The reference's ``Cic.make_rng("gumbel")`` as ``block_key(i)`` for
    block ``cic{i}`` (block 0 for a block alone)."""
    import ppt_tpu.nn.curvenet as jcv

    monkeypatch.setattr(jcv.Cic, "make_rng",
                        lambda self, name: block_key(int(self.name[3:]) if self.name else 0))


def walk_inputs(B=2, N=48, C=12, k=6, cn=5, seed=0):
    rng = np.random.RandomState(seed)
    xyz = lattice_cloud(B, N, seed)
    feats = rng.randn(B, N, C).astype(np.float32)
    adj = ops.knn_point(k + 1, torch.from_numpy(xyz), torch.from_numpy(xyz))[:, :, 1:].numpy()
    start = rng.randint(0, N, (B, cn)).astype(np.int32)
    return xyz, feats, adj, start


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_walk_matches_flax_with_its_uniforms(dtype):
    import ppt_tpu.nn.curvenet as jcv

    tdt, jdt = dts(dtype)
    B, N, C, k, cn, cl = 2, 48, 12, 6, 5, 4
    xyz, feats, adj, start = walk_inputs(B, N, C, k, cn)
    key = jax.random.PRNGKey(3)
    jmod = jcv.Walk(k, cn, cl, dtype=jdt)
    variables, tmod = pair(jmod, tcv.Walk(k, cn, cl, C, dtype=tdt), xyz, feats, adj, start,
                           np.asarray(key))
    want = jmod.apply(variables, *[jnp.asarray(a) for a in (xyz, feats, adj, start)], key)
    u = torch.from_numpy(jax_uniforms(key, cl, (B, cn, k)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(feats), torch.from_numpy(adj), torch.from_numpy(start), u)
    assert got.shape == (B, cn, cl, C) and got.dtype == torch.float32
    close(got.numpy(), want, 1e-5 if dtype == "float32" else 2e-2)


def test_walk_gradient_matches_flax():
    """The features' gradient through the walk: the crossover suppression
    is cut from the graph (``stop_gradient``), the gate and the picks are
    not."""
    import ppt_tpu.nn.curvenet as jcv

    B, N, C, k, cn, cl = 2, 40, 8, 5, 4, 3
    xyz, feats, adj, start = walk_inputs(B, N, C, k, cn, seed=1)
    key = jax.random.PRNGKey(4)
    jmod = jcv.Walk(k, cn, cl)
    variables, tmod = pair(jmod, tcv.Walk(k, cn, cl, C), xyz, feats, adj, start, np.asarray(key))
    want = jax.grad(lambda f: jnp.sum(jnp.sin(jmod.apply(
        variables, jnp.asarray(xyz), f, jnp.asarray(adj), jnp.asarray(start), key))))(
        jnp.asarray(feats))
    f = torch.from_numpy(feats).requires_grad_(True)
    torch.sin(tmod(f, torch.from_numpy(adj), torch.from_numpy(start),
                   torch.from_numpy(jax_uniforms(key, cl, (B, cn, k))))).sum().backward()
    close(f.grad.numpy(), want, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_curve_aggregation_matches_flax(dtype):
    import ppt_tpu.nn.curvenet as jcv

    tdt, jdt = dts(dtype)
    rng = np.random.RandomState(5)
    x = rng.randn(2, 30, 16).astype(np.float32)
    curves = rng.randn(2, 6, 4, 16).astype(np.float32)
    jmod = jcv.CurveAggregation(dtype=jdt)
    variables, tmod = pair(jmod, tcv.CurveAggregation(16, dtype=tdt), x, curves)
    got = eval_and_train(jmod, tmod, variables, [x, curves], dtype, train=False)
    assert got.shape == (2, 30, 16) and got.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("initial", [True, False])
def test_lpfa_matches_flax(initial, dtype):
    """The stem (``initial``: no features in, the max over the neighbours)
    and a block's (the geometry lifted to the features, the mean)."""
    import ppt_tpu.nn.curvenet as jcv

    tdt, jdt = dts(dtype)
    xyz = lattice_cloud(16, 40, 6)
    feats = None if initial else np.random.RandomState(7).randn(16, 40, 10).astype(np.float32)
    width = 12 if initial else 10
    jmod = jcv.Lpfa(width, 8, mlp_num=1 if initial else 2, initial=initial, dtype=jdt)
    tmod = tcv.Lpfa(0 if initial else 10, width, 8, mlp_num=1 if initial else 2,
                    initial=initial, dtype=tdt)
    variables, tmod = pair(jmod, tmod, feats, xyz)
    jf = None if initial else jnp.asarray(feats)
    tf = None if initial else torch.from_numpy(feats)
    want = jmod.apply(variables, jf, jnp.asarray(xyz))
    with torch.no_grad():
        got = tmod(tf, torch.from_numpy(xyz))
    assert got.shape == (16, 40, width) and got.dtype == torch.float32
    close(got.numpy(), want, 1e-5 if dtype == "float32" else 2e-2)
    if dtype != "float32":
        return
    want, mutated = jmod.apply(variables, jf, jnp.asarray(xyz), train=True,
                               mutable=["batch_stats"])
    with torch.no_grad():
        got = tmod(tf, torch.from_numpy(xyz), train=True)
    close(got.numpy(), want, 1e-3)
    stats_close(tmod, np_tree(mutated["batch_stats"]), variables["batch_stats"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("npoint,curves,cin,cout", [
    (64, (6, 3), 16, 32),  # FPS 96 -> 64 + ball-query max, curves, a shortcut
    (96, (6, 3), 16, 16),  # no downsampling, no shortcut
    (32, None, 16, 32),  # no curves
])
def test_cic_matches_flax(npoint, curves, cin, cout, dtype, gumbel_keys):
    """A block in eval (the walks' draws from ``PRNGKey(0)``) and in
    training (from the block's ``gumbel`` key); ``CurveAggregation``'s
    running statistics never move, in training too."""
    import ppt_tpu.nn.curvenet as jcv

    tdt, jdt = dts(dtype)
    B, N, k = 16, 96, 8
    xyz = lattice_cloud(B, N, 8)
    feats = np.random.RandomState(9).randn(B, N, cin).astype(np.float32)
    jmod = jcv.Cic(npoint, 0.3, k, cout, curve_config=curves, dtype=jdt)
    tmod = tcv.Cic(cin, npoint, 0.3, k, cout, curve_config=curves, dtype=tdt)
    variables, tmod = pair(jmod, tmod, xyz, feats)
    shape = (B, curves[0], k) if curves else None
    draws = {False: jax_uniforms(jax.random.PRNGKey(0), curves[1], shape) if curves else None,
             True: jax_uniforms(block_key(0), curves[1], shape) if curves else None}
    jin = [jnp.asarray(xyz), jnp.asarray(feats)]
    tin = [torch.from_numpy(xyz), torch.from_numpy(feats)]
    for train in (False, True):
        if train and dtype != "float32":
            break
        u = None if draws[train] is None else torch.from_numpy(draws[train])
        if train:
            (want_xyz, want), mutated = jmod.apply(variables, *jin, True, mutable=["batch_stats"])
        else:
            want_xyz, want = jmod.apply(variables, *jin)
        before = {k: v.clone() for k, v in tmod.named_buffers()}
        with torch.no_grad():
            got_xyz, got = tmod(*tin, train, uniforms=u)
        np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
        assert got.shape == (B, npoint, cout) and got.dtype == torch.float32
        close(got.numpy(), want, (1e-3 if train else 1e-5) if dtype == "float32" else 2e-2)
        if curves:
            for name in ("running_mean", "running_var"):
                assert torch.equal(getattr(tmod.curveagg.convd_bn, name),
                                   before[f"curveagg.convd_bn.{name}"])
        if train:
                    stats_close(tmod, np_tree(mutated["batch_stats"]), variables["batch_stats"],
                        skip=("curveagg.convd_bn",))


def test_cic_start_points_take_ties_to_the_lower_index():
    """The walk's start points are ``lax.top_k`` of the attention: with
    every attention equal they are the first ``curve_num`` points."""
    tmod = tcv.Cic(8, 20, 0.3, 4, 8, curve_config=(5, 2))
    starts = []
    tmod.walk.register_forward_hook(lambda m, a, o: starts.append(a[2]))
    with torch.no_grad():
        for p in tmod.parameters():
            p.zero_()  # a zero start_att: every sigmoid is 0.5
        tmod(torch.from_numpy(lattice_cloud(2, 20, 1)), torch.randn(2, 20, 8),
             uniforms=torch.full((2, 2, 5, 4), 0.5))
    assert torch.equal(starts[0], torch.arange(5).expand(2, 5))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cfg_name", ["TINY", "CURVY"])
def test_curvenet_matches_flax_with_its_draws(cfg_name, dtype, no_dropout, gumbel_keys):
    """The encoder in eval, the walks' noise from ``PRNGKey(0)`` in every
    curve stage, and (f32) in training from each block's key; FPS through
    the wrapper once a downsampling block."""
    import ppt_tpu.nn.curvenet as jcv

    tdt, jdt = dts(dtype)
    cfg = {"TINY": TINY, "CURVY": CURVY}[cfg_name]
    B, N = 32, 128
    x = lattice_cloud(B, N, 10)
    jmod = jcv.CurveNet(jax_config(cfg), dtype=jdt)
    variables, tmod = pair(jmod, tcv.CurveNet(cfg, dtype=tdt), x)
    shapes = tmod.walk_shapes(B)
    curve_blocks = [i for i, st in enumerate(cfg.stages) if st[5] is not None]
    eval_draws = [torch.from_numpy(jax_uniforms(jax.random.PRNGKey(0), s[0], s[1:]))
                  for s in shapes]
    fps = []
    real = kgroup.fps_batched
    tcv.kgroup.fps_batched = lambda p, n: fps.append((p.shape[1], n)) or real(p, n)
    try:
        want = jmod.apply(variables, jnp.asarray(x))
        with torch.no_grad():
            got = tmod(torch.from_numpy(x), uniforms=eval_draws)
            default = tmod(torch.from_numpy(x))
    finally:
        tcv.kgroup.fps_batched = real
    assert got.shape == (B, 256) and got.dtype == torch.float32
    close(got.numpy(), want, 1e-5 if dtype == "float32" else 2e-2)
    downs = [(n, st[0]) for n, st in zip([N] + [st[0] for st in cfg.stages], cfg.stages)
             if n != st[0]]
    assert fps == downs + downs  # one FPS a downsampling block, each forward
    assert torch.isfinite(default).all()  # its own fixed draws: not the reference's values
    if dtype != "float32":
        return
    train_draws = [torch.from_numpy(jax_uniforms(block_key(i), s[0], s[1:]))
                   for i, s in zip(curve_blocks, shapes)]
    want, mutated = jmod.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), train=True, uniforms=train_draws)
    close(got.numpy(), want, 1e-3)
    stats_close(tmod, np_tree(mutated["batch_stats"]), variables["batch_stats"],
                skip=tuple(f"cic{i}.curveagg.convd_bn" for i in curve_blocks))
