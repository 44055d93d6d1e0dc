"""Port vs reference: the PointNet++ set-abstraction layers and trunks.

``SetAbstraction``, ``SetAbstractionMsg``, ``_FcHead``, ``PointNet2Ssg`` and
``PointNet2Msg`` against the flax modules, weights carried over by
``convert.from_jax``, the same numpy inputs through both.

The clouds lie on a 1/64 lattice: every squared distance is then an exact
multiple of 1/4096 in f32, in the reference's expanded form as in the
port's exact-difference form, and no radius of these towers squares to
such a multiple (the nearest, 0.1**2, is 1e-5 away). So the reference's
CPU oracle ``ops.query_ball_point`` and the port's kernel-form plain
version pick the same neighbours, at every stage.

Tolerances: f32 outputs within 1e-5 of the output's max magnitude (the
same algebra in another summation order); bf16 within 2e-2 (Dense rounds
to bf16 in both, at sums taken in another order); running statistics after
one training-mode call within 1e-5 absolute in f32. Dropout cannot be
matched draw for draw: the head is compared at rate 0, and the trunks'
training-mode buffers up to the first dropout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppt_torch.convert import from_jax
from ppt_torch.nn import pointnet2 as tp2

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def lattice_cloud(B, N, seed, channels=3):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 65, (B, N, channels)) / 64.0).astype(np.float32)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def randomise_bn(params, stats, rng):
    """Non-trivial BatchNorm affine and running statistics everywhere."""
    for k, v in params.items():
        if isinstance(v, dict) and set(v) == {"scale", "bias"}:
            n = v["scale"].shape[0]
            params[k] = {"scale": (1 + 0.1 * rng.randn(n)).astype(np.float32),
                         "bias": (0.1 * rng.randn(n)).astype(np.float32)}
        elif isinstance(v, dict):
            randomise_bn(v, stats.get(k, {}), rng)
    for k, v in stats.items():
        if isinstance(v, dict) and set(v) == {"mean", "var"}:
            n = v["mean"].shape[0]
            stats[k] = {"mean": (0.1 * rng.randn(n)).astype(np.float32),
                        "var": (0.5 + rng.rand(n)).astype(np.float32)}


def flax_variables(module, rng, *inputs):
    variables = module.init(jax.random.PRNGKey(0), *inputs)
    params, stats = np_tree(variables["params"]), np_tree(variables["batch_stats"])
    randomise_bn(params, stats, rng)
    return params, stats


def close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.max(np.abs(want)))
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * scale, np.max(np.abs(got - want)) / scale


def stats_close(module, new_stats, old_stats, atol=1e-5, skip=()):
    """Every running statistic of ``module`` against the flax tree after a
    training-mode call; each must also have moved."""
    n = 0
    for name, buf in module.named_buffers():
        *path, leaf = name.split(".")
        if ".".join(path) in skip:
            continue
        want, old = new_stats, old_stats
        for key in path:
            want, old = want[key], old[key]
        key = {"running_mean": "mean", "running_var": "var"}[leaf]
        np.testing.assert_allclose(buf.numpy(), want[key], rtol=0, atol=atol, err_msg=name)
        assert not np.array_equal(buf.numpy(), old[key]), name
        n += 1
    assert n > 0


def _dt(name):
    return getattr(torch, name), getattr(jnp, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_set_abstraction_matches_flax(dtype):
    from ppt_tpu.nn.pointnet2 import SetAbstraction as JaxSA

    tdt, jdt = _dt(dtype)
    rng = np.random.RandomState(0)
    xyz = lattice_cloud(2, 96, 1)
    pts = rng.randn(2, 96, 5).astype(np.float32)
    jsa = JaxSA(16, 0.3, 7, (16, 24), dtype=jdt)
    params, stats = flax_variables(jsa, rng, jnp.asarray(xyz), jnp.asarray(pts))
    want_xyz, want = jsa.apply({"params": params, "batch_stats": stats}, jnp.asarray(xyz),
                               jnp.asarray(pts))
    tsa = tp2.SetAbstraction(16, 0.3, 7, 5 + 3, (16, 24), dtype=tdt)
    tsa.load_state_dict(from_jax(params, stats, tsa))
    with torch.no_grad():
        got_xyz, got = tsa(torch.from_numpy(xyz), torch.from_numpy(pts))
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    assert got.dtype == torch.float32  # BatchNorm's f32 output, whatever the Dense dtype
    close(got.numpy(), want, TOL[dtype])


def test_set_abstraction_train_mode_and_group_all():
    from ppt_tpu.nn.pointnet2 import SetAbstraction as JaxSA

    rng = np.random.RandomState(1)
    xyz = lattice_cloud(3, 64, 2)
    pts = rng.randn(3, 64, 4).astype(np.float32)
    for kwargs, targs in (
        (dict(npoint=16, radius=0.4, nsample=6, mlp=(8, 12)), (16, 0.4, 6, 7, (8, 12))),
        (dict(npoint=None, radius=None, nsample=None, mlp=(8, 12), group_all=True),
         (None, None, None, 7, (8, 12), True)),
    ):
        jsa = JaxSA(**kwargs)
        params, stats = flax_variables(jsa, rng, jnp.asarray(xyz), jnp.asarray(pts))
        (want_xyz, want), mutated = jsa.apply(
            {"params": params, "batch_stats": stats}, jnp.asarray(xyz), jnp.asarray(pts), True,
            mutable=["batch_stats"])
        tsa = tp2.SetAbstraction(*targs)
        tsa.load_state_dict(from_jax(params, stats, tsa))
        with torch.no_grad():
            got_xyz, got = tsa(torch.from_numpy(xyz), torch.from_numpy(pts), train=True)
        np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
        close(got.numpy(), want, 1e-5)
        stats_close(tsa, np_tree(mutated["batch_stats"]), stats)
        # eval leaves the running statistics alone
        before = {k: v.clone() for k, v in tsa.named_buffers()}
        with torch.no_grad():
            tsa(torch.from_numpy(xyz), torch.from_numpy(pts), train=False)
        assert all(torch.equal(v, before[k]) for k, v in tsa.named_buffers())


@pytest.mark.parametrize("dtype,with_points", [("float32", True), ("float32", False),
                                               ("bfloat16", True)])
def test_set_abstraction_msg_matches_flax(dtype, with_points):
    from ppt_tpu.nn.pointnet2 import SetAbstractionMsg as JaxMsg

    tdt, jdt = _dt(dtype)
    rng = np.random.RandomState(2)
    xyz = lattice_cloud(2, 80, 3)
    pts = rng.randn(2, 80, 6).astype(np.float32) if with_points else None
    jpts = None if pts is None else jnp.asarray(pts)
    tpts = None if pts is None else torch.from_numpy(pts)
    cfg = (16, (0.2, 0.4), (5, 9), ((8, 12), (8, 8, 16)))
    jmsg = JaxMsg(*cfg, dtype=jdt)
    params, stats = flax_variables(jmsg, rng, jnp.asarray(xyz), jpts)
    (want_xyz, want), mutated = jmsg.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(xyz), jpts, True,
        mutable=["batch_stats"])
    tmsg = tp2.SetAbstractionMsg(*cfg[:3], (6 if with_points else 0) + 3, cfg[3], dtype=tdt)
    tmsg.load_state_dict(from_jax(params, stats, tmsg))
    with torch.no_grad():
        got_xyz, got = tmsg(torch.from_numpy(xyz), tpts, train=True)
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    assert got.shape == (2, 16, 12 + 16)
    close(got.numpy(), want, TOL[dtype])
    stats_close(tmsg, np_tree(mutated["batch_stats"]), stats,
                atol=1e-5 if dtype == "float32" else 2e-3)


def test_fc_head_train_mode_without_dropout_matches_flax():
    from ppt_tpu.nn.pointnet2 import _FcHead as JaxHead

    rng = np.random.RandomState(3)
    x = rng.randn(6, 1024).astype(np.float32)
    jhead = JaxHead(0.0, 0.0)
    params, stats = flax_variables(jhead, rng, jnp.asarray(x))
    want, mutated = jhead.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), True,
                                mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(1)})
    thead = tp2._FcHead(0.0, 0.0)
    thead.load_state_dict(from_jax(params, stats, thead))
    with torch.no_grad():
        got = thead(torch.from_numpy(x), train=True)
    close(got.numpy(), want, 1e-5)
    stats_close(thead, np_tree(mutated["batch_stats"]), stats)


def test_dropout_draws_from_the_generator_with_flax_scaling():
    from ppt_torch.nn.layers import dropout

    x = torch.ones(200, 100)
    gen = torch.Generator().manual_seed(0)
    out = dropout(x, 0.4, True, gen)
    kept = out != 0
    assert torch.all(out[kept] == 1.0 / 0.6)  # kept elements are scaled by 1 / keep
    assert abs(float(kept.float().mean()) - 0.6) < 0.02
    again = dropout(x, 0.4, True, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)  # the mask is the generator's
    assert dropout(x, 0.4, False, gen) is x and dropout(x, 0.0, True, gen) is x
    # the trunk's head draws in training mode only
    head = tp2._FcHead(0.4, 0.4)
    for p in head.parameters():
        p.data.normal_(0, 0.05)
    feats = torch.randn(8, 1024)
    with torch.no_grad():
        a = head(feats, train=True, generator=torch.Generator().manual_seed(1))
        b = head(feats, train=True, generator=torch.Generator().manual_seed(2))
        assert not torch.equal(a, b) and float((a == 0).float().mean()) > 0.3
        assert torch.equal(head(feats), head(feats))


@pytest.mark.parametrize("name,dtype", [("Ssg", "float32"), ("Msg", "float32"),
                                        ("Ssg", "bfloat16"), ("Msg", "bfloat16")])
def test_pointnet2_trunk_eval_matches_flax(name, dtype):
    import ppt_tpu.nn.pointnet2 as jp2

    tdt, jdt = _dt(dtype)
    rng = np.random.RandomState(4)
    xyz = lattice_cloud(2, 600, 5)  # sa1 samples 512 centres: N must reach that
    jmodel = getattr(jp2, f"PointNet2{name}")(dtype=jdt)
    params, stats = flax_variables(jmodel, rng, jnp.asarray(xyz))
    want = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(xyz))
    tmodel = getattr(tp2, f"PointNet2{name}")(dtype=tdt)
    tmodel.load_state_dict(from_jax(params, stats, tmodel))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(xyz))
    assert got.shape == (2, 256) and got.dtype == torch.float32
    close(got.numpy(), want, TOL[dtype])


@pytest.mark.parametrize("name", ["Ssg", "Msg"])
def test_pointnet2_trunk_train_mode_buffers_match_flax(name):
    """One training-mode call: every BatchNorm buffer up to the head's first
    dropout against flax (``head.bn2`` sits behind a dropout whose draws
    differ, so it is only required to move)."""
    import ppt_tpu.nn.pointnet2 as jp2

    rng = np.random.RandomState(6)
    xyz = lattice_cloud(3, 560, 7)
    jmodel = getattr(jp2, f"PointNet2{name}")()
    params, stats = flax_variables(jmodel, rng, jnp.asarray(xyz))
    _, mutated = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(xyz), True,
                              mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
    tmodel = getattr(tp2, f"PointNet2{name}")()
    tmodel.load_state_dict(from_jax(params, stats, tmodel))
    with torch.no_grad():
        out = tmodel(torch.from_numpy(xyz), train=True,
                     generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(out).all()
    stats_close(tmodel, np_tree(mutated["batch_stats"]), stats, skip=("head.bn2",))
    assert not np.array_equal(tmodel.head.bn2.running_mean.numpy(), stats["head"]["bn2"]["mean"])
