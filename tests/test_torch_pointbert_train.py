"""Port vs reference: the point tower in training mode.

``MiniPointNet(train=True)`` and ``PointBert(train=True)`` against the
flax modules with shared weights, with the reference's fused kernels
forced on (interpret mode, as on its chip) and with its unfused XLA path.
f32: tokens and features within 1e-4 of their max magnitude (same
algebra, other summation order; the unfused flax path takes the batch
statistics from the activations instead of the closed forms, which
differs in rounding only); updated running statistics within 1e-5
absolute. DropPath is off for parity (``drop_path_rate=0``) and tested by
its distribution.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppt_torch.convert import from_jax
from ppt_torch.nn.layers import drop_path_scales
from ppt_torch.nn.pointbert import MiniPointNet, PointBert, PointBertConfig

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores

TINY = dict(trans_dim=64, depth=2, drop_path_rate=0.0, num_heads=2, group_size=8,
            num_group=16, encoder_dims=64)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _randomise_bn(params, stats, rng):
    for bn in ("bn1", "bn2"):
        n = params[bn]["scale"].shape[0]
        params[bn] = {"scale": (1 + 0.1 * rng.randn(n)).astype(np.float32),
                      "bias": (0.1 * rng.randn(n)).astype(np.float32)}
        stats[bn] = {"mean": (0.1 * rng.randn(n)).astype(np.float32),
                     "var": (0.5 + rng.rand(n)).astype(np.float32)}


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.max(np.abs(want))), 1.0)
    assert np.max(np.abs(got - want)) <= tol * scale, np.max(np.abs(got - want)) / scale


def _set_path(monkeypatch, fused):
    if fused:
        monkeypatch.setenv("PPT_FORCE_FUSED_MINI", "1")
        monkeypatch.setenv("PPT_FUSED_BLOCK", "1")
    else:
        monkeypatch.delenv("PPT_FORCE_FUSED_MINI", raising=False)
        monkeypatch.setenv("PPT_FUSED_BLOCK", "0")


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_minipointnet_train_matches_flax(fused, monkeypatch):
    from ppt_tpu.nn.pointbert import MiniPointNet as JaxMini

    rng = np.random.RandomState(2)
    groups = (rng.rand(2, 8, 8, 3) - 0.5).astype(np.float32)
    jmini = JaxMini(64)
    variables = jmini.init(jax.random.PRNGKey(0), jnp.asarray(groups[:1]))
    params, stats = _np_tree(variables["params"]), _np_tree(variables["batch_stats"])
    _randomise_bn(params, stats, rng)
    _set_path(monkeypatch, fused)
    want, mutated = jmini.apply({"params": params, "batch_stats": stats}, jnp.asarray(groups),
                                True, mutable=["batch_stats"])
    new_stats = _np_tree(mutated["batch_stats"])

    tmini = MiniPointNet(64)
    tmini.load_state_dict(from_jax(params, stats, tmini))
    with torch.no_grad():
        got = tmini(torch.from_numpy(groups), train=True)
    _close(got.numpy(), want, 1e-4)
    for bn in ("bn1", "bn2"):
        mod = getattr(tmini, bn)
        np.testing.assert_allclose(mod.running_mean.numpy(), new_stats[bn]["mean"], atol=1e-5)
        np.testing.assert_allclose(mod.running_var.numpy(), new_stats[bn]["var"], atol=1e-5)
        # flax's update: momentum 0.99, so the statistics moved, and only a little
        assert not np.allclose(mod.running_mean.numpy(), stats[bn]["mean"], atol=1e-7)
        assert np.max(np.abs(mod.running_var.numpy() - stats[bn]["var"])) < 0.05


def test_minipointnet_eval_leaves_running_stats_alone():
    rng = np.random.RandomState(3)
    tmini = MiniPointNet(64)
    for p in tmini.parameters():
        p.data.normal_(0, 0.1)
    before = {k: v.clone() for k, v in tmini.named_buffers()}
    with torch.no_grad():
        tmini(torch.from_numpy(rng.rand(1, 8, 8, 3).astype(np.float32)), train=False)
    for k, v in tmini.named_buffers():
        assert torch.equal(v, before[k])


def test_minipointnet_train_survives_a_constant_channel():
    """var = E[x^2] - E[x]^2 is clamped at 0 in f32: all-equal points give
    zero variance everywhere, and nothing turns NaN."""
    tmini = MiniPointNet(64)
    for p in tmini.parameters():
        p.data.normal_(0, 0.1)
    with torch.no_grad():
        out = tmini(torch.full((1, 8, 8, 3), 0.37), train=True)
    assert torch.isfinite(out).all()
    for _, v in tmini.named_buffers():
        assert torch.isfinite(v).all() and (v.abs() < 10).all()
    assert (tmini.bn1.running_var >= 0).all() and (tmini.bn2.running_var >= 0).all()


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_pointbert_train_feature_and_stats_match_flax(fused, monkeypatch):
    from ppt_tpu.nn import PointBert as JaxPointBert
    from ppt_tpu.nn import PointBertConfig as JaxBertConfig

    rng = np.random.RandomState(4)
    pts = rng.rand(3, 128, 3).astype(np.float32)
    jmodel = JaxPointBert(JaxBertConfig(**TINY))
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(pts[:1]))
    params, stats = _np_tree(variables["params"]), _np_tree(variables["batch_stats"])
    _randomise_bn(params["encoder"], stats["encoder"], rng)
    _set_path(monkeypatch, fused)
    want, mutated = jmodel.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(pts), True,
        mutable=["batch_stats"], rngs={"droppath": jax.random.PRNGKey(1)})
    new_stats = _np_tree(mutated["batch_stats"])["encoder"]

    tmodel = PointBert(PointBertConfig(**TINY))
    tmodel.load_state_dict(from_jax(params, stats, tmodel))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(pts), train=True)
    assert tuple(got.shape) == (3, 128) and got.dtype == torch.float32
    _close(got.numpy(), want, 1e-4)
    for bn in ("bn1", "bn2"):
        mod = getattr(tmodel.encoder, bn)
        np.testing.assert_allclose(mod.running_mean.numpy(), new_stats[bn]["mean"], atol=1e-5)
        np.testing.assert_allclose(mod.running_var.numpy(), new_stats[bn]["var"], atol=1e-5)


def test_drop_path_scales_distribution():
    """Bernoulli(keep) / keep per sample and branch, rates on the
    reference's linspace ladder: block 0 never drops; a kept branch is
    scaled by exactly 1 / keep; the keep rate is the expected one within 4
    standard errors; eval and rate 0 give ones."""
    depth, B = 12, 4096
    rates = np.linspace(0.0, 0.1, depth).tolist()
    gen = torch.Generator().manual_seed(0)
    dp = drop_path_scales(rates, B, True, gen, "cpu")
    assert tuple(dp.shape) == (depth, B, 2) and dp.dtype == torch.float32
    assert bool((dp[0] == 1).all())
    for i in range(1, depth):
        keep = 1.0 - rates[i]
        vals = set(np.unique(dp[i].numpy()).tolist())
        assert vals <= {0.0, float(np.float32(1.0) / np.float32(keep))}, vals
        kept = float((dp[i] > 0).float().mean())
        assert abs(kept - keep) <= 4 * np.sqrt(keep * (1 - keep) / (2 * B)), (i, kept, keep)
        assert abs(float(dp[i].mean()) - 1.0) < 0.02  # the expectation is preserved
    assert bool((drop_path_scales(rates, B, False, gen, "cpu") == 1).all())
    assert bool((drop_path_scales([0.0] * 3, B, True, gen, "cpu") == 1).all())
    again = drop_path_scales(rates, B, True, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again, dp)


def test_pointbert_train_draws_droppath_from_the_generator():
    cfg = PointBertConfig(**dict(TINY, drop_path_rate=0.5))
    model = PointBert(cfg)
    gen = torch.Generator().manual_seed(0)
    for p in model.parameters():
        p.data.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    pts = torch.rand(4, 128, 3, generator=gen)
    with torch.no_grad():
        a = model(pts, train=True, generator=torch.Generator().manual_seed(1))
        b = model(pts, train=True, generator=torch.Generator().manual_seed(1))
        c = model(pts, train=True, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
