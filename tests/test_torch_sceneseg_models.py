"""Port vs reference: the scene-segmentation backbones.

``PointTransformerSeg`` (both block types), ``RandLANet`` and ``BaafNet``
(both ``farthest_knn`` settings) against ``ppt_tpu.nn`` at the reference
tests' small configs, random weights drawn on the port's module and
carried into the flax tree by the weight bridge's name rule
(``test_torch_classic.pair``), the same numpy inputs through both. The
coordinates lie on a 1/64 lattice, so every kNN, FPS and interpolation
distance is exact in f32 on both sides and the neighbourhoods are the
same (ties to the lower index).

Tolerances (f32): eval logits within 1e-5 of their max magnitude;
training mode within 1e-5 for RandLA-Net and BAAF-Net and within 1e-4 for
PTSeg, the running statistics within 1e-5. PTSeg's training mode is held
at a three-level config, where it reads 3e-5 (measured): its BatchNorms
over few points magnify the other summation order (at the reference's five
levels, 4 points (2 clouds x 2) and 4e-3 of the logits), while its eval
mode is held at the five levels. Each backbone's BatchNorms carry the
reference's momentum and eps, and the gradient test runs with the running
variances near 1e-6, where an eps off by ten moves the logits by a third.
The gradient of a fixed linear functional of the eval logits, against
``jax.grad``, within 1e-4 of the gradient's max magnitude (PTSeg's at the
three-level config, to keep the file's time down). The heads'
dropouts cannot be matched draw for draw: both are the identity here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_classic import no_dropout, pair, randomise, variables_from_port  # noqa: F401
from test_torch_pointnet2 import close, lattice_cloud, np_tree, stats_close

from ppt_torch.convert import _port_key
from ppt_torch.kernels import group as kgroup
from ppt_torch.nn import baafnet as tbf
from ppt_torch.nn import layers
from ppt_torch.nn import pointtransformer as tpt
from ppt_torch.nn import randlanet as trl

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores

PT_CFG = dict(blocks=(2, 2, 2, 2, 2), width=8, nsample=(4, 4, 4, 4, 2), in_channels=3,
              num_classes=13)
PT3_CFG = dict(blocks=(2, 2, 2), width=8, nsample=(4, 4, 4), strides=(1, 4, 4), in_channels=3,
               num_classes=13)
BAAF_CFG = dict(n_points=256, ds_ratio=4, k=4, num_classes=5, dims=(3, 4, 8, 16, 32))
RANDLA_CFG = dict(d_in=6, num_classes=6, num_neighbors=4)
# (momentum, eps) of every BatchNorm, flax's convention (pointtransformer.py:43-48,
# randlanet.py:36-42, flax's defaults for BAAF-Net)
BN_SETTINGS = {"ptseg": (0.9, 1e-5), "randlanet": (0.01, 1e-6), "baafnet": (0.99, 1e-5)}


@pytest.fixture
def quiet_dropout(no_dropout, monkeypatch):
    """``no_dropout`` for the scene modules too."""
    for mod in (trl, tbf):
        monkeypatch.setattr(mod, "dropout", lambda x, rate, train, generator: x)


def ptseg(cfg, block):
    from ppt_tpu.nn import PointTransformerConfig, PointTransformerSeg

    return (PointTransformerSeg(PointTransformerConfig(block=block, **cfg)),
            tpt.PointTransformerSeg(tpt.PointTransformerConfig(block=block, **cfg),
                                    feat_channels=3))


def randla():
    from ppt_tpu.nn import RandLANet, RandLANetConfig

    return RandLANet(RandLANetConfig(**RANDLA_CFG)), trl.RandLANet(trl.RandLANetConfig(
        **RANDLA_CFG))


def baaf(farthest):
    from ppt_tpu.nn import BaafNet, BaafNetConfig

    return (BaafNet(BaafNetConfig(farthest_knn=farthest, **BAAF_CFG)),
            tbf.BaafNet(tbf.BaafNetConfig(farthest_knn=farthest, **BAAF_CFG), feat_channels=3))


def inputs(name, N=512):
    if name == "randlanet":
        xyz = lattice_cloud(2, 256, 3)
        return [np.concatenate([xyz, np.random.RandomState(4).rand(2, 256, 3)], -1)
                .astype(np.float32)]
    n = 256 if name == "baafnet" else N
    return [lattice_cloud(2, n, 1), np.random.RandomState(2).rand(2, n, 3).astype(np.float32)]


def compare(jmod, tmod, xs, train, tol):
    variables, tmod = pair(jmod, tmod, *xs)
    jin = [jnp.asarray(x) for x in xs]
    tin = [torch.from_numpy(x) for x in xs]
    if not train:
        want = jax.jit(lambda v, *a: jmod.apply(v, *a))(variables, *jin)
        with torch.no_grad():
            got = tmod(*tin)
        close(got.numpy(), want, tol)
        return variables, tmod
    want, mutated = jax.jit(lambda v, *a: jmod.apply(v, *a, train=True, mutable=["batch_stats"])
                            )(variables, *jin)
    with torch.no_grad():
        got = tmod(*tin, train=True)
    close(got.numpy(), want, tol)
    stats_close(tmod, np_tree(mutated["batch_stats"]), variables["batch_stats"])
    return variables, tmod


@pytest.mark.parametrize("block", ["PointTransformerBlock", "EdgeConvBlock"])
def test_ptseg_eval_matches_flax(block):
    compare(*ptseg(PT_CFG, block), inputs("ptseg"), False, 1e-5)


@pytest.mark.parametrize("block", ["PointTransformerBlock", "EdgeConvBlock"])
def test_ptseg_training_mode_matches_flax(block):
    compare(*ptseg(PT3_CFG, block), inputs("ptseg", 256), True, 1e-4)


def test_randlanet_training_mode_matches_flax(quiet_dropout):
    compare(*randla(), inputs("randlanet"), True, 1e-5)


@pytest.mark.parametrize("farthest,train", [(False, False), (False, True), (True, True)])
def test_baafnet_matches_flax(farthest, train, quiet_dropout):
    """(RandLA-Net's eval mode and BAAF-Net's with ``farthest_knn`` are held
    by ``test_eval_logits_and_gradient_match_jax``.)"""
    compare(*baaf(farthest), inputs("baafnet"), train, 1e-5)


@pytest.mark.parametrize("name", ["ptseg", "randlanet", "baafnet"])
def test_eval_logits_and_gradient_match_jax(name, quiet_dropout):
    """The eval logits (within 1e-5), and d/dparams of ``sum(logits * R)``
    (R fixed), every parameter, against ``jax.grad`` of the same
    functional (one compile for both). Every BatchNorm has the reference's
    momentum and eps, and the running variances are cut to about 1e-6
    (the scales by 1e-3, to keep the magnitudes), so that eps weighs in
    the normalisation: RandLA-Net at eps 1e-5 is off by 0.33 of the logits
    here (measured)."""
    jmod, tmod = {"ptseg": lambda: ptseg(PT3_CFG, "PointTransformerBlock"),
                  "randlanet": randla, "baafnet": lambda: baaf(True)}[name]()
    xs = inputs(name, 256)
    variables, tmod = pair(jmod, tmod, *xs)
    bns = [m for m in tmod.modules() if isinstance(m, layers.BatchNormStats)]
    assert bns and {(m.momentum, m.eps) for m in bns} == {BN_SETTINGS[name]}
    with torch.no_grad():
        for m in bns:
            m.running_var.mul_(1e-6)
            m.weight.mul_(1e-3)
    variables = variables_from_port(variables, tmod)
    with torch.no_grad():
        shape = tmod(*[torch.from_numpy(x) for x in xs]).shape
    r = np.random.RandomState(9).randn(*shape).astype(np.float32)
    jin = [jnp.asarray(x) for x in xs]

    def jloss(params):
        logits = jmod.apply({"params": params, "batch_stats": variables["batch_stats"]}, *jin)
        return jnp.sum(logits * r), logits

    jgrads, jlogits = jax.jit(jax.grad(jloss, has_aux=True))(variables["params"])
    want = jax.tree_util.tree_leaves_with_path(jgrads)
    logits = tmod(*[torch.from_numpy(x) for x in xs])
    close(logits.detach().numpy(), jlogits, 1e-5)
    (logits * torch.from_numpy(r)).sum().backward()
    grads = {k: p.grad for k, p in tmod.named_parameters()}
    scale = max(float(np.max(np.abs(np.asarray(g)))) for _, g in want)
    worst = 0.0
    for path, g in want:
        key = _port_key(tuple(p.key for p in path), False)
        worst = max(worst, float(np.max(np.abs(grads[key].numpy() - np.asarray(g)))))
    assert len(want) == len(grads)
    assert worst <= 1e-4 * scale, worst / scale


def test_fps_launches_a_forward(monkeypatch):
    """PTSeg's four strided transitions each call ``fps_batched`` once on
    the [B, n, 3] view; BAAF-Net calls it once a level on its own sample
    counts."""
    seen = []
    real = kgroup.fps_batched
    monkeypatch.setattr(kgroup, "fps_batched",
                        lambda x, n: seen.append((tuple(x.shape), n)) or real(x, n))
    with torch.no_grad():
        pair(*ptseg(PT_CFG, "PointTransformerBlock"), *inputs("ptseg"))[1](
            *[torch.from_numpy(x) for x in inputs("ptseg")])
    assert seen == [((2, 512, 3), 128), ((2, 128, 3), 32), ((2, 32, 3), 8), ((2, 8, 3), 2)]
    seen.clear()
    with torch.no_grad():
        pair(*baaf(False), *inputs("baafnet"))[1](
            *[torch.from_numpy(x) for x in inputs("baafnet")])
    assert seen == [((2, 256, 3), 64), ((2, 64, 3), 16), ((2, 16, 3), 4)]


def test_ptseg_refuses_a_size_the_strides_do_not_divide():
    _, tmod = ptseg(PT_CFG, "PointTransformerBlock")
    with pytest.raises(ValueError, match="divisible by 256"):
        tmod.levels(300)
    assert tmod.levels(512) == [(512, 4, 4), (128, 4, 4), (32, 4, 4), (8, 4, 4), (2, 2, 2)]


def test_randlanet_permuted_decimation():
    """``deterministic_perm=False``: a seeded permutation from the caller's
    generator, the output back in input order; the default slices the
    input order (the scene driver's path)."""
    tmod = pair(*randla(), *inputs("randlanet"))[1]
    x = torch.from_numpy(inputs("randlanet")[0])
    with torch.no_grad():
        got = tmod(x, generator=torch.Generator().manual_seed(3), deterministic_perm=False)
        perm = torch.randperm(x.shape[1], generator=torch.Generator().manual_seed(3))
        want = tmod(x[:, perm])[:, torch.argsort(perm)]
        plain = tmod(x)
    assert torch.equal(got, want)
    assert not torch.equal(got, plain)


def test_batchnorm_eps_default_is_bit_unchanged():
    """``BatchNorm``/``BatchNormStats`` took eps as an argument: at the
    default 1e-5 the existing towers' outputs (eval and training mode, the
    moved statistics) and ``fold`` are bit-identical to the code with the
    constant written in."""
    from ppt_torch.nn.classic import PointNetClassic
    from ppt_torch.nn.pointnet2 import PointNet2Ssg

    def old_forward(self, x, train=False):
        x = x.float()
        if train:
            flat = x.reshape(-1, x.shape[-1])
            mean = flat.mean(0)
            var = torch.clamp_min((flat * flat).mean(0) - mean * mean, 0.0)
            self.update_running(mean.detach(), var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + 1e-5) * self.weight) + self.bias

    x = torch.from_numpy(lattice_cloud(4, 600, 5))
    for make in (PointNetClassic, PointNet2Ssg):
        outs = []
        for forward in (layers.BatchNorm.forward, old_forward):
            tower = make()
            randomise(tower, 7)
            saved = layers.BatchNorm.forward
            layers.BatchNorm.forward = forward
            try:
                with torch.no_grad():
                    outs.append([tower(x), tower(x, True, torch.Generator().manual_seed(1)),
                                 [b.clone() for b in tower.buffers()]])
            finally:
                layers.BatchNorm.forward = saved
        assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
        assert all(torch.equal(a, b) for a, b in zip(outs[0][2], outs[1][2]))
    bn = layers.BatchNormStats(8)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.running_var.uniform_(0.0, 2.0)
    scale, shift = bn.fold()
    assert torch.equal(scale, bn.weight / torch.sqrt(bn.running_var + 1e-5))
    assert torch.equal(shift, bn.bias - bn.running_mean * scale)
    assert layers.BatchNormStats(8, eps=1e-6).eps == 1e-6

