"""Port vs reference: GraphViT-3D and PointViT-Seg.

``ppt_torch.nn.graphvit`` / ``vitseg`` against ``ppt_tpu.nn.graphvit`` /
``vitseg`` at a small config (48 wide, 2 blocks, 4 heads, 16 groups of 8),
the same numpy inputs and weights (drawn on the port's module, carried into
the flax tree by the weight bridge's name rule; the cls token and position
drawn too), the JAX side jitted on the CPU, where its ``VitBlock`` runs
unfused; the port's runs route "block", whose plain version is
``vit_block_plain`` on the CPU. The clouds lie on a 1/64 lattice, so FPS,
kNN, the ball query and the 3-NN interpolation pick alike.

Within 1e-5 of the output's max magnitude (f32): ``PointPatchEmbed``'s
embeddings for every feature type with kNN and ball grouping (centres
exact), ``GraphVit3d``'s tokens and ``cls_feat``, ``PointVitSeg``'s eval
logits; its parameter gradients within 1e-4 of their max against
``jax.grad``, in eval and in training mode (the dropouts the identity).
Within 1e-4: training-mode forwards' running statistics (and logits; the
head's dropout the identity on both sides). Launches: one
``fps_batched`` and one ``fused_vit_block`` a block for GraphViT, the
FPS of each skip level for PointViT-Seg.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_classic import no_dropout  # noqa: F401 (a fixture)
from test_torch_pointnet2 import close, lattice_cloud, np_tree, stats_close
from test_torch_stratified import gradients_match_jax, pair_strat

from ppt_torch.kernels import group as kgroup
from ppt_torch.nn import graphvit as tgv
from ppt_torch.nn import pointbert as tpb
from ppt_torch.nn import vitseg as tvs

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores

GV_CFG = dict(encoder_dim=48, depth=2, num_heads=4, num_groups=16, group_size=8, embed_dim=16)


def clouds(B=2, N=128, seed=1, with_feats=True):
    pts = lattice_cloud(B, N, seed)
    return pts, (np.random.RandomState(seed + 1).rand(B, N, 3).astype(np.float32)
                 if with_feats else None)


def graphvit(**kw):
    from ppt_tpu.nn.graphvit import GraphVit3d, GraphVit3dConfig

    cfg = {**GV_CFG, **kw}
    return GraphVit3d(GraphVit3dConfig(**cfg)), tgv.GraphVit3d(tgv.GraphVit3dConfig(**cfg))


def vitseg():
    from ppt_tpu.nn.graphvit import GraphVit3dConfig
    from ppt_tpu.nn.vitseg import PointVitSeg, PointVitSegConfig

    kw = dict(num_classes=5, num_points=(64, 32), fp_width=16)
    return (PointVitSeg(PointVitSegConfig(encoder=GraphVit3dConfig(**GV_CFG), **kw)),
            tvs.PointVitSeg(tvs.PointVitSegConfig(encoder=tgv.GraphVit3dConfig(**GV_CFG), **kw)))


def run(jmod, tmod, xs, train=False, method=None, tmethod=None):
    """(port output, reference output, reference batch statistics or None)."""
    variables, tmod = pair_strat(jmod, tmod, *xs)
    jin = [None if x is None else jnp.asarray(x) for x in xs]
    tin = [None if x is None else torch.from_numpy(x) for x in xs]
    kw = {"method": method} if method else {}
    if train:
        want, mut = jax.jit(lambda v, *a: jmod.apply(v, *a, train=True, mutable=["batch_stats"],
                                                     **kw))(variables, *jin)
    else:
        want, mut = jax.jit(lambda v, *a: jmod.apply(v, *a, **kw))(variables, *jin), None
    with torch.no_grad():
        got = (getattr(tmod, tmethod) if tmethod else tmod)(*tin, train=train)
    if mut is not None:
        stats_close(tmod, np_tree(mut["batch_stats"]), variables["batch_stats"], atol=1e-4)
    return got, want


@pytest.mark.parametrize("group", ["knn", "ball"])
@pytest.mark.parametrize("feature_type", ["dp", "fj", "dp_fj", "df", "dp_df"])
def test_patch_embed_matches_flax(feature_type, group):
    from ppt_tpu.nn.graphvit import PointPatchEmbed

    kw = dict(num_groups=16, group_size=8, embed_dim=16, feature_type=feature_type, group=group,
              radius=0.3)
    got, want = run(PointPatchEmbed(**kw), tgv.PointPatchEmbed(3, **kw), clouds())
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    close(got[1].numpy(), want[1], 1e-5)


def test_patch_embed_training_mode_matches_flax():
    from ppt_tpu.nn.graphvit import PointPatchEmbed

    kw = dict(num_groups=16, group_size=8, embed_dim=16)
    got, want = run(PointPatchEmbed(**kw), tgv.PointPatchEmbed(3, **kw), clouds(), train=True)
    close(got[1].numpy(), want[1], 1e-4)


@pytest.mark.parametrize("with_feats", [True, False])
def test_graphvit_tokens_and_cls_feat_match_flax(with_feats):
    xs = clouds(with_feats=with_feats)
    got, want = run(*graphvit(), xs)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[1].dtype == torch.float32 and got[1].shape == (2, 17, 48)
    close(got[1].numpy(), want[1], 1e-5)
    jmod, tmod = graphvit()
    got, want = run(jmod, tmod, xs, method=jmod.cls_feat, tmethod="cls_feat")
    assert got.shape == (2, 96)
    close(got.numpy(), want, 1e-5)


def test_pointvitseg_eval_matches_flax():
    got, want = run(*vitseg(), clouds())
    assert got.shape == (2, 128, 5)
    close(got.numpy(), want, 1e-5)


def test_pointvitseg_training_mode_matches_flax(no_dropout, monkeypatch):
    monkeypatch.setattr(tvs, "dropout", lambda x, rate, train, generator: x)
    got, want = run(*vitseg(), clouds(seed=4), train=True)
    close(got.numpy(), want, 1e-4)


def test_pointvitseg_gradients_match_jax():
    """Every parameter's gradient of ``sum(logits * R)`` in eval mode,
    through each block's ``recompute_grad``, within 1e-4 of the max."""
    gradients_match_jax(*vitseg(), clouds(seed=6))


def test_pointvitseg_training_gradients_match_jax(no_dropout, monkeypatch):
    """The training-mode gradients (batch statistics in every BatchNorm,
    both packages' dropouts the identity): d/dparams of ``sum(logits * R)``
    for every parameter within 1e-4 of the max against ``jax.grad``."""
    from ppt_torch.convert import _port_key

    monkeypatch.setattr(tvs, "dropout", lambda x, rate, train, generator: x)
    jmod, tmod = vitseg()
    xs = clouds(seed=6)
    variables, tmod = pair_strat(jmod, tmod, *xs)
    jin = [jnp.asarray(x) for x in xs]
    r = np.random.RandomState(9).randn(2, 128, 5).astype(np.float32)

    def jloss(params):
        out, _ = jmod.apply({**variables, "params": params}, *jin, train=True,
                            mutable=["batch_stats"])
        return jnp.sum(out * r), out

    jgrads, jout = jax.jit(jax.grad(jloss, has_aux=True))(variables["params"])
    out = tmod(*[torch.from_numpy(x) for x in xs], train=True)
    close(out.detach().numpy(), jout, 1e-4)
    (out * torch.from_numpy(r)).sum().backward()
    grads = {k: p.grad for k, p in tmod.named_parameters()}
    want = jax.tree_util.tree_leaves_with_path(jgrads)
    scale = max(float(np.max(np.abs(np.asarray(g)))) for _, g in want)
    assert len(want) == len(grads)
    for path, g in want:
        key = _port_key(tuple(p.key for p in path), False)
        worst = float(np.max(np.abs(grads[key].numpy() - np.asarray(g))))
        assert worst <= 1e-4 * scale, (key, worst / scale)


def test_launches_a_forward(monkeypatch):
    """GraphViT: one FPS and one block kernel a block; PointViT-Seg adds
    one FPS a skip level, each from the full cloud."""
    fps, blocks = [], []
    real_fps, real_block = kgroup.fps_batched, tpb.fused_vit_block
    monkeypatch.setattr(kgroup, "fps_batched",
                        lambda x, n: fps.append((tuple(x.shape), n)) or real_fps(x, n))
    monkeypatch.setattr(tpb, "fused_vit_block",
                        lambda x, *a: blocks.append(tuple(x.shape)) or real_block(x, *a))
    pts, feats = (torch.from_numpy(x) for x in clouds())
    _, gv = graphvit()
    _, seg = vitseg()
    with torch.no_grad():
        gv(pts, feats)
        assert fps == [((2, 128, 3), 16)] and blocks == [(2, 17, 48)] * 2
        fps.clear()
        blocks.clear()
        seg(pts, feats)
    assert fps == [((2, 128, 3), 16), ((2, 128, 3), 64), ((2, 128, 3), 32)]
    assert blocks == [(2, 17, 48)] * 2


def test_refusals():
    with pytest.raises(ValueError, match="feature_type"):
        tgv.PointPatchEmbed(3, feature_type="xyz")
    _, gv = graphvit()
    with pytest.raises(ValueError, match="3-wide features, got 6"):
        gv(torch.zeros(1, 64, 3), torch.zeros(1, 64, 6))
