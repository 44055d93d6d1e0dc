"""Port vs reference: SimpleView and the ResNet stages it runs.

``BasicBlock``, ``Bottleneck``, ``ResNetStages``, ``points_to_depth_views``
and ``SimpleView`` against ``ppt_tpu/nn/resnet.py`` and
``ppt_tpu/nn/simpleview.py``: random weights carried across by the weight
bridge (``test_torch_classic.pair``: the NHWC ``Conv`` kernels keep flax's
HWIO layout, so no leaf needs a rule), the same numpy inputs through both,
tolerances as ``test_torch_classic.py``. The depth views scatter-add in f32
in both packages, in another order: within 1e-6 of the canvas's scale.
The ResNet's BatchNorms move with momentum 0.9, the head's with 0.99.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_classic import dts, eval_and_train, no_dropout, pair  # noqa: F401 (a fixture)
from test_torch_pointnet2 import close

from ppt_torch.nn import resnet as trn
from ppt_torch.nn import simpleview as tsv

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores

SMALL = dict(num_classes=7, channels=8, resolution=32, layers=(1, 1, 1, 1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block,stride,inplanes,planes", [
    ("basic", 1, 8, 8), ("basic", 2, 8, 16), ("bottleneck", 1, 8, 4), ("bottleneck", 2, 16, 8)])
def test_blocks_match_flax(block, stride, inplanes, planes, dtype):
    import ppt_tpu.nn.resnet as jrn

    tdt, jdt = dts(dtype)
    x = np.random.RandomState(1).randn(8, 9, 9, inplanes).astype(np.float32)
    jcls, tcls = ((jrn.BasicBlock, trn.BasicBlock) if block == "basic"
                  else (jrn.Bottleneck, trn.Bottleneck))
    ds = stride != 1 or inplanes != planes * tcls.expansion
    jmod = jcls(planes, stride=stride, downsample=ds, dtype=jdt)
    variables, tmod = pair(jmod, tcls(inplanes, planes, stride, ds, dtype=tdt), x)
    got = eval_and_train(jmod, tmod, variables, [x], dtype)
    side = 9 if stride == 1 else 5
    assert got.shape == (8, side, side, planes * tcls.expansion)
    assert hasattr(tmod, "ds_conv") == ds


def test_resnet_batchnorm_momentum_and_zero_init():
    """The stages' BatchNorms move with momentum 0.9; ``zero_init_residual``
    zeroes each block's last scale."""
    stages = trn.ResNetStages((1, 1), 4, zero_init_residual=True)
    assert all(m.momentum == 0.9 for m in stages.modules() if isinstance(m, trn.BatchNorm))
    assert torch.equal(stages.layer1_0.bn2.weight, torch.zeros(4))
    assert torch.equal(stages.layer2_0.bn1.weight, torch.ones(8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", ["basic", "bottleneck"])
def test_resnet_stages_match_flax(block, dtype):
    import ppt_tpu.nn.resnet as jrn

    tdt, jdt = dts(dtype)
    x = np.random.RandomState(2).randn(8, 16, 16, 8).astype(np.float32)
    jmod = jrn.ResNetStages((2, 1, 1, 1), 8, block=block, dtype=jdt)
    tmod = trn.ResNetStages((2, 1, 1, 1), 8, block=block, dtype=tdt)
    variables, tmod = pair(jmod, tmod, x)
    got = eval_and_train(jmod, tmod, variables, [x], dtype)
    assert got.shape == (8, 64 * (1 if block == "basic" else 4))


def test_camera_poses_match_the_reference():
    from ppt_tpu.nn import simpleview as jsv

    for got, want in zip(tsv._pc_views(), jsv._pc_views()):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("resolution", [128, 32])
def test_depth_views_match_flax(resolution):
    """Six views a cloud at the default 128 and at 32, points outside the
    unit cube among them (their pixels wrap by ``remainder`` and weigh 0)."""
    from ppt_tpu.nn.simpleview import points_to_depth_views as jax_views

    pts = (np.random.RandomState(3).rand(3, 500, 3) * 2.4 - 1.2).astype(np.float32)
    got = tsv.points_to_depth_views(torch.from_numpy(pts), resolution)
    want = np.asarray(jax_views(jnp.asarray(pts), resolution))
    assert got.shape == (18, resolution, resolution) and got.dtype == torch.float32
    close(got.numpy(), want, 1e-6)
    assert (want == 0).any() and (want > 0).any()
    np.testing.assert_array_equal(got.numpy() == 0, want == 0)


def test_canvas_index_is_remainder_not_fmod():
    """A pixel left of the canvas wraps to the right edge, as ``jnp.mod``
    wraps it; ``fmod`` would keep it negative."""
    assert torch.remainder(torch.tensor(-1.0), 32) == 31
    assert torch.fmod(torch.tensor(-1.0), 32) == -1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_simpleview_matches_flax(dtype, no_dropout):
    """The whole model at a small config (8-wide stem, one block a stage,
    32 x 32 views), eval and (f32) training mode; the logits in the compute
    dtype."""
    import ppt_tpu.nn.simpleview as jsv

    tdt, jdt = dts(dtype)
    pts = (np.random.RandomState(4).rand(16, 256, 3) * 2 - 1).astype(np.float32)
    jmod = jsv.SimpleView(jsv.SimpleViewConfig(**SMALL), dtype=jdt)
    variables, tmod = pair(jmod, tsv.SimpleView(tsv.SimpleViewConfig(**SMALL), dtype=tdt), pts)
    got = eval_and_train(jmod, tmod, variables, [pts], dtype)
    assert got.shape == (16, 7) and got.dtype == tdt


def test_simpleview_full_width_eval_matches_flax():
    """The default config (16-wide ResNet18, 128 x 128 views, 15 classes)."""
    import ppt_tpu.nn.simpleview as jsv

    pts = (np.random.RandomState(5).rand(2, 512, 3) * 2 - 1).astype(np.float32)
    jmod = jsv.SimpleView()
    variables, tmod = pair(jmod, tsv.SimpleView(), pts)
    got = eval_and_train(jmod, tmod, variables, [pts], "float32", train=False)
    assert got.shape == (2, 15)
