"""Port vs reference: ASSA (``ppt_torch.nn.assa`` against ``ppt_tpu.nn.assa``).

Every variant on the same numpy inputs and weights (drawn on the port's
module, carried into the flax tree by the weight bridge's name rule), the
JAX side jitted on the CPU: the anisotropic and ``dp_fj`` features, each
with ``mean`` / ``sum`` / ``max``, the residual with and without
``query_idx``, ``use_inverted_dims``, ``normalize_dp`` off, and one or two
pre-convs (the ``ceil(w / 3)`` channel plan). The support clouds lie on a
1/64 lattice, so the ball queries pick alike. Eval outputs within 1e-5 of
their max magnitude (f32); a training-mode forward's output and running
statistics within 1e-4.
"""

import numpy as np
import pytest
import torch

from test_torch_classic import randomise
from test_torch_graphvit import run
from test_torch_pointnet2 import close, lattice_cloud

from ppt_torch.nn import assa as tassa

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores

VARIANTS = [
    dict(feature_type="assa", reduction="mean"),
    dict(feature_type="assa", reduction="sum"),
    dict(feature_type="assa", reduction="max"),
    dict(feature_type="dp_fj", reduction="mean"),
    dict(feature_type="dp_fj", reduction="sum"),
    dict(feature_type="dp_fj", reduction="max"),
    dict(feature_type="assa", reduction="mean", use_inverted_dims=True),
    dict(feature_type="assa", reduction="max", normalize_dp=False),
    dict(feature_type="assa", reduction="mean", use_res=False),
    dict(feature_type="assa", reduction="mean", channels=(6, 9, 16)),
]


def inputs(query_idx=True, B=2, N=128, S=48, seed=1):
    support = lattice_cloud(B, N, seed)
    feats = np.random.RandomState(seed + 1).randn(B, N, 6).astype(np.float32)
    if not query_idx:  # the queries are the support set
        return support, support, feats, None
    qi = np.stack([np.sort(np.random.RandomState(seed + 2 + b).choice(N, S, replace=False))
                   for b in range(B)]).astype(np.int32)
    query = np.take_along_axis(support, qi[..., None].astype(np.int64), 1)
    return query, support, feats, qi


def modules(channels=(6, 12, 24, 32), **kw):
    from ppt_tpu.nn.assa import Assa

    kw = dict(radius=0.25, nsample=8, **kw)
    return Assa(channels, **kw), tassa.Assa(channels, **kw)


@pytest.mark.parametrize("query_idx", [True, False])
@pytest.mark.parametrize("variant", range(len(VARIANTS)))
def test_assa_matches_flax(variant, query_idx):
    got, want = run(*modules(**VARIANTS[variant]), inputs(query_idx))
    close(got.numpy(), want, 1e-5)


def test_assa_training_mode_matches_flax():
    got, want = run(*modules(), inputs(), train=True)
    close(got.numpy(), want, 1e-4)


def test_channel_plan():
    """``ceil(w / 3)`` before the anisotropic reduction unless the dims are
    inverted; the skip layer only where the widths differ."""
    _, t = modules()
    assert t.conv1.conv.kernel.shape == (12, 8) and t.conv2.conv.kernel.shape == (24, 32)
    assert t.skip_layer.kernel.shape == (8, 32)
    _, t = modules(use_inverted_dims=True)
    assert t.conv1.conv.kernel.shape == (12, 24) and t.conv2.conv.kernel.shape == (72, 32)
    _, t = modules(feature_type="dp_fj")
    assert t.conv2.conv.kernel.shape == (27, 32)
    with pytest.raises(ValueError, match="reduction"):
        modules(reduction="min")


def test_channel_order_is_axis_major():
    """The anisotropic features come out (coordinate axis, feature) with the
    axis major: a pass-through layer shows each axis's block."""
    _, t = modules(channels=(3, 9, 9), use_res=False, reduction="sum", normalize_dp=False)
    randomise(t, 0)
    q, s, f, _ = inputs(False)
    f = f[..., :3]
    with torch.no_grad():
        t.conv0.conv.kernel.copy_(torch.eye(3))
        t.conv0.bn.running_mean.zero_()
        t.conv0.bn.running_var.fill_(1.0 - t.conv0.bn.eps)
        t.conv0.bn.weight.fill_(1.0)
        t.conv0.bn.bias.zero_()
        captured = {}
        t.conv1.register_forward_pre_hook(lambda m, args: captured.update(x=args[0]))
        t(*[torch.from_numpy(x) for x in (q, s, f)])
    # neighbour sums of dp_a * relu(f_c): the block of axis a holds its 3 features
    from ppt_torch.ops.geometry import index_points, query_ball_point

    qt, st, ft = (torch.from_numpy(x) for x in (q, s, f))
    idx = query_ball_point(0.25, 8, st, qt)
    dp = index_points(st, idx) - qt[:, :, None]
    fj = index_points(torch.relu(ft), idx)
    want = torch.cat([(dp[..., a:a + 1] * fj).sum(2) for a in range(3)], -1)
    torch.testing.assert_close(captured["x"], want, rtol=1e-5, atol=1e-5)
