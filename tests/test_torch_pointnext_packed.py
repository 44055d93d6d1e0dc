"""Port vs reference: PointNeXt over packed clouds.

``ppt_torch.nn.pointnext_packed.PointNextPacked`` against
``ppt_tpu.nn.pointnext_packed`` (the same numpy clouds and weights, drawn on
the port's module, carried into the flax tree by the weight bridge's name
rule; the JAX side jitted on the CPU) and against the port's batched
``PointNext`` with the same ``state_dict``. The clouds lie on a 1/64
lattice, so the packed ball query's expanded-form distances and the
batched kernel's plain version pick the same neighbours. Eval features
within 1e-5 of their max magnitude (f32); a training-mode forward's
features and running statistics within 1e-4 (the head's dropout the
identity on both sides).
"""

import numpy as np
import pytest
import torch

from test_torch_classic import no_dropout, randomise  # noqa: F401 (a fixture)
from test_torch_graphvit import run
from test_torch_pointnet2 import close, lattice_cloud

from ppt_torch.kernels import group as kgroup
from ppt_torch.nn import pointnext as tpn
from ppt_torch.nn import pointnext_packed as tpp

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores

CFG = dict(width=8, nsample=8, head_mlps=(32, 16))
B, N = 2, 128


def modules(**kw):
    from ppt_tpu.nn.pointnext import PointNextConfig
    from ppt_tpu.nn.pointnext_packed import PointNextPacked

    cfg = {**CFG, **kw}
    return PointNextPacked(PointNextConfig(**cfg)), tpp.PointNextPacked(tpn.PointNextConfig(**cfg))


def clouds(seed=1):
    pts = lattice_cloud(B, N, seed, channels=4)
    return pts.reshape(B * N, 4), np.arange(1, B + 1, dtype=np.int32) * N


def test_packed_matches_flax():
    got, want = run(*modules(), clouds())
    assert got.shape == (B, 16)
    close(got.numpy(), want, 1e-5)


def test_packed_training_mode_matches_flax(no_dropout, monkeypatch):
    monkeypatch.setattr(tpp, "dropout", lambda x, rate, train, generator: x)
    got, want = run(*modules(), clouds(seed=3), train=True)
    close(got.numpy(), want, 1e-4)


def test_packed_matches_the_batched_port():
    """One ``state_dict`` drives both; the offsets as ints or a tensor."""
    pts, offsets = clouds(seed=5)
    _, packed = modules()
    randomise(packed, 7)
    batched = tpn.PointNext(tpn.PointNextConfig(**CFG))
    batched.load_state_dict(packed.state_dict())
    with torch.no_grad():
        want = batched(torch.from_numpy(pts).reshape(B, N, 4))
        got = packed(torch.from_numpy(pts), [int(o) for o in offsets])
        again = packed(torch.from_numpy(pts), torch.from_numpy(offsets))
    close(got.numpy(), want.numpy(), 1e-5)
    assert torch.equal(got, again)


def test_fps_launches_and_refusals(monkeypatch):
    """One FPS a strided stage on the [B, n, 3] view; depth blocks and
    clouds of different sizes refused."""
    seen = []
    real = kgroup.fps_batched
    monkeypatch.setattr(kgroup, "fps_batched",
                        lambda x, n: seen.append((tuple(x.shape), n)) or real(x, n))
    _, packed = modules()
    randomise(packed, 7)
    pts, offsets = clouds()
    with torch.no_grad():
        packed(torch.from_numpy(pts), offsets.tolist())
    assert seen == [((2, 128, 3), 64), ((2, 64, 3), 32), ((2, 32, 3), 16), ((2, 16, 3), 8)]
    with pytest.raises(NotImplementedError, match="depth blocks"):
        tpp.PointNextPacked(tpn.PointNextConfig(blocks=(1, 2, 1, 1, 1, 1)))
    with pytest.raises(ValueError, match="one size"):
        packed(torch.from_numpy(pts), [100, 256])
