"""SimpleView: six depth views of the cloud through a thin ResNet18.

Counterpart of ``ppt_tpu/nn/simpleview.py`` (the reference's MVModel +
MVFC, and PCViews' six orthographic cameras): the projection splats every
point into each view's ``R x R`` canvas with inverse-depth weights, a
3x3 stem + ``ResNetStages`` run over the ``B * 6`` images (NHWC), and the
MVFC head fuses the views into class logits. Module and parameter names
mirror the flax tree (``stem_conv``, ``backbone/layer1_0/conv1``,
``fc_bn0``, ``fc2``), so ``ppt_torch.convert.from_jax`` maps every leaf.

The traps, kept from the reference:
- pixels are ``ceil(c - 0.5)``; an out-of-range pixel wraps by
  ``remainder`` (``jnp.mod``: non-negative, not ``fmod``) and the in-range
  mask zeroes its weight; a pixel no point lands on reads depth 0;
- the splat scatter-adds in f32 (``index_add_``): on the card the atomic
  adds sum in another order, so a canvas agrees within rounding, not bit
  for bit;
- the cameras sit at ``TRANS = -1.4``, ``RESOLUTION = 128``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ppt_torch.nn.layers import BatchNorm, Dense, dropout
from ppt_torch.nn.resnet import Conv, ResNetStages

RESOLUTION = 128
TRANS = -1.4


def _euler2mat(angles: np.ndarray) -> np.ndarray:
    """XYZ euler rotations, ``R = Rx @ Ry @ Rz`` (``euler2mat``)."""
    out = []
    for x, y, z in angles:
        cz, sz = np.cos(z), np.sin(z)
        cy, sy = np.cos(y), np.sin(y)
        cx, sx = np.cos(x), np.sin(x)
        zmat = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        ymat = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        xmat = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        out.append(xmat @ ymat @ zmat)
    return np.stack(out)


def _pc_views() -> Tuple[np.ndarray, np.ndarray]:
    """The six camera poses (``PCViews.__init__``): ``(rot [6, 3, 3]``
    transposed, ``trans [6, 3])`` f32."""
    views = np.asarray([
        [[0 * np.pi / 2, 0, np.pi / 2], [0, 0, TRANS]],
        [[1 * np.pi / 2, 0, np.pi / 2], [0, 0, TRANS]],
        [[2 * np.pi / 2, 0, np.pi / 2], [0, 0, TRANS]],
        [[3 * np.pi / 2, 0, np.pi / 2], [0, 0, TRANS]],
        [[0, -np.pi / 2, np.pi / 2], [0, 0, TRANS]],
        [[0, np.pi / 2, np.pi / 2], [0, 0, TRANS]],
    ])
    rot = _euler2mat(views[:, 0, :]).transpose(0, 2, 1)
    return rot.astype(np.float32), views[:, 1, :].astype(np.float32)


def points_to_depth_views(points: torch.Tensor, resolution: int = RESOLUTION) -> torch.Tensor:
    """``[B, N, 3]`` -> ``[B * 6, R, R]`` f32 depth images; image ``b * 6 +
    v`` is view ``v`` of cloud ``b`` (``ppt_tpu/nn/simpleview.py:69-109``)."""
    B, N, _ = points.shape
    rot, trans = (torch.from_numpy(a).to(points.device) for a in _pc_views())
    V = rot.shape[0]
    p = points.float()[:, None].expand(B, V, N, 3).reshape(B * V, N, 3)
    p = torch.bmm(p, rot.repeat(B, 1, 1)) - trans.repeat(B, 1)[:, None, :]
    R, eps = resolution, 1e-12
    depth = p[:, :, 2]
    px = torch.ceil((p[:, :, 0] / (depth + eps) + 1.0) * R / 2.0 - 0.5)
    py = torch.ceil((p[:, :, 1] / (depth + eps) + 1.0) * R / 2.0 - 0.5)
    valid = (px >= 0) & (px <= R - 1) & (py >= 0) & (py <= R - 1) & (depth >= 0)
    ix = torch.remainder(px, R).long()
    iy = torch.remainder(py, R).long()
    w = valid.float() / (depth + eps)
    base = torch.arange(B * V, device=points.device)[:, None] * (R * R)
    flat = (base + ix * R + iy).reshape(-1)
    wsum = torch.zeros(B * V * R * R, device=points.device).index_add_(0, flat, w.reshape(-1))
    vsum = torch.zeros(B * V * R * R, device=points.device).index_add_(
        0, flat, (depth * w).reshape(-1))
    wsum = torch.where(wsum == 0.0, torch.ones_like(wsum), wsum)
    return (vsum / wsum).reshape(B * V, R, R)


@dataclasses.dataclass(frozen=True)
class SimpleViewConfig:
    num_classes: int = 15
    channels: int = 16  # the thin ResNet's stem width (``MVModel(channels=16)``)
    resolution: int = RESOLUTION
    dropout: float = 0.5
    layers: Tuple[int, ...] = (2, 2, 2, 2)


class SimpleView(nn.Module):
    """MVModel (``ppt_tpu/nn/simpleview.py:121-155``): project, a shared CNN
    over the six views, the MVFC head; ``[B, N, 3]`` -> ``[B, classes]`` in
    the compute dtype."""

    VIEWS = 6

    def __init__(self, config: SimpleViewConfig = SimpleViewConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        self.stem_conv = Conv(1, cfg.channels, (3, 3), 1, 1, dtype=dtype)
        self.stem_bn = BatchNorm(cfg.channels)
        self.backbone = ResNetStages(cfg.layers, cfg.channels, zero_init_residual=True,
                                     dtype=dtype)
        feat = cfg.channels * 8
        self.fc_bn0 = BatchNorm(feat)
        self.fc1 = Dense(self.VIEWS * feat, feat, dtype=dtype)
        self.fc_bn1 = BatchNorm(feat)
        self.fc2 = Dense(feat, cfg.num_classes, dtype=dtype)

    def forward(self, pts: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.config
        B = pts.shape[0]
        img = points_to_depth_views(pts.float(), cfg.resolution)[..., None].to(self.dtype)
        h = torch.relu(self.stem_bn(self.stem_conv(img), train))
        feat = self.backbone(h, train)  # [B * 6, channels * 8]
        f = self.fc_bn0(feat.reshape(B, self.VIEWS, -1), train)
        f = dropout(f, cfg.dropout, train, generator).reshape(B, -1)
        f = dropout(torch.relu(self.fc_bn1(self.fc1(f), train)), cfg.dropout, train, generator)
        return self.fc2(f)
