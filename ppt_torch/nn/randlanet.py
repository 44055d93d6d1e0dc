"""RandLA-Net, the scene-segmentation encoder/decoder over random decimation.

Counterpart of ``ppt_tpu/nn/randlanet.py``, channels-last ``[B, N, C]``:
Local Feature Aggregation blocks (a kNN spatial encoding, attentive
pooling twice, a shortcut) at four levels, each level keeping the first
quarter of the points, then 1-NN upsampling with skip concatenation and a
head. Module and parameter names mirror the flax tree
(``encoder_0/lse1/mlp/conv``, ``encoder_2/pool2/score_fn``,
``decoder_3/bn``, ``fc_end_3/conv``, ...), so
``ppt_torch.convert.from_jax`` maps every leaf.

The traps:
- BatchNorm here is the reference's ``BatchNorm2d(eps=1e-6,
  momentum=0.99)``, so flax momentum 0.01 and eps **1e-6**;
- the kNN is ``ops/geometry.py:knn_point`` (nearest first, ties to the
  lower index, the expanded-form distance), plain XLA in the reference;
  the spatial encoding's distances are Euclidean;
- the decimation slices the input order: the scene driver never asks for
  the permutation (``deterministic_perm`` stays True); a caller that does
  gets a seeded ``torch.randperm`` from its generator and the output back
  in input order;
- ``fc_start`` takes the whole input row (xyz + rgb: ``config.d_in``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ppt_torch.nn.layers import BatchNorm, Dense, dropout, leaky_relu
from ppt_torch.ops import geometry as ops

BN_MOMENTUM = 0.01  # torch momentum 0.99
BN_EPS = 1e-6


def _bn(width: int) -> BatchNorm:
    return BatchNorm(width, momentum=BN_MOMENTUM, eps=BN_EPS)


class SharedMLP(nn.Module):
    """A 1x1 convolution (+ BatchNorm, + activation) over channels-last
    tensors (``ppt_tpu/nn/randlanet.py:45-65``)."""

    def __init__(self, in_features: int, features: int, bn: bool = False,
                 act: Optional[str] = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act = act
        self.conv = Dense(in_features, features, dtype=dtype)
        if bn:
            self.bn = _bn(features)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.conv(x)
        if hasattr(self, "bn"):
            x = self.bn(x, train)
        if self.act == "relu":
            return torch.relu(x)
        if self.act == "lrelu02":
            return leaky_relu(x, 0.2)
        if self.act == "lrelu":
            return leaky_relu(x, 0.01)
        return x


class LocalSpatialEncoding(nn.Module):
    """``[center, neighbour, center - neighbour, |center - neighbour|]``
    through a SharedMLP, beside the running features: ``[B, N, K, 2d]``."""

    def __init__(self, d: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.mlp = SharedMLP(10, d, bn=True, act="relu", dtype=dtype)

    def forward(self, coords, features, idx, dist, train: bool = False) -> torch.Tensor:
        nbrs = ops.index_points(coords, idx)  # [B, N, K, 3]
        center = coords[:, :, None, :].expand_as(nbrs)
        enc = torch.cat([center, nbrs, center - nbrs, dist[..., None]], dim=-1).to(self.dtype)
        enc = self.mlp(enc, train)
        feat = features[:, :, None, :].expand(*idx.shape, features.shape[-1])
        return torch.cat([enc, feat], dim=-1)


class AttentivePooling(nn.Module):
    """Softmax pooling over the neighbours, then a SharedMLP:
    ``[B, N, K, C]`` -> ``[B, N, 1, out]``."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.score_fn = Dense(in_features, in_features, bias=False, dtype=dtype)
        self.mlp = SharedMLP(in_features, out_features, bn=True, act="relu", dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        scores = torch.softmax(self.score_fn(x), dim=2)  # over K
        return self.mlp((scores * x).sum(2, keepdim=True), train)


class LocalFeatureAggregation(nn.Module):
    """The dilated residual block: ``[B, N, 1, d_in]`` -> ``[B, N, 1, 2 d_out]``."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        h = d_out // 2
        self.mlp1 = SharedMLP(d_in, h, act="lrelu02", dtype=dtype)
        self.lse1 = LocalSpatialEncoding(h, dtype=dtype)
        self.pool1 = AttentivePooling(2 * h, h, dtype=dtype)
        self.lse2 = LocalSpatialEncoding(h, dtype=dtype)
        self.pool2 = AttentivePooling(2 * h, d_out, dtype=dtype)
        self.mlp2 = SharedMLP(d_out, 2 * d_out, dtype=dtype)
        self.shortcut = SharedMLP(d_in, 2 * d_out, bn=True, dtype=dtype)

    def forward(self, coords: torch.Tensor, features: torch.Tensor, num_neighbors: int,
                train: bool = False) -> torch.Tensor:
        idx = ops.knn_point(num_neighbors, coords, coords)
        d = ops.index_points(coords, idx) - coords[:, :, None, :]
        dist = torch.sqrt((d * d).sum(-1))  # Euclidean, as torch_points' knn returns
        x = self.mlp1(features, train)
        x = self.pool1(self.lse1(coords, x[:, :, 0], idx, dist, train), train)
        x = self.pool2(self.lse2(coords, x[:, :, 0], idx, dist, train), train)
        x = self.mlp2(x, train)
        return leaky_relu(x + self.shortcut(features, train), 0.01)


@dataclasses.dataclass(frozen=True)
class RandLANetConfig:
    d_in: int = 3  # the input row's width: xyz, or xyz + rgb
    num_classes: int = 13
    num_neighbors: int = 16
    decimation: int = 4
    widths: Tuple[int, ...] = (16, 64, 128, 256)  # each LFA doubles its width


DECODER_WIDTHS = (256, 128, 32, 8)


class RandLANet(nn.Module):
    """``forward(pts [B, N, d_in]) -> [B, N, classes]``; the first three
    channels are the coordinates."""

    def __init__(self, config: RandLANetConfig = RandLANetConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        self.fc_start = Dense(cfg.d_in, 8, dtype=dtype)
        self.bn_start = _bn(8)
        width, skips = 8, []
        for i, w in enumerate(cfg.widths):
            self.add_module(f"encoder_{i}", LocalFeatureAggregation(width, w, dtype=dtype))
            width = 2 * w
            skips.append(width)
        self.mlp = SharedMLP(width, 2 * cfg.widths[-1], act="relu", dtype=dtype)
        width = 2 * cfg.widths[-1]
        for i, w in enumerate(DECODER_WIDTHS):
            self.add_module(f"decoder_{i}", SharedMLP(width + skips[-1 - i], w, bn=True,
                                                      act="relu", dtype=dtype))
            width = w
        self.fc_end_0 = SharedMLP(width, 64, bn=True, act="relu", dtype=dtype)
        self.fc_end_1 = SharedMLP(64, 32, bn=True, act="relu", dtype=dtype)
        self.fc_end_3 = SharedMLP(32, cfg.num_classes, dtype=dtype)

    def forward(self, pts: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                deterministic_perm: bool = True) -> torch.Tensor:
        cfg = self.config
        B, N, _ = pts.shape
        d = cfg.decimation
        if not deterministic_perm:
            perm = torch.randperm(N, generator=generator, device=pts.device)
            pts = pts[:, perm]
        coords = pts[..., :3].float()
        x = leaky_relu(self.bn_start(self.fc_start(pts), train), 0.2)[:, :, None, :]

        n_lvl = len(cfg.widths)
        counts = [N // d ** i for i in range(n_lvl + 1)]
        skips = []
        for i in range(n_lvl):
            k = min(cfg.num_neighbors, counts[i])  # the deep levels' static clamp
            x = getattr(self, f"encoder_{i}")(coords[:, :counts[i]], x, k, train)
            skips.append(x)
            x = x[:, :counts[i + 1]]
        x = self.mlp(x, train)

        for i in range(len(DECODER_WIDTHS)):
            lvl = n_lvl - i
            nn_idx = ops.knn_point(1, coords[:, :counts[lvl]], coords[:, :counts[lvl - 1]])
            up = ops.index_points(x[:, :, 0], nn_idx[..., 0])[:, :, None, :]
            x = getattr(self, f"decoder_{i}")(torch.cat([up, skips.pop()], dim=-1), train)

        x = self.fc_end_1(self.fc_end_0(x, train), train)
        x = self.fc_end_3(dropout(x, 0.5, train, generator), train)
        out = x[:, :, 0, :]
        if not deterministic_perm:
            out = out[:, torch.argsort(perm)]
        return out
