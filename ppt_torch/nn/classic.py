"""Classic point-cloud backbones: PointNet (with and without T-Nets) and
the DGCNN classifier, channels-last.

Counterpart of ``ppt_tpu/nn/classic.py``: every shared MLP is Dense +
BatchNorm over the last axis (Dense in the compute dtype, BatchNorm
statistics, affine and output in f32), as in ``nn/pointmlp.py``. Module
and parameter names mirror the flax tree (``conv0``/``bn0``, ``stn/conv1``,
``fstn/fc3``, ``edge0``/``bn0``, ``emb``/``embn``, ``fc1``/``fbn1``, ...),
so ``ppt_torch.convert.from_jax`` maps every leaf one to one. No kernel
lies on these towers: the reference runs their kNN as XLA, so the port's
is ``ops/geometry.py:knn_point`` (the expanded-form distance sorted
stably, ties to the lower index, as ``lax.top_k``).

The traps:
- ``Tnet`` adds the identity to its last layer's output in the compute
  dtype;
- ``PointNetEncoder``'s input STN sees every channel but turns only the 3
  coordinates (extra channels pass untouched); the feature STN's product
  runs in f32 (the BatchNorm output, with the transform promoted); no ReLU
  follows the last BatchNorm;
- ``DgcnnClassifier``'s kNN is in feature space from the second stage on,
  and its edge feature is ``[neighbor - center, center]`` (the reference's
  converter swaps the halves of the published kernels to fit);
- the heads' dropouts draw from the ``generator`` given in training mode,
  as the other towers' do.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ppt_torch.nn.layers import BatchNorm, Dense, dropout, leaky_relu
from ppt_torch.ops import geometry as ops


class PointNetClassic(nn.Module):
    """Vanilla PointNet (no T-Nets, ``ppt_tpu/nn/classic.py:20-45``): a
    per-point MLP 64-64-64-128-1024, the max over points, FC to 256."""

    def __init__(self, in_channels: int = 3, mlp: Sequence[int] = (64, 64, 64, 128, 1024),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth = len(mlp)
        for i, ch in enumerate(mlp):
            self.add_module(f"conv{i}", Dense(in_channels, ch, dtype=dtype))
            self.add_module(f"bn{i}", BatchNorm(ch))
            in_channels = ch
        self.fc1 = Dense(in_channels, 512, dtype=dtype)
        self.fbn1 = BatchNorm(512)
        self.fc2 = Dense(512, 256, dtype=dtype)
        self.fbn2 = BatchNorm(256)

    def forward(self, xyz: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = xyz
        for i in range(self.depth):
            x = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x), train))
        x = x.amax(dim=1)
        x = dropout(torch.relu(self.fbn1(self.fc1(x), train)), 0.4, train, generator)
        return torch.relu(self.fbn2(self.fc2(x), train))


class Tnet(nn.Module):
    """``STN3d`` / ``STNkd`` (``ppt_tpu/nn/classic.py:48-76``): MLP
    64-128-1024 over ``in_channels``, the max over points, FC 512-256-k*k,
    the identity added: ``[B, k, k]`` in the compute dtype."""

    def __init__(self, k: int = 3, in_channels: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.k = k
        cin = k if in_channels is None else in_channels
        for i, ch in enumerate((64, 128, 1024)):
            self.add_module(f"conv{i + 1}", Dense(cin, ch, dtype=dtype))
            self.add_module(f"bn{i + 1}", BatchNorm(ch))
            cin = ch
        for i, ch in enumerate((512, 256)):
            self.add_module(f"fc{i + 1}", Dense(cin, ch, dtype=dtype))
            self.add_module(f"bn{i + 4}", BatchNorm(ch))
            cin = ch
        self.fc3 = Dense(cin, k * k, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = x
        for i in (1, 2, 3):
            h = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(h), train))
        h = h.amax(dim=1)
        for i in (1, 2):
            h = torch.relu(getattr(self, f"bn{i + 3}")(getattr(self, f"fc{i}")(h), train))
        h = self.fc3(h)
        eye = torch.eye(self.k, dtype=h.dtype, device=h.device).reshape(1, -1)
        return (h + eye).reshape(-1, self.k, self.k)


class PointNetEncoder(nn.Module):
    """PointNet with T-Nets (``PointNetEncoder.forward_cls_feat``,
    ``ppt_tpu/nn/classic.py:79-112``) -> ``[B, 1024]`` f32."""

    def __init__(self, in_channels: int = 3, input_transform: bool = True,
                 feature_transform: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.input_transform, self.feature_transform = input_transform, feature_transform
        if input_transform:
            self.stn = Tnet(3, in_channels=in_channels, dtype=dtype)
        self.conv0_1 = Dense(in_channels, 64, dtype=dtype)
        self.bn0_1 = BatchNorm(64)
        self.conv0_2 = Dense(64, 64, dtype=dtype)
        self.bn0_2 = BatchNorm(64)
        if feature_transform:
            self.fstn = Tnet(64, dtype=dtype)
        cin = 64
        for i, ch in enumerate((64, 128, 1024)):
            self.add_module(f"conv{i + 1}", Dense(cin, ch, dtype=dtype))
            self.add_module(f"bn{i + 1}", BatchNorm(ch))
            cin = ch

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.input_transform:
            trans = self.stn(x, train)
            x = torch.cat([torch.bmm(x[..., :3], trans), x[..., 3:]], dim=-1)
        x = torch.relu(self.bn0_1(self.conv0_1(x), train))
        x = torch.relu(self.bn0_2(self.conv0_2(x), train))
        if self.feature_transform:
            trans_feat = self.fstn(x, train)
            x = torch.bmm(x, trans_feat.to(x.dtype))  # f32 features, the transform promoted
        for i in (1, 2, 3):
            x = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x), train)
            if i < 3:  # the reference's bn3(conv3(x)) feeds the max un-activated
                x = torch.relu(x)
        return x.amax(dim=1)


class DgcnnClassifier(nn.Module):
    """DGCNN (``ppt_tpu/nn/classic.py:115-165``): 4 EdgeConv stages over kNN
    graphs in feature space, the stages concatenated, ``emb``, max + mean
    over points, then (``trunk``) FC to 256; without the trunk the pooled
    ``[B, 2 * emb_dim]``."""

    def __init__(self, in_channels: int = 3, k: int = 20,
                 widths: Tuple[int, ...] = (64, 64, 128, 256), emb_dim: int = 1024,
                 trunk: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.k, self.trunk = dtype, k, trunk
        self.stages = len(widths)
        cin = in_channels
        for i, w in enumerate(widths):
            self.add_module(f"edge{i}", Dense(2 * cin, w, bias=False, dtype=dtype))
            self.add_module(f"bn{i}", BatchNorm(w))
            cin = w
        self.emb = Dense(sum(widths), emb_dim, bias=False, dtype=dtype)
        self.embn = BatchNorm(emb_dim)
        if trunk:
            self.fc1 = Dense(2 * emb_dim, 512, dtype=dtype)
            self.fbn1 = BatchNorm(512)
            self.fc2 = Dense(512, 256, dtype=dtype)
            self.fbn2 = BatchNorm(256)

    def _edge_conv(self, coords: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
        idx = ops.knn_point(self.k, coords, coords)
        nbrs = ops.index_points(feats, idx)  # [B, N, k, D]
        center = feats[:, :, None, :].expand_as(nbrs)
        return torch.cat([nbrs - center, center], dim=-1)

    def forward(self, xyz: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = xyz.to(self.dtype)
        feats = []
        for i in range(self.stages):
            h = getattr(self, f"edge{i}")(self._edge_conv(x, x))
            x = leaky_relu(getattr(self, f"bn{i}")(h, train), 0.2).amax(dim=2)
            feats.append(x)  # the next stage's graph is over these features
        emb = leaky_relu(self.embn(self.emb(torch.cat(feats, dim=-1)), train), 0.2)
        pooled = torch.cat([emb.amax(dim=1), emb.mean(dim=1)], dim=-1)
        if not self.trunk:
            return pooled
        x = dropout(leaky_relu(self.fbn1(self.fc1(pooled), train), 0.2), 0.5, train, generator)
        return leaky_relu(self.fbn2(self.fc2(x), train), 0.2)
