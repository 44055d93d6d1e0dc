"""PointMLP backbone, channels-last.

Counterpart of ``ppt_tpu/nn/pointmlp.py`` (the reference's ``pointMLP()``,
``models/pointmlp/pointMLP.py:352-356``): embed_dim 64, no biases in the
convolutions, ``use_xyz=False``, the "anchor" geometric affine, k=24
neighbours, channels doubled and points halved per stage, 2 pre and 2 pos
residual blocks a stage, and a 1024 -> 512 -> 256 head. Everything stays
``[B, N, C]``; the shared MLPs are Dense + BatchNorm over the last axis
(Dense in the compute dtype, BatchNorm statistics, affine and output in
f32), as in ``nn/pointnet2.py``. Module and parameter names mirror the
flax tree (``embedding``, ``grouper{i}/affine_alpha``, ``pre{i}/transfer``,
``pre{i}/res{j}``, ``pos{i}/res{j}``, ``fc1``, ``bn1``, ...), so
``ppt_torch.convert.from_jax`` and the pretrained loader map every leaf.

The traps:
- the anchors a stage keeps come from the STATIC ``config.points``
  (1024 -> 512, 256, 128, 64), not from the cloud's N;
- FPS goes through ``kernels/group.py:fps_batched`` (the kernel on the
  card), as the reference reaches its own chip's kernel; kNN stays
  ``ops/geometry.py:knn_point``, the expanded-form distance sorted
  stably (ties to the lower index, as ``lax.top_k``), as the reference's
  is plain XLA;
- the "anchor" affine divides by ONE std per cloud over the flattened
  ``[G, K, D]`` block, in f32, with Bessel's correction, plus 1e-5;
- the residual is ``relu(bn2(conv2(relu(bn1(conv1(x))))) + x)``;
- the head's two dropouts (0.5) draw from the ``generator`` given in
  training mode, as the other towers' do.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ppt_torch.kernels import group as kgroup
from ppt_torch.nn.layers import BatchNorm, Dense, dropout
from ppt_torch.ops import geometry as ops


@dataclasses.dataclass(frozen=True)
class PointMLPConfig:
    points: int = 1024  # the anchors derive from this static count
    embed_dim: int = 64
    res_expansion: float = 1.0
    use_xyz: bool = False
    bias: bool = False
    normalize: str = "anchor"  # 'center' | 'anchor' | '' (none)
    dim_expansion: Tuple[int, ...] = (2, 2, 2, 2)
    pre_blocks: Tuple[int, ...] = (2, 2, 2, 2)
    pos_blocks: Tuple[int, ...] = (2, 2, 2, 2)
    k_neighbors: Tuple[int, ...] = (24, 24, 24, 24)
    reducers: Tuple[int, ...] = (2, 2, 2, 2)


class ConvBnRelu(nn.Module):
    """Dense -> BatchNorm -> ReLU (``ppt_tpu/nn/pointmlp.py:50-61``)."""

    def __init__(self, in_channels: int, out: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Dense(in_channels, out, bias=bias, dtype=dtype)
        self.bn = BatchNorm(out)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x), train))


class ResBlock(nn.Module):
    """``ConvBNReLURes1D`` (``ppt_tpu/nn/pointmlp.py:64-85``), groups=1."""

    def __init__(self, channel: int, res_expansion: float = 1.0, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = int(channel * res_expansion)
        self.conv1 = Dense(channel, hidden, bias=bias, dtype=dtype)
        self.bn1 = BatchNorm(hidden)
        self.conv2 = Dense(hidden, channel, bias=bias, dtype=dtype)
        self.bn2 = BatchNorm(channel)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = torch.relu(self.bn1(self.conv1(x), train))
        return torch.relu(self.bn2(self.conv2(h), train) + x)


class LocalGrouper(nn.Module):
    """FPS + kNN + the geometric affine (``ppt_tpu/nn/pointmlp.py:88-140``):
    ``(new_xyz [B, G, 3], [B, G, K, D' + D])``, the normalised neighbours'
    features (``D' = D``, plus 3 with ``use_xyz``) before the anchors'
    own features tiled over K."""

    def __init__(self, channel: int, groups: int, kneighbors: int, use_xyz: bool = False,
                 normalize: str = "anchor"):
        super().__init__()
        self.groups, self.kneighbors = groups, kneighbors
        self.use_xyz, self.normalize = use_xyz, normalize
        if normalize in ("center", "anchor"):
            dim = channel + (3 if use_xyz else 0)
            self.affine_alpha = nn.Parameter(torch.ones(1, 1, 1, dim))
            self.affine_beta = nn.Parameter(torch.zeros(1, 1, 1, dim))

    def forward(self, xyz: torch.Tensor,
                points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        B = xyz.shape[0]
        fps_idx = kgroup.fps_batched(xyz, self.groups)
        new_xyz = ops.index_points(xyz, fps_idx)  # [B, G, 3]
        new_points = ops.index_points(points, fps_idx)  # [B, G, D]
        idx = ops.knn_point(self.kneighbors, xyz, new_xyz)
        grouped = ops.index_points(points, idx)  # [B, G, K, D]
        if self.use_xyz:
            grouped_xyz = ops.index_points(xyz, idx)
            grouped = torch.cat([grouped, grouped_xyz.to(grouped.dtype)], dim=-1)
        if self.normalize in ("center", "anchor"):
            if self.normalize == "center":
                mean = grouped.mean(dim=2, keepdim=True)
            else:
                anchor = (torch.cat([new_points, new_xyz.to(new_points.dtype)], dim=-1)
                          if self.use_xyz else new_points)
                mean = anchor[:, :, None, :]
            centered = grouped - mean
            # one std a cloud, Bessel-corrected (pointMLP.py:168)
            std = centered.reshape(B, -1).float().std(dim=-1, correction=1)[:, None, None, None]
            grouped = centered / (std + 1e-5).to(centered.dtype)
            grouped = (self.affine_alpha.to(grouped.dtype) * grouped
                       + self.affine_beta.to(grouped.dtype))
        tiled = new_points[:, :, None, :].expand(-1, -1, grouped.shape[2], -1)
        return new_xyz, torch.cat([grouped, tiled], dim=-1)


class PreExtraction(nn.Module):
    """A group's residual MLP, then the max over its neighbours
    (``ppt_tpu/nn/pointmlp.py:143-164``): ``[B, G, K, D] -> [B, G, out]``."""

    def __init__(self, in_channels: int, out_channels: int, blocks: int = 2,
                 res_expansion: float = 1.0, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.blocks = blocks
        self.transfer = ConvBnRelu(in_channels, out_channels, bias, dtype=dtype)
        for i in range(blocks):
            self.add_module(f"res{i}", ResBlock(out_channels, res_expansion, bias, dtype=dtype))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.transfer(x, train)
        for i in range(self.blocks):
            x = getattr(self, f"res{i}")(x, train)
        return x.amax(dim=2)


class PosExtraction(nn.Module):
    """An anchor's residual MLP (``ppt_tpu/nn/pointmlp.py:167-183``)."""

    def __init__(self, channels: int, blocks: int = 2, res_expansion: float = 1.0,
                 bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.blocks = blocks
        for i in range(blocks):
            self.add_module(f"res{i}", ResBlock(channels, res_expansion, bias, dtype=dtype))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i in range(self.blocks):
            x = getattr(self, f"res{i}")(x, train)
        return x


class PointMLP(nn.Module):
    """The 4-stage residual-MLP trunk -> [B, 256] f32
    (``ppt_tpu/nn/pointmlp.py:186-229``)."""

    def __init__(self, config: PointMLPConfig = PointMLPConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        self.stages = len(cfg.pre_blocks)
        self.embedding = ConvBnRelu(3, cfg.embed_dim, cfg.bias, dtype=dtype)
        channel, anchors = cfg.embed_dim, cfg.points
        for i in range(self.stages):
            out_channel = channel * cfg.dim_expansion[i]
            anchors = anchors // cfg.reducers[i]
            self.add_module(f"grouper{i}", LocalGrouper(
                channel, anchors, cfg.k_neighbors[i], use_xyz=cfg.use_xyz,
                normalize=cfg.normalize))
            grouped = 2 * channel + (3 if cfg.use_xyz else 0)
            self.add_module(f"pre{i}", PreExtraction(
                grouped, out_channel, cfg.pre_blocks[i], cfg.res_expansion, cfg.bias,
                dtype=dtype))
            self.add_module(f"pos{i}", PosExtraction(
                out_channel, cfg.pos_blocks[i], cfg.res_expansion, cfg.bias, dtype=dtype))
            channel = out_channel
        self.fc1 = Dense(channel, 512, dtype=dtype)
        self.bn1 = BatchNorm(512)
        self.fc2 = Dense(512, 256, dtype=dtype)
        self.bn2 = BatchNorm(256)

    def forward(self, xyz: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.embedding(xyz, train)
        coords = xyz
        for i in range(self.stages):
            coords, grouped = getattr(self, f"grouper{i}")(coords, x)
            x = getattr(self, f"pre{i}")(grouped, train)
            x = getattr(self, f"pos{i}")(x, train)
        x = x.amax(dim=1)  # [B, 1024]
        x = dropout(torch.relu(self.bn1(self.fc1(x), train)), 0.5, train, generator)
        return dropout(torch.relu(self.bn2(self.fc2(x), train)), 0.5, train, generator)
