"""PointNet++ SSG / MSG backbones, channels-last.

Counterpart of ``ppt_tpu/nn/pointnet2.py``: everything stays ``[B, N, C]``
and the shared MLPs are Dense + BatchNorm over the last axis (Dense in the
compute dtype, BatchNorm statistics and affine in f32). Sampling and
grouping go through the FPS and ball-query kernels' wrappers
(``ppt_torch.kernels.group``). Both trunks end in the 2-layer FC head that
gives the 256-d feature ULIP projects. ``train`` is an explicit argument:
the frozen tower of prompt tuning still runs in training mode (batch
statistics that move the running ones, head dropout drawn from
``generator``). Module and parameter names mirror the flax tree
(``sa1/conv0``, ``sa1/bn0_1``, ``head/fc1``, ...), so
``ppt_torch.convert.from_jax`` maps every leaf one to one.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ppt_torch.kernels import group as kgroup
from ppt_torch.nn.layers import BatchNorm, Dense, dropout
from ppt_torch.ops import geometry as ops


class SetAbstraction(nn.Module):
    """Single-scale grouping SA layer (``ppt_tpu/nn/pointnet2.py:24-55``):
    ``in_channels`` counts the 3 coordinates and the incoming features."""

    def __init__(self, npoint: Optional[int], radius: Optional[float], nsample: Optional[int],
                 in_channels: int, mlp: Sequence[int], group_all: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.group_all = group_all
        self.depth = len(mlp)
        for i, ch in enumerate(mlp):
            self.add_module(f"conv{i}", Dense(in_channels, ch, dtype=dtype))
            self.add_module(f"bn{i}", BatchNorm(ch))
            in_channels = ch

    def forward(self, xyz: torch.Tensor, points: Optional[torch.Tensor],
                train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.group_all:
            new_xyz, x = ops.sample_and_group_all(xyz, points)
        else:
            new_xyz, x = ops.sample_and_group(self.npoint, self.radius, self.nsample, xyz, points)
        for i in range(self.depth):  # [B, S, K, C]
            x = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x), train))
        return new_xyz, x.amax(dim=2)


class SetAbstractionMsg(nn.Module):
    """Multi-scale grouping SA layer (``ppt_tpu/nn/pointnet2.py:58-111``):
    one FPS, then per scale a ball query, the feature gather (outside the
    kernel, features before coordinates, as the reference has them) and a
    shared MLP; the scales' maxima are concatenated."""

    def __init__(self, npoint: int, radius_list: Sequence[float], nsample_list: Sequence[int],
                 in_channels: int, mlp_list: Sequence[Sequence[int]],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.npoint = npoint
        self.radius_list, self.nsample_list = tuple(radius_list), tuple(nsample_list)
        self.depths = tuple(len(m) for m in mlp_list)
        for i, mlp in enumerate(mlp_list):
            last = in_channels
            for j, ch in enumerate(mlp):
                self.add_module(f"conv{i}_{j}", Dense(last, ch, dtype=dtype))
                self.add_module(f"bn{i}_{j}", BatchNorm(ch))
                last = ch

    def forward(self, xyz: torch.Tensor, points: Optional[torch.Tensor],
                train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        new_xyz = ops.index_points(xyz, kgroup.fps_batched(xyz, self.npoint))
        outs = []
        for i, (radius, nsample) in enumerate(zip(self.radius_list, self.nsample_list)):
            idx, rel = kgroup.ball_query_gather(float(radius), nsample, xyz, new_xyz)
            x = rel.to(xyz.dtype)
            if points is not None:
                x = torch.cat([ops.index_points(points, idx), x], dim=-1)
            for j in range(self.depths[i]):
                x = torch.relu(getattr(self, f"bn{i}_{j}")(getattr(self, f"conv{i}_{j}")(x), train))
            outs.append(x.amax(dim=2))
        return new_xyz, torch.cat(outs, dim=-1)


class _FcHead(nn.Module):
    """Shared 1024 -> 512 -> 256 head (``ppt_tpu/nn/pointnet2.py:114-135``)."""

    def __init__(self, drop1: float = 0.4, drop2: float = 0.4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.drop1, self.drop2 = drop1, drop2
        self.fc1 = Dense(1024, 512, dtype=dtype)
        self.bn1 = BatchNorm(512)
        self.fc2 = Dense(512, 256, dtype=dtype)
        self.bn2 = BatchNorm(256)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = dropout(torch.relu(self.bn1(self.fc1(x), train)), self.drop1, train, generator)
        return dropout(torch.relu(self.bn2(self.fc2(x), train)), self.drop2, train, generator)


class PointNet2Ssg(nn.Module):
    """Single-scale-grouping trunk -> [B, 256] f32
    (``ppt_tpu/nn/pointnet2.py:138-156``)."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.sa1 = SetAbstraction(512, 0.2, 32, 3, (64, 64, 128), dtype=dtype)
        self.sa2 = SetAbstraction(128, 0.4, 64, 128 + 3, (128, 128, 256), dtype=dtype)
        self.sa3 = SetAbstraction(None, None, None, 256 + 3, (256, 512, 1024), group_all=True,
                                  dtype=dtype)
        self.head = _FcHead(0.4, 0.4, dtype=dtype)

    def forward(self, xyz: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        l1_xyz, l1 = self.sa1(xyz, None, train)
        l2_xyz, l2 = self.sa2(l1_xyz, l1, train)
        _, l3 = self.sa3(l2_xyz, l2, train)
        return self.head(l3[:, 0], train, generator)


class PointNet2Msg(nn.Module):
    """Multi-scale-grouping trunk -> [B, 256] f32
    (``ppt_tpu/nn/pointnet2.py:159-187``)."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.sa1 = SetAbstractionMsg(
            512, (0.1, 0.2, 0.4), (16, 32, 128), 3,
            ((32, 32, 64), (64, 64, 128), (64, 96, 128)), dtype=dtype)
        self.sa2 = SetAbstractionMsg(
            128, (0.2, 0.4, 0.8), (32, 64, 128), 320 + 3,
            ((64, 64, 128), (128, 128, 256), (128, 128, 256)), dtype=dtype)
        self.sa3 = SetAbstraction(None, None, None, 640 + 3, (256, 512, 1024), group_all=True,
                                  dtype=dtype)
        self.head = _FcHead(0.4, 0.5, dtype=dtype)

    def forward(self, xyz: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        l1_xyz, l1 = self.sa1(xyz, None, train)
        l2_xyz, l2 = self.sa2(l1_xyz, l1, train)
        _, l3 = self.sa3(l2_xyz, l2, train)
        return self.head(l3[:, 0], train, generator)
