"""PointNeXt encoder + classification head, channels-last.

Counterpart of ``ppt_tpu/nn/pointnext.py``. The default config is
PointNeXt-S as ``ULIP_PN_NEXT`` builds it: width 32, blocks [1]*6, strides
[1,2,2,2,2,1], 4 input channels (xyz + height), 2-layer SA convs with a
residual, ball-query radius 0.15 scaled 1.5x per downsampling, 32
neighbours, ``dp_fj`` aggregation with the relative coordinates divided by
the radius, and a 512 -> 512 -> 256 head. Each strided stage samples with
``fps_batched`` and groups with ``ball_query_gather_feats`` (one kernel:
query, relative coordinates and the feature gather); Dense runs in the
compute dtype, BatchNorm statistics and affine in f32. ``InvResMLP``
serves the scaled configs (``PointNextConfig.b/l/xl``). ``train`` is an
explicit argument: the frozen tower of prompt tuning still runs in
training mode. Module and parameter names mirror the flax tree (``stem``,
``stage1_sa/conv0/conv``, ``stage1_sa/skipconv``, ``stage5_global``,
``head_fc0``, ``head_bn0``, ...).
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
class PointNextConfig:
    in_channels: int = 4
    width: int = 32
    blocks: Tuple[int, ...] = (1, 1, 1, 1, 1, 1)
    strides: Tuple[int, ...] = (1, 2, 2, 2, 2, 1)
    radius: float = 0.15
    radius_scaling: float = 1.5
    nsample: int = 32
    expansion: int = 4
    sa_layers: int = 2
    sa_use_res: bool = True
    head_mlps: Tuple[int, ...] = (512, 256)
    head_dropout: float = 0.5

    def stage_channels(self) -> Tuple[int, ...]:
        w = self.width
        out = []
        for s in self.strides:
            if s != 1:
                w *= 2
            out.append(w)
        return tuple(out)

    @classmethod
    def b(cls) -> "PointNextConfig":
        """PointNeXt-B: blocks [1,2,3,2,2], strides [1,4,4,4,4], 1-layer SA
        without residual, radius 0.1."""
        return cls(blocks=(1, 2, 3, 2, 2), strides=(1, 4, 4, 4, 4),
                   sa_layers=1, sa_use_res=False, radius=0.1)

    @classmethod
    def l(cls) -> "PointNextConfig":  # noqa: E743
        """PointNeXt-L."""
        return cls(blocks=(1, 3, 5, 3, 3), strides=(1, 4, 4, 4, 4),
                   sa_layers=1, sa_use_res=False, radius=0.1)

    @classmethod
    def xl(cls) -> "PointNextConfig":
        """PointNeXt-XL: width 64."""
        return cls(blocks=(1, 4, 7, 4, 4), strides=(1, 4, 4, 4, 4),
                   sa_layers=1, sa_use_res=False, width=64, radius=0.1)

    def stage_radii(self) -> Tuple[float, ...]:
        """The first block's radius per stage."""
        r = self.radius
        out = []
        for s in self.strides:
            out.append(r)
            if s != 1:
                r *= self.radius_scaling
        return tuple(out)


class _ConvBnAct(nn.Module):
    """Dense (no bias when BatchNorm follows) -> BatchNorm -> ReLU."""

    def __init__(self, in_channels: int, out: int, use_norm: bool = True, use_act: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.use_act = use_act
        self.conv = Dense(in_channels, out, bias=not use_norm, dtype=dtype)
        self.bn = BatchNorm(out) if use_norm else None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x, train)
        return torch.relu(x) if self.use_act else x


def _grouped(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor,
             feats: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``dp_fj``: concat[(xyz_j - centre) / radius, f_j], [B, S, K, 3 + C].
    The division is in f32, before the cast to the compute dtype. The
    features are cast before the gather: the Dense that follows would cast
    the gathered rows to the same values, and the copy moves fewer bytes."""
    _, rel, fj = kgroup.ball_query_gather_feats(
        float(radius), min(nsample, xyz.shape[1]), xyz, new_xyz, feats.to(dtype))
    dp = rel.to(xyz.dtype) / radius
    return torch.cat([dp.to(dtype), fj], dim=-1)


class SetAbstractionNext(nn.Module):
    """Strided SA with residual (``ppt_tpu/nn/pointnext.py:108-176``):
    shared MLP over the grouped features, max-pool, and a residual from the
    centres' own features through a linear skip, added before the ReLU."""

    def __init__(self, in_channels: int, out_channels: int, stride: int, radius: float,
                 nsample: int, sa_layers: int = 2, use_res: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.radius, self.nsample = stride, radius, nsample
        self.use_res = use_res
        self.dtype = dtype
        mid = out_channels // 2 if stride > 1 else out_channels
        widths = [mid] * (sa_layers - 1) + [out_channels]
        self.depth = len(widths)
        last = in_channels + 3
        for i, w in enumerate(widths):
            final = i == len(widths) - 1
            self.add_module(f"conv{i}", _ConvBnAct(last, w, use_act=not (final and use_res),
                                                   dtype=dtype))
            last = w
        if use_res and in_channels != out_channels:
            self.skipconv = Dense(in_channels, out_channels, dtype=dtype)
        else:
            self.skipconv = None

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor,
                train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        fps_idx = kgroup.fps_batched(xyz, xyz.shape[1] // self.stride)
        new_xyz = ops.index_points(xyz, fps_idx)
        x = _grouped(self.radius, self.nsample, xyz, new_xyz, feats, self.dtype)
        for i in range(self.depth):
            x = getattr(self, f"conv{i}")(x, train)
        pooled = x.amax(dim=2)  # [B, npoint, out]
        if self.use_res:
            identity = ops.index_points(feats, fps_idx)
            if self.skipconv is not None:
                identity = self.skipconv(identity)
            pooled = torch.relu(pooled + identity)
        return new_xyz, pooled


class GlobalAggregation(nn.Module):
    """Stride-1 tail SA: group-all + MLP + global max
    (``ppt_tpu/nn/pointnext.py:179-196``)."""

    def __init__(self, in_channels: int, out_channels: int, sa_layers: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.depth = sa_layers
        last = in_channels + 3
        for i in range(sa_layers):
            self.add_module(f"conv{i}", _ConvBnAct(last, out_channels, dtype=dtype))
            last = out_channels

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = torch.cat([xyz.to(self.dtype), feats], dim=-1)
        for i in range(self.depth):
            x = getattr(self, f"conv{i}")(x, train)
        return x.amax(dim=1)  # [B, out]


class InvResMLP(nn.Module):
    """Inverted-residual depth block (``ppt_tpu/nn/pointnext.py:199-230``):
    a ball query around every point, a 1-layer MLP and max-pool, then a
    pointwise inverted bottleneck, residual add, ReLU."""

    def __init__(self, channels: int, radius: float, nsample: int, expansion: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.radius, self.nsample = radius, nsample
        self.dtype = dtype
        self.aggr_conv = _ConvBnAct(channels + 3, channels, dtype=dtype)
        self.pw1 = _ConvBnAct(channels, channels * expansion, dtype=dtype)
        self.pw2 = _ConvBnAct(channels * expansion, channels, use_act=False, dtype=dtype)

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = _grouped(self.radius, self.nsample, xyz, xyz, feats, self.dtype)
        x = self.aggr_conv(x, train).amax(dim=2)
        x = self.pw2(self.pw1(x, train), train)
        return torch.relu(x + feats)


class PointNext(nn.Module):
    """PointNeXt trunk -> [B, head_mlps[-1]] f32. ``pts`` is
    ``[B, N, in_channels]``: xyz in the first 3 channels, extra features
    (height) after; all of it feeds the stem."""

    def __init__(self, config: PointNextConfig = PointNextConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.stages = []  # (kind, names) in call order
        radii = cfg.stage_radii()
        last = cfg.in_channels
        for i, (ch, stride, nblocks) in enumerate(
                zip(cfg.stage_channels(), cfg.strides, cfg.blocks)):
            if i == 0 and stride == 1:
                self.stem = Dense(last, ch, dtype=dtype)  # plain linear, no norm, no act
                self.stages.append(("stem", ["stem"]))
            elif stride == 1:
                name = f"stage{i}_global"
                self.add_module(name, GlobalAggregation(last, ch, cfg.sa_layers, dtype=dtype))
                self.stages.append(("global", [name]))
            else:
                names = [f"stage{i}_sa"]
                self.add_module(names[0], SetAbstractionNext(
                    last, ch, stride, radii[i], cfg.nsample, sa_layers=cfg.sa_layers,
                    use_res=cfg.sa_use_res, dtype=dtype))
                for j in range(1, nblocks):
                    names.append(f"stage{i}_block{j}")
                    self.add_module(names[-1], InvResMLP(
                        ch, radii[i] * cfg.radius_scaling, cfg.nsample, cfg.expansion,
                        dtype=dtype))
                self.stages.append(("sa", names))
            last = ch
        for i, w in enumerate(cfg.head_mlps):
            self.add_module(f"head_fc{i}", Dense(last, w, bias=False, dtype=dtype))
            self.add_module(f"head_bn{i}", BatchNorm(w))
            last = w

    def forward(self, pts: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.config
        if pts.shape[-1] != cfg.in_channels:
            raise ValueError(f"PointNext: built for {cfg.in_channels} input channels, got "
                             f"{pts.shape[-1]} (the 4th is the height of --use_height)")
        xyz = pts[..., :3].contiguous()
        feats = pts
        for kind, names in self.stages:
            if kind == "stem":
                feats = self.stem(feats)
            elif kind == "global":
                feats = getattr(self, names[0])(xyz, feats, train)
                xyz = None
            else:
                xyz, feats = getattr(self, names[0])(xyz, feats, train)
                for name in names[1:]:
                    feats = getattr(self, name)(xyz, feats, train)
        if feats.dim() == 3:  # the scaled plans have no group-all tail
            feats = feats.amax(dim=1)
        x = feats
        for i in range(len(cfg.head_mlps)):
            x = getattr(self, f"head_fc{i}")(x)
            x = torch.relu(getattr(self, f"head_bn{i}")(x, train))
            x = dropout(x, cfg.head_dropout, train, generator)
        return x
