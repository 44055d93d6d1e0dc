"""PointNeXt over packed clouds: ``(pts [total, C], offsets)``.

Counterpart of ``ppt_tpu/nn/pointnext_packed.py`` (the capability of
openpoints' unfinished ``pointnextPyG.py``): the PointNeXt-S trunk on the
packed ops of ``ops/ragged.py``, FPS through ``fps_batched`` (one launch a
strided stage on the ``[B, n, 3]`` view), the ball query and gathers
plain, as the reference's XLA. The clouds have one size, so every stage's
count is static and the group-all tail's per-cloud max is an ``amax`` on
the ``[B, n, C]`` view. Module and parameter names mirror
``nn/pointnext.py`` (``stem``, ``stage1_sa/conv0/conv``,
``stage1_sa/skipconv``, ``stage5_global``, ``head_fc0``), so a batched
PointNeXt's ``state_dict`` drives this model unchanged.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ppt_torch.nn.layers import BatchNorm, Dense, dropout
from ppt_torch.nn.pointnext import PointNextConfig, _ConvBnAct
from ppt_torch.ops import ragged


def _offsets(B: int, n: int) -> Tuple[int, ...]:
    return tuple(n * (i + 1) for i in range(B))


class SetAbstractionPacked(nn.Module):
    """Strided SA over packed clouds (``SetAbstractionNext``'s mirror):
    ``dp_fj`` grouping with the offsets divided by the radius, the shared
    MLP, the max over the neighbours and the residual from the centres'
    own features."""

    def __init__(self, in_channels: int, out_channels: int, stride: int, radius: float,
                 nsample: int, sa_layers: int = 2, use_res: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.radius, self.nsample, self.use_res = radius, nsample, use_res
        self.dtype = dtype
        mid = out_channels // 2 if stride > 1 else out_channels
        widths = [mid] * (sa_layers - 1) + [out_channels]
        self.depth = len(widths)
        last = in_channels + 3
        for i, w in enumerate(widths):
            self.add_module(f"conv{i}", _ConvBnAct(
                last, w, use_act=not (i == len(widths) - 1 and use_res), dtype=dtype))
            last = w
        use_skip = use_res and in_channels != out_channels
        self.skipconv = Dense(in_channels, out_channels, dtype=dtype) if use_skip else None

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor, offsets, npoint: int,
                train: bool = False):
        """xyz [n, 3], feats [n, C], ``npoint`` a cloud -> (xyz, features,
        offsets) of the sampled points."""
        fps_idx = ragged.farthest_point_sample_packed(xyz, offsets, npoint).reshape(-1).long()
        new_xyz = xyz[fps_idx]
        new_off = _offsets(len(offsets), npoint)
        idx = ragged.ball_query_packed(self.radius, self.nsample, xyz, offsets, new_xyz,
                                       new_off).long()
        dp = (xyz[idx] - new_xyz[:, None, :]) / self.radius
        x = torch.cat([dp.to(self.dtype), feats[idx]], dim=-1)
        for i in range(self.depth):
            x = getattr(self, f"conv{i}")(x, train)
        pooled = x.amax(1)
        if self.use_res:
            identity = feats[fps_idx]
            if self.skipconv is not None:
                identity = self.skipconv(identity)
            pooled = torch.relu(pooled + identity)
        return new_xyz, pooled, new_off


class GlobalAggregationPacked(nn.Module):
    """Group-all tail SA (``GlobalAggregation``'s mirror): the MLP on
    ``[xyz, features]``, then each cloud's max."""

    def __init__(self, in_channels: int, out_channels: int, sa_layers: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.depth = sa_layers
        last = in_channels + 3
        for i in range(sa_layers):
            self.add_module(f"conv{i}", _ConvBnAct(last, out_channels, dtype=dtype))
            last = out_channels

    def forward(self, xyz, feats, offsets, train: bool = False) -> torch.Tensor:
        x = torch.cat([xyz.to(self.dtype), feats], dim=-1)
        for i in range(self.depth):
            x = getattr(self, f"conv{i}")(x, train)
        return x.reshape(len(offsets), -1, x.shape[-1]).amax(1)  # [B, out]


class PointNextPacked(nn.Module):
    """PointNeXt trunk over packed clouds -> ``[B, head_mlps[-1]]`` f32.
    ``pts`` is ``[total, in_channels]``, xyz in the first 3 channels;
    ``offsets`` the clouds' end indices (ints or a tensor), every cloud of
    one size."""

    def __init__(self, config: PointNextConfig = PointNextConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        radii = cfg.stage_radii()
        last = cfg.in_channels
        for i, (ch, stride, nblocks) in enumerate(zip(cfg.stage_channels(), cfg.strides,
                                                      cfg.blocks)):
            if stride != 1 and nblocks > 1:
                raise NotImplementedError("packed InvResMLP depth blocks not implemented; "
                                          "PointNeXt-S (blocks=[1]*6) is the supported plan")
            if i == 0 and stride == 1:
                self.stem = Dense(last, ch, dtype=dtype)
            elif stride == 1:
                self.add_module(f"stage{i}_global", GlobalAggregationPacked(
                    last, ch, cfg.sa_layers, dtype=dtype))
            else:
                self.add_module(f"stage{i}_sa", SetAbstractionPacked(
                    last, ch, stride, radii[i], cfg.nsample, sa_layers=cfg.sa_layers,
                    use_res=cfg.sa_use_res, dtype=dtype))
            last = ch
        for i, w in enumerate(cfg.head_mlps):
            self.add_module(f"head_fc{i}", Dense(last, w, bias=False, dtype=dtype))
            self.add_module(f"head_bn{i}", BatchNorm(w))
            last = w

    def forward(self, pts: torch.Tensor, offsets, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.config
        spans = ragged.bounds(offsets)
        B = len(spans)
        if {e - s for s, e in spans} != {pts.shape[0] // B}:
            raise ValueError(f"PointNextPacked: the clouds must have one size, got spans {spans}")
        count = pts.shape[0] // B
        offsets = _offsets(B, count)
        xyz = pts[:, :3].float()
        feats = pts.to(self.dtype)
        for i, stride in enumerate(cfg.strides):
            if i == 0 and stride == 1:
                feats = self.stem(feats)
            elif stride == 1:
                feats = getattr(self, f"stage{i}_global")(xyz, feats, offsets, train)
                xyz = None
            else:
                count = count // stride
                xyz, feats, offsets = getattr(self, f"stage{i}_sa")(xyz, feats, offsets, count,
                                                                   train)
        x = feats
        for i in range(len(cfg.head_mlps)):
            x = torch.relu(getattr(self, f"head_bn{i}")(getattr(self, f"head_fc{i}")(x), train))
            x = dropout(x, cfg.head_dropout, train, generator)
        return x
