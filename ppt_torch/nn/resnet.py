"""The ResNet stages SimpleView runs, NHWC.

Counterpart of ``ppt_tpu/nn/resnet.py``: ``BasicBlock``, ``Bottleneck``
and ``ResNetStages`` (layer1..layer4 + the global average pool, no stem, no
fc). The layout stays the reference's NHWC with flax's ``Conv`` kernel
``[kh, kw, in, out]`` (HWIO), so ``ppt_torch.convert.from_jax`` carries the
leaves with no rule of their own; ``Conv`` permutes to NCHW / OIHW at the
call into ``torch.nn.functional.conv2d``. These BatchNorms move their
running statistics with momentum 0.9 (the reference's ``_bn``), not
flax's default 0.99.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ppt_torch.nn.layers import BatchNorm

RESNET_BN_MOMENTUM = 0.9


class Conv(nn.Module):
    """flax ``nn.Conv(features, (kh, kw), strides, padding, use_bias=False,
    dtype=...)`` on ``[B, H, W, C]``: input and kernel cast to the compute
    dtype; ``padding`` symmetric (an int), 0 for flax's ``SAME`` on a 1x1
    kernel."""

    def __init__(self, in_features: int, features: int, kernel_size: Tuple[int, int],
                 stride: int = 1, padding: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.kernel = nn.Parameter(torch.empty(*kernel_size, in_features, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.kernel.to(dt).permute(3, 2, 0, 1),
                     stride=self.stride, padding=self.padding)
        return y.permute(0, 2, 3, 1)


@torch.no_grad()
def init_conv_(module: nn.Module, gen: torch.Generator) -> None:
    """Every ``Conv`` under ``module``, in module order: a lecun-normal
    kernel (std 1/sqrt(kh kw in), drawn from ``gen`` on the CPU)."""
    for mod in module.modules():
        if isinstance(mod, Conv):
            fan_in = math.prod(mod.kernel.shape[:3])
            mod.kernel.copy_(torch.randn(mod.kernel.shape, generator=gen) / math.sqrt(fan_in))


def _bn(width: int, zero_init: bool = False) -> BatchNorm:
    bn = BatchNorm(width, momentum=RESNET_BN_MOMENTUM)
    if zero_init:
        with torch.no_grad():
            bn.weight.zero_()
    return bn


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block (expansion 1)."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False,
                 zero_init_residual: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv(inplanes, planes, (3, 3), stride, 1, dtype=dtype)
        self.bn1 = _bn(planes)
        self.conv2 = Conv(planes, planes, (3, 3), 1, 1, dtype=dtype)
        self.bn2 = _bn(planes, zero_init_residual)
        if downsample:
            self.ds_conv = Conv(inplanes, planes, (1, 1), stride, dtype=dtype)
            self.ds_bn = _bn(planes)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = torch.relu(self.bn1(self.conv1(x), train))
        h = self.bn2(self.conv2(h), train)
        identity = self.ds_bn(self.ds_conv(x), train) if hasattr(self, "ds_conv") else x
        return torch.relu(h + identity)


class Bottleneck(nn.Module):
    """1x1 - 3x3 - 1x1 residual block (expansion 4)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False,
                 zero_init_residual: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv(inplanes, planes, (1, 1), dtype=dtype)
        self.bn1 = _bn(planes)
        self.conv2 = Conv(planes, planes, (3, 3), stride, 1, dtype=dtype)
        self.bn2 = _bn(planes)
        self.conv3 = Conv(planes, planes * 4, (1, 1), dtype=dtype)
        self.bn3 = _bn(planes * 4, zero_init_residual)
        if downsample:
            self.ds_conv = Conv(inplanes, planes * 4, (1, 1), stride, dtype=dtype)
            self.ds_bn = _bn(planes * 4)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = torch.relu(self.bn1(self.conv1(x), train))
        h = torch.relu(self.bn2(self.conv2(h), train))
        h = self.bn3(self.conv3(h), train)
        identity = self.ds_bn(self.ds_conv(x), train) if hasattr(self, "ds_conv") else x
        return torch.relu(h + identity)


class ResNetStages(nn.Module):
    """layer1..layer4 + the global average pool (``ppt_tpu/nn/resnet.py:
    95-126``): ``[B, H, W, feature_size]`` -> ``[B, feature_size * 8 *
    expansion]``."""

    def __init__(self, layers: Tuple[int, ...] = (2, 2, 2, 2), feature_size: int = 64,
                 block: str = "basic", zero_init_residual: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        block_cls = BasicBlock if block == "basic" else Bottleneck
        self.names = []
        inplanes = feature_size
        for stage, n_blocks in enumerate(layers):
            planes = feature_size * 2 ** stage
            stride = 1 if stage == 0 else 2
            for b in range(n_blocks):
                s = stride if b == 0 else 1
                need_ds = b == 0 and (s != 1 or inplanes != planes * block_cls.expansion)
                name = f"layer{stage + 1}_{b}"
                self.add_module(name, block_cls(inplanes, planes, s, need_ds, zero_init_residual,
                                                dtype=dtype))
                self.names.append(name)
                inplanes = planes * block_cls.expansion

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for name in self.names:
            x = getattr(self, name)(x, train)
        return x.mean(dim=(1, 2))
