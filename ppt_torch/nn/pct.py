"""PCT, the Point Cloud Transformer backbone, channels-last.

Counterpart of ``ppt_tpu/nn/pct.py``: a per-point embedding MLP, two
FPS + kNN neighbour-embedding stages (``LocalOp``: a shared MLP, then the
max over the neighbours), four offset-attention layers whose outputs are
concatenated, a 1280 -> 1024 fusion, the max over points and an FC trunk
to the 256-d feature ULIP projects. Module and parameter names mirror the
flax tree (``gather_local_0/conv1``, ``sa1/qk_conv``, ``sa1/after_norm``,
``conv_fuse``, ``bn6``, ``linear2``, ...), so ``ppt_torch.convert.from_jax``
maps every leaf.

The traps:
- FPS goes through ``kernels/group.py:fps_batched`` (the kernel on the
  card: 1024 -> 512 and 512 -> 256 a batch), as the reference reaches its
  chip's kernel; kNN stays ``ops/geometry.py:knn_point``, as the
  reference's is plain XLA;
- a group is ``[grouped - center, center]``;
- the offset attention ties the q and k weights (one ``qk_conv``), takes
  the row softmax in f32, then divides by each column's sum plus 1e-9: it
  renormalises by column, so it is not ``scaled_dot_product_attention``,
  and stays two plain products;
- the head's two dropouts draw from the ``generator`` given in training
  mode.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ppt_torch.kernels import group as kgroup
from ppt_torch.nn.layers import BatchNorm, Dense, dropout, leaky_relu
from ppt_torch.ops import geometry as ops


class LocalOp(nn.Module):
    """``Local_op`` (``ppt_tpu/nn/pct.py:38-54``): two Dense + BatchNorm +
    ReLU over ``[B, G, K, C]``, then the max over K."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Dense(in_channels, out_channels, bias=False, dtype=dtype)
        self.bn1 = BatchNorm(out_channels)
        self.conv2 = Dense(out_channels, out_channels, bias=False, dtype=dtype)
        self.bn2 = BatchNorm(out_channels)

    def forward(self, grouped: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(grouped), train))
        return torch.relu(self.bn2(self.conv2(x), train)).amax(dim=2)


class OffsetAttention(nn.Module):
    """PCT's ``SA_Layer`` (``ppt_tpu/nn/pct.py:57-79``): tied q/k, the row
    softmax in f32 renormalised by column, a residual through
    ``trans_conv`` + BatchNorm + ReLU."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.qk_conv = Dense(channels, channels // 4, bias=False, dtype=dtype)
        self.v_conv = Dense(channels, channels, dtype=dtype)
        self.trans_conv = Dense(channels, channels, dtype=dtype)
        self.after_norm = BatchNorm(channels)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        qk = self.qk_conv(x)  # the tied weights: q and k are one product
        energy = torch.bmm(qk, qk.transpose(1, 2))
        attention = torch.softmax(energy.float(), dim=-1)
        attention = attention / (1e-9 + attention.sum(dim=1, keepdim=True))
        x_r = torch.bmm(attention.to(self.dtype), self.v_conv(x))
        return x + torch.relu(self.after_norm(self.trans_conv(x_r), train))


def _subsample_group(xyz: torch.Tensor, feats: torch.Tensor, npoint: int,
                     nsample: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """FPS (the kernel on the card) + kNN: ``(new_xyz [B, G, 3],
    [grouped - center, center] [B, G, K, 2C])``
    (``ppt_tpu/nn/pct.py:82-95``)."""
    idx = kgroup.fps_batched(xyz, npoint)
    new_xyz = ops.index_points(xyz, idx)
    center = ops.index_points(feats, idx)  # [B, G, C]
    grouped = ops.index_points(feats, ops.knn_point(nsample, xyz, new_xyz))  # [B, G, K, C]
    center = center[:, :, None, :].expand_as(grouped)
    return new_xyz, torch.cat([grouped - center, center], dim=-1)


class Pct(nn.Module):
    """The PCT trunk -> ``[B, 256]`` f32 (``ppt_tpu/nn/pct.py:98-142``)."""

    def __init__(self, dropout: float = 0.5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout
        self.conv1 = Dense(3, 64, bias=False, dtype=dtype)
        self.bn1 = BatchNorm(64)
        self.conv2 = Dense(64, 64, bias=False, dtype=dtype)
        self.bn2 = BatchNorm(64)
        self.gather_local_0 = LocalOp(128, 128, dtype=dtype)
        self.gather_local_1 = LocalOp(256, 256, dtype=dtype)
        self.pt_conv1 = Dense(256, 256, bias=False, dtype=dtype)
        self.pt_bn1 = BatchNorm(256)
        self.pt_conv2 = Dense(256, 256, bias=False, dtype=dtype)
        self.pt_bn2 = BatchNorm(256)
        for i in range(4):
            self.add_module(f"sa{i + 1}", OffsetAttention(256, dtype=dtype))
        self.conv_fuse = Dense(1280, 1024, bias=False, dtype=dtype)
        self.bn_fuse = BatchNorm(1024)
        self.linear1 = Dense(1024, 512, bias=False, dtype=dtype)
        self.bn6 = BatchNorm(512)
        self.linear2 = Dense(512, 256, dtype=dtype)
        self.bn7 = BatchNorm(256)

    def forward(self, xyz: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(xyz), train))
        x = torch.relu(self.bn2(self.conv2(x), train))
        new_xyz, grouped = _subsample_group(xyz, x, 512, 32)  # [B, 512, 32, 128]
        f0 = self.gather_local_0(grouped, train)
        _, grouped = _subsample_group(new_xyz, f0, 256, 32)  # [B, 256, 32, 256]
        f1 = self.gather_local_1(grouped, train)
        h = torch.relu(self.pt_bn1(self.pt_conv1(f1), train))
        h = torch.relu(self.pt_bn2(self.pt_conv2(h), train))
        sas = []
        for i in range(4):
            h = getattr(self, f"sa{i + 1}")(h, train)
            sas.append(h)
        x = leaky_relu(self.bn_fuse(self.conv_fuse(torch.cat(sas + [f1], dim=-1)), train), 0.2)
        x = x.amax(dim=1)  # [B, 1024]
        x = dropout(leaky_relu(self.bn6(self.linear1(x), train), 0.2), self.dropout, train,
                    generator)
        return dropout(leaky_relu(self.bn7(self.linear2(x), train), 0.2), self.dropout, train,
                       generator)
