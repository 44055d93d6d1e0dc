"""Point Transformer (PTSeg), the scene-segmentation U-Net over packed clouds.

Counterpart of ``ppt_tpu/nn/pointtransformer.py``: the clouds of a batch
``[B, N, C]`` are packed into ``[B * N, C]`` with offsets, and every
neighbourhood goes through ``ops/ragged.py`` (kNN and interpolation per
cloud, FPS through ``kernels/group.py:fps_batched``: one launch for each of
the four strided transitions). Module and parameter names mirror the flax
tree (``enc1_0/linear``, ``enc2_1/transformer2/linear_p_0``, ``dec5_0/
linear2_0``, ``cls_3``, ...), so ``ppt_torch.convert.from_jax`` maps every
leaf.

The traps:
- the first layer takes the features ``forward`` is given (rgb on S3DIS:
  3 wide, whatever ``in_channels`` says; the coordinates when there are
  none), so it is sized by ``feat_channels``, not by the config;
- BatchNorm here is flax's with momentum 0.9 (``pointtransformer.py:43-48``);
- the clouds always have one size, so the offsets stay Python ints and no
  call reads one back from the card; ``N`` must divide by the product of
  the strides (256), and each level's ``nsample`` is clamped to the points
  its clouds hold;
- the decoder's head mode concatenates each point's features with a
  Dense of its cloud's mean.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
from torch import nn

from ppt_torch.nn.layers import BatchNorm, Dense
from ppt_torch.ops import ragged

BN_MOMENTUM = 0.9


def _bn(width: int) -> BatchNorm:
    return BatchNorm(width, momentum=BN_MOMENTUM)


def _offsets(B: int, n: int) -> Tuple[int, ...]:
    return tuple(n * (i + 1) for i in range(B))


def knn_group(nsample: int, p: torch.Tensor, offsets, q: torch.Tensor, q_offsets,
              feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``pointops.queryandgroup``: (relative grouped xyz ``[m, ns, 3]``,
    grouped features ``[m, ns, c]``)."""
    idx, _ = ragged.knn_query_packed(nsample, p, offsets, q, q_offsets)
    idx = idx.long()
    return p[idx] - q[:, None, :], feats[idx]


class PointTransformerLayer(nn.Module):
    """Vector self-attention over kNN neighbourhoods
    (``ppt_tpu/nn/pointtransformer.py:66-114``)."""

    def __init__(self, in_planes: int, out_planes: int, share_planes: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c, s = out_planes, share_planes
        self.out_planes, self.share_planes = c, s
        self.linear_q = Dense(in_planes, c, dtype=dtype)
        self.linear_k = Dense(in_planes, c, dtype=dtype)
        self.linear_v = Dense(in_planes, c, dtype=dtype)
        self.linear_p_0 = Dense(3, 3, dtype=dtype)
        self.linear_p_1 = _bn(3)
        self.linear_p_3 = Dense(3, c, dtype=dtype)
        self.linear_w_0 = _bn(c)
        self.linear_w_2 = Dense(c, c // s, dtype=dtype)
        self.linear_w_3 = _bn(c // s)
        self.linear_w_5 = Dense(c // s, c // s, dtype=dtype)

    def forward(self, p: torch.Tensor, x: torch.Tensor, offsets, nsample: int,
                train: bool = False) -> torch.Tensor:
        c, s = self.out_planes, self.share_planes
        q, k, v = self.linear_q(x), self.linear_k(x), self.linear_v(x)
        idx, _ = ragged.knn_query_packed(nsample, p, offsets, p, offsets)
        idx = idx.long()
        p_r = p[idx] - p[:, None, :]  # [n, ns, 3]
        pe = torch.relu(self.linear_p_1(self.linear_p_0(p_r), train))
        pe = self.linear_p_3(pe)
        w = k[idx] - q[:, None, :] + pe
        w = torch.relu(self.linear_w_0(w, train))
        w = torch.relu(self.linear_w_3(self.linear_w_2(w), train))
        w = torch.softmax(self.linear_w_5(w), dim=1)  # over the neighbours
        n, ns = w.shape[0], w.shape[1]
        val = (v[idx] + pe).reshape(n, ns, s, c // s)
        return (val * w[:, :, None, :]).sum(1).reshape(n, c)


class PointNet2EdgeConvLayer(nn.Module):
    """Max-pooled local PointNet over kNN groups (``:117-135``)."""

    def __init__(self, in_planes: int, out_planes: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_0 = Dense(3 + in_planes, out_planes, bias=False, dtype=dtype)
        self.conv_1 = _bn(out_planes)

    def forward(self, p, x, offsets, nsample: int, train: bool = False) -> torch.Tensor:
        rel, feats = knn_group(nsample, p, offsets, p, offsets, x)
        h = torch.cat([rel, feats], dim=-1)
        return torch.relu(self.conv_1(self.conv_0(h), train)).amax(1)


class PointTransformerBlock(nn.Module):
    """Residual bottleneck around the transformer layer (``:138-164``)."""

    def __init__(self, planes: int, share_planes: int = 8, mid_res: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        del mid_res  # unused by this block type, as in the reference
        self.linear1 = Dense(planes, planes, bias=False, dtype=dtype)
        self.bn1 = _bn(planes)
        self.transformer2 = PointTransformerLayer(planes, planes, share_planes, dtype=dtype)
        self.bn2 = _bn(planes)
        self.linear3 = Dense(planes, planes, bias=False, dtype=dtype)
        self.bn3 = _bn(planes)

    def forward(self, p, x, offsets, nsample: int, train: bool = False) -> torch.Tensor:
        h = torch.relu(self.bn1(self.linear1(x), train))
        h = torch.relu(self.bn2(self.transformer2(p, h, offsets, nsample, train), train))
        return torch.relu(self.bn3(self.linear3(h), train) + x)


class EdgeConvBlock(nn.Module):
    """Residual EdgeConv block (``:167-193``); ``mid_res`` moves the skip to
    after ``linear1``."""

    def __init__(self, planes: int, share_planes: int = 8, mid_res: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        del share_planes  # unused by this block type, as in the reference
        self.mid_res = mid_res
        self.linear1 = Dense(planes, planes, bias=False, dtype=dtype)
        self.bn1 = _bn(planes)
        self.local_aggr = PointNet2EdgeConvLayer(planes, planes, dtype=dtype)
        self.linear3 = Dense(planes, planes, bias=False, dtype=dtype)
        self.bn3 = _bn(planes)

    def forward(self, p, x, offsets, nsample: int, train: bool = False) -> torch.Tensor:
        h = torch.relu(self.bn1(self.linear1(x), train))
        identity = h if self.mid_res else x
        h = self.local_aggr(p, h, offsets, nsample, train)
        return torch.relu(self.bn3(self.linear3(h), train) + identity)


BLOCKS = {"PointTransformerBlock": PointTransformerBlock, "EdgeConvBlock": EdgeConvBlock}


class TransitionDown(nn.Module):
    """Stride 1: Dense + BatchNorm + ReLU. Otherwise FPS to ``npoint`` a cloud,
    kNN-group over ``nsample``, Dense + BatchNorm + ReLU and the max over
    the neighbours (``:202-236``)."""

    def __init__(self, in_planes: int, out_planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride = stride
        self.linear = Dense(in_planes + (0 if stride == 1 else 3), out_planes, bias=False,
                            dtype=dtype)
        self.bn = _bn(out_planes)

    def forward(self, p, x, offsets, npoint: int = 0, nsample: int = 0, train: bool = False):
        if self.stride == 1:
            return p, torch.relu(self.bn(self.linear(x), train)), offsets
        B = len(offsets)
        idx = ragged.farthest_point_sample_packed(p, offsets, npoint)  # [B, m]
        new_p = p[idx.reshape(-1).long()]
        new_offsets = _offsets(B, npoint)
        rel, feats = knn_group(nsample, p, offsets, new_p, new_offsets, x)
        h = torch.relu(self.bn(self.linear(torch.cat([rel, feats], dim=-1)), train))
        return new_p, h.amax(1), new_offsets


class TransitionUp(nn.Module):
    """Decoder upsampling (``:239-285``). Head mode (``out_planes`` None):
    each point's features beside a Dense of its cloud's mean, then
    ``linear1``. Fusion mode: ``linear1`` of the fine skip plus the
    interpolated ``linear2`` of the coarse level."""

    def __init__(self, in_planes: int, out_planes: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.head = out_planes is None
        if self.head:
            self.linear2_0 = Dense(in_planes, in_planes, dtype=dtype)
            self.linear1_0 = Dense(2 * in_planes, in_planes, dtype=dtype)
            self.linear1_1 = _bn(in_planes)
        else:
            self.linear1_0 = Dense(out_planes, out_planes, dtype=dtype)
            self.linear1_1 = _bn(out_planes)
            self.linear2_0 = Dense(in_planes, out_planes, dtype=dtype)
            self.linear2_1 = _bn(out_planes)

    def forward(self, p1, x1, o1, p2=None, x2=None, o2=None, train: bool = False):
        if self.head:
            spans = ragged.bounds(o1)
            counts = torch.tensor([e - s for s, e in spans], device=x1.device)
            mean = torch.stack([x1[s:e].sum(0) for s, e in spans]) / counts[:, None].to(x1.dtype)
            g = torch.relu(self.linear2_0(mean))
            g = torch.repeat_interleave(g, counts, dim=0, output_size=x1.shape[0])
            h = torch.cat([x1, g], dim=-1)
            return torch.relu(self.linear1_1(self.linear1_0(h), train))
        a = torch.relu(self.linear1_1(self.linear1_0(x1), train))
        b = torch.relu(self.linear2_1(self.linear2_0(x2), train))
        return a + ragged.interpolation_packed(p2, o2, p1, o1, b)


@dataclasses.dataclass(frozen=True)
class PointTransformerConfig:
    """PTSeg's hyper-parameters (``:288-303``; blocks [2, 3, 4, 6, 3])."""

    block: str = "PointTransformerBlock"
    blocks: Tuple[int, ...] = (2, 3, 4, 6, 3)
    width: int = 32
    nsample: Tuple[int, ...] = (8, 16, 16, 16, 16)
    strides: Tuple[int, ...] = (1, 4, 4, 4, 4)
    in_channels: int = 6  # read nowhere, as in the reference: see feat_channels
    num_classes: int = 13
    share_planes: int = 8
    dec_local_aggr: bool = True
    mid_res: bool = False


class PointTransformerSeg(nn.Module):
    """PTSeg: ``forward(pts [B, N, 3], feats [B, N, feat_channels] | None)``
    -> ``[B, N, classes]``; without ``feats`` the coordinates are the
    features. ``N`` must divide by the product of the strides."""

    def __init__(self, config: PointTransformerConfig = PointTransformerConfig(),
                 feat_channels: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        block = BLOCKS[cfg.block]
        planes = [cfg.width * 2 ** i for i in range(len(cfg.blocks))]
        width = feat_channels
        for lvl, n_blocks in enumerate(cfg.blocks):
            self.add_module(f"enc{lvl + 1}_0", TransitionDown(width, planes[lvl],
                                                              cfg.strides[lvl], dtype=dtype))
            for j in range(1, n_blocks):
                self.add_module(f"enc{lvl + 1}_{j}", block(
                    planes[lvl], cfg.share_planes, mid_res=cfg.mid_res, dtype=dtype))
            width = planes[lvl]
        n_lvl = len(cfg.blocks)
        for lvl in range(n_lvl - 1, -1, -1):
            self.add_module(f"dec{lvl + 1}_0", TransitionUp(
                planes[-1], None, dtype=dtype) if lvl == n_lvl - 1 else TransitionUp(
                planes[lvl + 1], planes[lvl], dtype=dtype))
            if cfg.dec_local_aggr:
                self.add_module(f"dec{lvl + 1}_1", block(
                    planes[lvl], cfg.share_planes, mid_res=cfg.mid_res, dtype=dtype))
        self.cls_0 = Dense(planes[0], planes[0], dtype=dtype)
        self.cls_1 = _bn(planes[0])
        self.cls_3 = Dense(planes[0], cfg.num_classes, dtype=dtype)

    def levels(self, N: int) -> List[Tuple[int, int, int]]:
        """(points a cloud, the transition's nsample, the blocks' nsample) by
        level for clouds of ``N`` points: the static clamps of
        ``ppt_tpu/nn/pointtransformer.py:328-349`` (kNN with k past the
        population is undefined)."""
        cfg = self.config
        total_stride = 1
        for st in cfg.strides:
            total_stride *= st
        if N % total_stride:
            raise ValueError(f"PointTransformerSeg: N={N} must be divisible by {total_stride}")
        out, counts = [], N
        for lvl in range(len(cfg.blocks)):
            prev, counts = counts, counts // cfg.strides[lvl]
            out.append((counts, min(cfg.nsample[lvl], prev), min(cfg.nsample[lvl], counts)))
        return out

    def forward(self, pts: torch.Tensor, feats: Optional[torch.Tensor] = None,
                train: bool = False, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """``generator`` is read nowhere (PTSeg draws nothing); it keeps the
        scene backbones' signature."""
        del generator
        cfg = self.config
        B, N, _ = pts.shape
        levels = self.levels(N)
        p = pts.reshape(B * N, 3).float()
        x = (feats if feats is not None else pts).reshape(B * N, -1).to(self.dtype)
        o = _offsets(B, N)
        skips = []
        for lvl, (counts, ns_down, ns) in enumerate(levels):
            p, x, o = getattr(self, f"enc{lvl + 1}_0")(p, x, o, counts, ns_down, train)
            for j in range(1, cfg.blocks[lvl]):
                x = getattr(self, f"enc{lvl + 1}_{j}")(p, x, o, ns, train)
            skips.append((p, x, o))
        n_lvl = len(cfg.blocks)
        coarse = None
        for lvl in range(n_lvl - 1, -1, -1):
            pl, xl, ol = skips[lvl]
            up = getattr(self, f"dec{lvl + 1}_0")
            x = up(pl, xl, ol, train=train) if coarse is None else up(pl, xl, ol, *coarse, train)
            if cfg.dec_local_aggr:
                x = getattr(self, f"dec{lvl + 1}_1")(pl, x, ol, levels[lvl][2], train)
            coarse = (pl, x, ol)
        h = torch.relu(self.cls_1(self.cls_0(coarse[1]), train))
        return self.cls_3(h).reshape(B, N, cfg.num_classes)
