"""Graph-convolution backbones: BallDGCNN, DeepGCN, GroupPointNet.

Counterpart of ``ppt_tpu/nn/gcn.py``, channels-last ``[B, N, C]``, the 1x1
convolutions as Dense, the neighbourhood gathers through
``ops/geometry.py``. Module and parameter names mirror the flax tree
(``edge0/conv``, ``edge0/bn``, ``fusion/conv``, ``conv0/bn``), so
``ppt_torch.convert.from_jax`` maps every leaf.

The traps:
- the edge feature is ``[center, neighbor - center]`` (the openpoints
  EdgeConv's), the opposite of ``nn/classic.py``'s DGCNN;
- the conv block's order differs by tower: BallDGCNN and GroupPointNet
  conv-act-norm (``can``), DeepGCN conv-norm-act (``cna``); no bias where a
  norm follows;
- DeepGCN's dilated kNN takes ``k * dilation`` neighbours strided by the
  dilation; its stochastic graph (training only) draws a random k-subset
  from the ``graph`` generator with probability ``epsilon``, and refuses
  without one, as the reference's module asks for its ``graph`` rng (no
  driver reaches it);
- GroupPointNet's FPS runs on ``kernels/group.py:fps_batched`` (the kernel
  on the card: 1024 -> 256 at its ``sample_ratio`` of 0.25); the ball
  queries and kNN stay ``query_ball_point`` / ``knn_point``, the
  expanded-form distance, as the reference runs them as XLA. Its grouper is
  always the ball query, as the reference's executes it
  (``ppt_tpu/nn/gcn.py:191-199``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ppt_torch.kernels import group as kgroup
from ppt_torch.nn.layers import BatchNorm, Dense, leaky_relu
from ppt_torch.ops import geometry as ops


def _edge_features(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``[center, neighbor - center]`` over the gathered neighbours
    (``EdgeConv.forward``): ``[B, N, K, 2C]``."""
    nbrs = ops.index_points(feats, idx)  # [B, N, K, C]
    center = feats[:, :, None, :].expand_as(nbrs)
    return torch.cat([center, nbrs - center], dim=-1)


class _ConvBlock(nn.Module):
    """``create_convblock``: Dense + BatchNorm + activation, ``order``
    ``can`` (conv-act-norm) or ``cna`` (conv-norm-act); ``act`` is
    ``("relu", 0)`` or ``("lrelu", slope)``."""

    def __init__(self, in_channels: int, features: int, order: str = "cna",
                 act: Tuple[str, float] = ("relu", 0.0), use_bias: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.order, self.act = order, act
        self.conv = Dense(in_channels, features, bias=use_bias, dtype=dtype)
        self.bn = BatchNorm(features)

    def _activate(self, h: torch.Tensor) -> torch.Tensor:
        kind, slope = self.act
        return torch.relu(h) if kind == "relu" else leaky_relu(h, slope)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.conv(x)
        if self.order == "can":
            return self.bn(self._activate(x), train)
        return self._activate(self.bn(x, train))


def _pool(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x.amax(dim=1), x.mean(dim=1)], dim=-1)


class BallDgcnn(nn.Module):
    """DGCNN over one static spatial graph (``ppt_tpu/nn/gcn.py:76-127``):
    edge convs 64, 64, 128, 256 over the graph of the coordinates, concat
    512, fusion to ``embed_dim``; ``forward`` gives the per-point fusion
    features ``[B, N, embed_dim]``, ``cls_feat`` their max and mean."""

    def __init__(self, in_channels: int = 3, channels: int = 64, embed_dim: int = 1024,
                 n_blocks: int = 5, k: int = 20, group: str = "ballquery",
                 radius: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.k, self.group, self.radius = dtype, k, group, radius
        self.n_edges = n_blocks - 1
        cin, ch, total = in_channels, channels, 0
        for i in range(self.n_edges):
            self.add_module(f"edge{i}", _ConvBlock(2 * cin, ch, order="can",
                                                   act=("lrelu", 0.2), dtype=dtype))
            cin, total = ch, total + ch
            if i > 0:
                ch *= 2
        self.fusion = _ConvBlock(total, embed_dim, order="can", act=("lrelu", 0.2), dtype=dtype)

    def forward(self, xyz: torch.Tensor, train: bool = False) -> torch.Tensor:
        pts = xyz.float()
        if "ball" in self.group or "query" in self.group:
            idx = ops.query_ball_point(self.radius, self.k, pts, pts)
        else:
            idx = ops.knn_point(self.k, pts, pts)
        x = xyz.to(self.dtype)
        feats = []
        for i in range(self.n_edges):
            x = getattr(self, f"edge{i}")(_edge_features(x, idx), train).amax(dim=2)
            feats.append(x)
        return self.fusion(torch.cat(feats, dim=-1), train)

    def cls_feat(self, xyz: torch.Tensor, train: bool = False) -> torch.Tensor:
        return _pool(self(xyz, train))


@dataclasses.dataclass(frozen=True)
class DeepGcnConfig:
    in_channels: int = 3
    channels: int = 64
    emb_dims: int = 1024
    n_blocks: int = 14
    block: str = "res"  # 'res' | 'plain' | 'dense'
    k: int = 16
    epsilon: float = 0.2
    use_stochastic: bool = True
    use_dilation: bool = True


class DeepGcn(nn.Module):
    """DeepGCN (``ppt_tpu/nn/gcn.py:143-219``): dilated dynamic-kNN EdgeConvs
    with residual, plain or dense wiring, every level concatenated, a
    fusion conv; ``forward`` gives ``[B, N, emb_dims]``."""

    def __init__(self, config: DeepGcnConfig = DeepGcnConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        self.edge0 = _ConvBlock(2 * cfg.in_channels, cfg.channels, order="cna", dtype=dtype)
        width, total = cfg.channels, cfg.channels
        for i in range(cfg.n_blocks - 1):
            self.add_module(f"edge{i + 1}", _ConvBlock(2 * width, cfg.channels, order="cna",
                                                       dtype=dtype))
            width = width + cfg.channels if cfg.block == "dense" else cfg.channels
            total += width
        self.fusion = _ConvBlock(total, cfg.emb_dims, order="cna", act=("lrelu", 0.2),
                                 dtype=dtype)

    def _dilated_knn(self, feats: torch.Tensor, dilation: int, stochastic: bool,
                     graph: Optional[torch.Generator]) -> torch.Tensor:
        cfg = self.config
        idx = ops.knn_point(cfg.k * dilation, feats, feats)
        if stochastic:
            if graph is None:
                raise ValueError("DeepGcn: the stochastic graph in training draws from a "
                                 "'graph' generator; pass one, or use_stochastic=False")
            randsub = torch.randperm(cfg.k * dilation, generator=graph,
                                     device=graph.device)[:cfg.k].to(idx.device)
            if bool(torch.rand((), generator=graph, device=graph.device) < cfg.epsilon):
                return idx[:, :, randsub]
        return idx[:, :, ::dilation]

    def forward(self, xyz: torch.Tensor, train: bool = False,
                graph: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.config
        pts = xyz[..., :3].float()
        x = xyz.to(self.dtype)
        idx = ops.knn_point(cfg.k, pts, pts)  # the head's graph is over the coordinates
        feats = [self.edge0(_edge_features(x, idx), train).amax(dim=2)]
        stochastic = train and cfg.use_stochastic and cfg.block != "plain"
        for i in range(cfg.n_blocks - 1):
            dilation = 1 + i if cfg.use_dilation and cfg.block != "plain" else 1
            prev = feats[-1]
            idx = self._dilated_knn(prev, dilation, stochastic, graph)
            h = getattr(self, f"edge{i + 1}")(_edge_features(prev, idx), train).amax(dim=2)
            if cfg.block == "res":
                feats.append(h + prev)
            elif cfg.block == "dense":
                feats.append(torch.cat([prev, h], dim=-1))
            else:
                feats.append(h)
        return self.fusion(torch.cat(feats, dim=-1), train)

    def cls_feat(self, xyz: torch.Tensor, train: bool = False,
                 graph: Optional[torch.Generator] = None) -> torch.Tensor:
        return _pool(self(xyz, train, graph))


class GroupPointNet(nn.Module):
    """FPS (the kernel on the card) + one ball-query grouping + shared MLPs
    + the max over each group (``ppt_tpu/nn/gcn.py:186-246``): ``[B, M,
    channels]`` with ``M = int(N * sample_ratio)``."""

    def __init__(self, in_channels: int = 3, channels: int = 64, n_blocks: int = 5,
                 sample_ratio: float = 0.25, nsample: int = 20, radius: float = 0.1,
                 group: str = "ballquery", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.sample_ratio = dtype, sample_ratio
        self.nsample, self.radius, self.group = nsample, radius, group
        self.depth = n_blocks - 2
        cin = 3 + in_channels
        for i in range(self.depth):
            self.add_module(f"conv{i}", _ConvBlock(cin, channels, order="can",
                                                   act=("lrelu", 0.2), dtype=dtype))
            cin = channels

    def forward(self, xyz: torch.Tensor, train: bool = False) -> torch.Tensor:
        pts = xyz[..., :3].float()
        npoint = int(pts.shape[1] * self.sample_ratio)
        centers = ops.index_points(pts, kgroup.fps_batched(pts, npoint))  # [B, M, 3]
        if "ball" in self.group or "query" in self.group:
            nbr = ops.query_ball_point(self.radius, self.nsample, pts, centers)
        else:
            nbr = ops.knn_point(self.nsample, pts, centers)
        dp = ops.index_points(pts, nbr) - centers[:, :, None, :]
        x = torch.cat([dp.to(self.dtype), ops.index_points(xyz.to(self.dtype), nbr)], dim=-1)
        for i in range(self.depth):
            x = getattr(self, f"conv{i}")(x, train)
        return x.amax(dim=2)

    def cls_feat(self, xyz: torch.Tensor, train: bool = False) -> torch.Tensor:
        return _pool(self(xyz, train))
