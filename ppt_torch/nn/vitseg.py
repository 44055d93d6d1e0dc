"""PointViT segmentation: the GraphViT-3D encoder and a feature-propagation
pyramid back to every point.

Counterpart of ``ppt_tpu/nn/vitseg.py``. The upstream ``vit_seg.py``
imports a head module that does not exist (``ppt_tpu/nn/vitseg.py:7-15``),
so the model is bound as the reference binds it: the ViT tokens (cls
dropped) are the coarsest level of a PointNet++ feature-propagation
pyramid whose other levels are FPS subsets of the raw points (each on
``kernels/group.py:fps_batched``, from the full cloud), then a scene head
``Dense -> BatchNorm -> ReLU -> Dropout -> Dense``, its dropout drawn from
an explicit generator. Names mirror the flax tree (``encoder/block_3``,
``fp_2/conv0``, ``head_bn``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ppt_torch.kernels import group as kgroup
from ppt_torch.nn.graphvit import GraphVit3d, GraphVit3dConfig
from ppt_torch.nn.layers import BatchNorm, Dense, dropout
from ppt_torch.nn.pointbert import FeaturePropagation
from ppt_torch.ops.geometry import index_points


@dataclasses.dataclass(frozen=True)
class PointVitSegConfig:
    num_classes: int = 13
    encoder: GraphVit3dConfig = GraphVit3dConfig()
    # FPS skip levels between the raw points and the ViT groups
    num_points: Tuple[int, ...] = (512, 256)
    fp_width: int = 128
    head_dropout: float = 0.5


class PointVitSeg(nn.Module):
    """``forward(pts [B, N, 3], feats [B, N, encoder.in_chans] | None)`` ->
    ``[B, N, classes]``; without ``feats`` the coordinates are the
    features."""

    def __init__(self, config: PointVitSegConfig = PointVitSegConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        self.encoder = GraphVit3d(cfg.encoder, dtype=dtype)
        C = cfg.encoder.in_chans
        top = len(cfg.num_points) + 1  # the ViT centres' level
        for i in range(top, 0, -1):
            width = cfg.encoder.encoder_dim if i == top else cfg.fp_width
            self.add_module(f"fp_{i}", FeaturePropagation(C + width,
                                                          (cfg.fp_width, cfg.fp_width),
                                                          dtype=dtype))
        self.head_conv1 = Dense(cfg.fp_width, cfg.fp_width, dtype=dtype)
        self.head_bn = BatchNorm(cfg.fp_width)
        self.head_conv2 = Dense(cfg.fp_width, cfg.num_classes, dtype=dtype)

    @torch.no_grad()
    def init_leaves_(self, gen: torch.Generator) -> None:
        self.encoder.init_leaves_(gen)

    def forward(self, pts: torch.Tensor, feats: Optional[torch.Tensor] = None,
                train: bool = False, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """``train``: batch statistics everywhere, DropPath and the head's
        dropout drawn from ``generator``."""
        cfg = self.config
        x0 = (feats if feats is not None else pts).to(self.dtype)
        center, tokens = self.encoder(pts, feats, train, generator)
        xyz = pts.float()
        l_xyz, l_feats = [xyz], [x0]
        for npts in cfg.num_points:
            idx = kgroup.fps_batched(pts, npts)
            l_xyz.append(index_points(xyz, idx))
            l_feats.append(index_points(x0, idx))
        l_xyz.append(center)
        l_feats.append(tokens[:, 1:])  # cls dropped
        h = l_feats[-1]
        for i in range(len(l_xyz) - 1, 0, -1):
            h = getattr(self, f"fp_{i}")(l_xyz[i - 1], l_xyz[i], l_feats[i - 1], h, train)
        h = torch.relu(self.head_bn(self.head_conv1(h), train))
        return self.head_conv2(dropout(h, cfg.head_dropout, train, generator))
