"""GraphViT-3D: a plain ViT over point-patch embeddings, channels-last.

Counterpart of ``ppt_tpu/nn/graphvit.py`` (openpoints' ``ViTGraph`` with
the ``PointPatchEmbed`` contract). The upstream file imports a
``GroupEmbed`` that exists nowhere in its tree (``ppt_tpu/nn/graphvit.py:
9-15``), so the embed is bound as the reference binds it: FPS centres on
``kernels/group.py:fps_batched``, kNN or ball neighbourhoods (plain, as the
reference's XLA), two conv stages around a max-pooled bottleneck. The
encoder is PointBERT's ``VitBlock`` with the position embedding added
before every block, on route "block": one ``fused_vit_block`` launch a
block on the card (the unfused block from ``FLASH_MIN_SEQ`` tokens, as
``PointBert`` does). The BatchNorms are flax's (momentum 0.99), the
position MLP's GELU the tanh form, the final LayerNorm f32. The module
returns every token; ``cls_feat`` reads ``[cls, max over patches]``.
Module and parameter names mirror the flax tree (``group_embed/conv1_0``,
``proj_layer``, ``block_3``, ``norm``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ppt_torch.kernels import group as kgroup
from ppt_torch.kernels.attention import FLASH_MIN_SEQ
from ppt_torch.nn.layers import (BatchNorm, Dense, LayerNormF32, drop_path_scales,
                                 gelu_tanh)
from ppt_torch.nn.pointbert import VitBlock
from ppt_torch.ops.geometry import index_points, knn_point, query_ball_point

FEATURE_TYPES = ("dp", "fj", "dp_fj", "df", "dp_df")


class PointPatchEmbed(nn.Module):
    """FPS + neighbourhood grouping + two conv stages with a global-max
    bottleneck (``ppt_tpu/nn/graphvit.py:34-99``): with ``layers`` 4 the
    widths are [e, e] then [2e, e] on the max-pool concatenation, each
    stage's last conv linear with a bias, the others bias-free before a
    BatchNorm and ReLU. ``in_channels`` is the width of the features given
    (the coordinates' 3 when there are none)."""

    def __init__(self, in_channels: int = 3, num_groups: int = 256, group_size: int = 32,
                 embed_dim: int = 256, layers: int = 4, feature_type: str = "dp_fj",
                 group: str = "knn", radius: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        if feature_type not in FEATURE_TYPES:
            raise ValueError(f"PointPatchEmbed: feature_type {feature_type!r} not in "
                             f"{FEATURE_TYPES}")
        self.num_groups, self.group_size = num_groups, group_size
        self.feature_type, self.radius = feature_type, radius
        self.ball = "ball" in group or "query" in group
        self.dtype = dtype
        e = embed_dim
        width = {"dp": 3, "fj": in_channels, "df": in_channels}.get(feature_type,
                                                                   3 + in_channels)
        self.half = layers // 2
        for i in range(self.half):
            last = i == self.half - 1
            self.add_module(f"conv1_{i}", Dense(width, e, bias=last, dtype=dtype))
            if not last:
                self.add_module(f"bn1_{i}", BatchNorm(e))
            width = e
        self.widths2 = [2 * e] * (layers - self.half - 1) + [e]
        width = 2 * e
        for i, w in enumerate(self.widths2):
            last = i == len(self.widths2) - 1
            self.add_module(f"conv2_{i}", Dense(width, w, bias=last, dtype=dtype))
            if not last:
                self.add_module(f"bn2_{i}", BatchNorm(w))
            width = w

    def _stage(self, h: torch.Tensor, name: str, depth: int, train: bool) -> torch.Tensor:
        for i in range(depth):
            h = getattr(self, f"conv{name}_{i}")(h)
            if i < depth - 1:
                h = torch.relu(getattr(self, f"bn{name}_{i}")(h, train))
        return h

    def forward(self, p: torch.Tensor, x: Optional[torch.Tensor] = None,
                train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """p [B, N, 3] f32, x [B, N, C] or None -> (centres [B, G, 3],
        embeddings [B, G, e])."""
        dt, ft = self.dtype, self.feature_type
        idx = kgroup.fps_batched(p, self.num_groups)
        center = index_points(p, idx)
        if self.ball:
            nbr = query_ball_point(self.radius, self.group_size, p, center)
        else:
            nbr = knn_point(self.group_size, p, center)
        dp = (index_points(p, nbr) - center[:, :, None, :]).to(dt)
        feats = x if x is not None else p
        fj = index_points(feats, nbr).to(dt)
        if ft in ("df", "dp_df"):
            fj = fj - index_points(feats, idx).to(dt)[:, :, None, :]
        h = {"dp": dp, "fj": fj, "df": fj}.get(ft)
        if h is None:  # dp_fj, dp_df
            h = torch.cat([dp, fj], dim=-1)
        h = self._stage(h, "1", self.half, train)
        pooled = h.amax(2, keepdim=True)
        h = torch.cat([pooled.expand_as(h), h], dim=-1)
        h = self._stage(h, "2", len(self.widths2), train)
        return center, h.amax(2)


@dataclasses.dataclass(frozen=True)
class GraphVit3dConfig:
    in_chans: int = 3  # the features' width (the coordinates' when none are given)
    encoder_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    drop_path_rate: float = 0.0
    num_groups: int = 256
    group_size: int = 32
    embed_dim: int = 256
    feature_type: str = "dp_fj"
    group: str = "knn"


class GraphVit3d(nn.Module):
    """ViTGraph (``:102-172``): patch embed -> proj -> cls token and the
    position embedding before every block -> f32 LayerNorm. ``forward``
    returns (centres [B, G, 3], tokens [B, 1 + G, D] f32)."""

    def __init__(self, config: GraphVit3dConfig = GraphVit3dConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        D = cfg.encoder_dim
        self.group_embed = PointPatchEmbed(cfg.in_chans, cfg.num_groups, cfg.group_size,
                                           cfg.embed_dim, feature_type=cfg.feature_type,
                                           group=cfg.group, dtype=dtype)
        self.proj_layer = Dense(cfg.embed_dim, D, dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.cls_pos = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_embed1 = Dense(3, 128, dtype=dtype)
        self.pos_embed2 = Dense(128, D, dtype=dtype)
        for i in range(cfg.depth):
            self.add_module(f"block_{i}", VitBlock(D, cfg.num_heads, cfg.mlp_ratio, dtype=dtype))
        self.norm = LayerNormF32(D, eps=1e-6)

    @torch.no_grad()
    def init_leaves_(self, gen: torch.Generator) -> None:
        """The cls token and position, N(0, 0.02) as the reference
        initialises them, drawn from ``gen`` on the CPU."""
        for t in (self.cls_token, self.cls_pos):
            t.copy_(0.02 * torch.randn(t.shape, generator=gen))

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor] = None,
                train: bool = False, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``train``: batch statistics in the embed's BatchNorms and DropPath
        drawn from ``generator``."""
        cfg = self.config
        dt = self.dtype
        width = 3 if features is None else features.shape[-1]
        if width != cfg.in_chans:
            raise ValueError(f"GraphVit3d: built for {cfg.in_chans}-wide features, got {width}")
        center, emb = self.group_embed(xyz.float(), features, train)
        h = self.proj_layer(emb)
        B = h.shape[0]
        pos = self.pos_embed2(gelu_tanh(self.pos_embed1(center)))
        h = torch.cat([self.cls_token.to(dt).expand(B, 1, -1), h], dim=1)
        pos = torch.cat([self.cls_pos.to(dt).expand(B, 1, -1), pos], dim=1)
        rates = np.linspace(0.0, cfg.drop_path_rate, cfg.depth).tolist()
        dp = drop_path_scales(rates, B, train, generator, h.device)
        route = "block" if h.shape[1] < FLASH_MIN_SEQ else "unfused"
        for i in range(cfg.depth):
            h = getattr(self, f"block_{i}")(h, pos, dp[i], route=route,
                                            rate=rates[i] if train else 0.0)
        return center, self.norm(h.float())

    def cls_feat(self, xyz: torch.Tensor, features: Optional[torch.Tensor] = None,
                 train: bool = False, generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """``[cls token, max over the patch tokens]`` -> [B, 2D] f32."""
        _, tokens = self(xyz, features, train, generator)
        return torch.cat([tokens[:, 0], tokens[:, 1:].amax(1)], dim=-1)
