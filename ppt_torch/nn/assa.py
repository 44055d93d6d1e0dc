"""ASSA, ASSANet's anisotropic separable set abstraction, channels-last.

Counterpart of ``ppt_tpu/nn/assa.py`` (openpoints'
``local_aggregation.py``): pointwise pre-convs on the support set, a ball
query (plain, as the reference's XLA) with the relative coordinates
divided by the radius, the neighbourhood reduction, post-convs on the
queries and a residual from the pre-conv features. The anisotropic
(``assa``) reduction multiplies the neighbours' features by each of the
three relative-coordinate channels:

    out[b, q, (a, c)] = reduce_s  dp[b, q, s, a] * fj[b, q, s, c]

(one batched product over the neighbours for ``mean`` and ``sum``, the
expanded product for ``max``), channels in (axis major, feature minor)
order. For ``assa`` without ``use_inverted_dims`` the pre-reduction width
is ``ceil(w / 3)``, so that the 3x expansion gives back about ``w``.
Module names mirror the flax tree (``conv0/conv``, ``conv2/bn``,
``skip_layer``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ppt_torch.nn.layers import Dense
from ppt_torch.nn.pointnext import _ConvBnAct
from ppt_torch.ops.geometry import index_points, query_ball_point

FEATURE_TYPES = ("assa", "dp_fj")
REDUCTIONS = ("mean", "sum", "max")


class Assa(nn.Module):
    """``channels`` is the reference's channel list, the input width first
    (before the ``ceil(w / 3)`` adjustment, made here)."""

    def __init__(self, channels: Sequence[int], radius: float = 0.1, nsample: int = 16,
                 feature_type: str = "assa", reduction: str = "mean", use_res: bool = True,
                 use_inverted_dims: bool = False, normalize_dp: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if feature_type not in FEATURE_TYPES or reduction not in REDUCTIONS:
            raise ValueError(f"Assa: feature_type {feature_type!r} must be one of "
                             f"{FEATURE_TYPES}, reduction {reduction!r} one of {REDUCTIONS}")
        self.radius, self.nsample = radius, nsample
        self.feature_type, self.reduction = feature_type, reduction
        self.use_res, self.normalize_dp = use_res, normalize_dp
        self.dtype = dtype
        chans = list(channels)
        self.num_preconv = npre = int(math.ceil((len(chans) - 1) / 2))
        if feature_type == "assa" and not use_inverted_dims:
            chans[npre] = int(math.ceil(chans[npre] / 3.0))
        for i in range(npre):
            self.add_module(f"conv{i}", _ConvBnAct(chans[i], chans[i + 1], dtype=dtype))
        c = chans[npre]
        width = 3 * c if feature_type == "assa" else 3 + c
        self.num_convs = len(chans) - 1
        for i in range(npre, len(chans) - 1):
            last = use_res and i == len(chans) - 2
            self.add_module(f"conv{i}", _ConvBnAct(width, chans[i + 1], use_act=not last,
                                                   dtype=dtype))
            width = chans[i + 1]
        if use_res and c != chans[-1]:
            self.skip_layer = Dense(c, chans[-1], bias=False, dtype=dtype)
        else:
            self.skip_layer = None

    def forward(self, query_xyz: torch.Tensor, support_xyz: torch.Tensor, feats: torch.Tensor,
                query_idx: Optional[torch.Tensor] = None, train: bool = False) -> torch.Tensor:
        """query_xyz [B, np, 3], support_xyz [B, N, 3], feats [B, N, C],
        query_idx [B, np] into the support set (the residual's rows; without
        it the queries are the support set) -> [B, np, channels[-1]]."""
        h = feats.to(self.dtype)
        for i in range(self.num_preconv):
            h = getattr(self, f"conv{i}")(h, train)
        skip_src = h
        idx = query_ball_point(self.radius, self.nsample, support_xyz, query_xyz)
        dp = index_points(support_xyz, idx) - query_xyz[:, :, None, :]
        if self.normalize_dp:
            dp = dp / self.radius
        fj = index_points(h, idx)  # [B, np, ns, C']
        dp = dp.to(self.dtype).to(torch.promote_types(self.dtype, fj.dtype))
        if self.feature_type == "assa":
            B, S = fj.shape[0], fj.shape[1]
            if self.reduction == "max":
                agg = (dp[..., :, None] * fj[..., None, :]).amax(2)
            else:
                agg = torch.einsum("bqsa,bqsc->bqac", dp, fj)  # sums over the neighbours
                if self.reduction == "mean":
                    agg = agg / self.nsample
            h = agg.reshape(B, S, -1)  # (axis major, feature minor)
        else:
            cat = torch.cat([dp, fj], dim=-1)
            if self.reduction == "mean":
                h = cat.mean(2)
            elif self.reduction == "sum":
                h = cat.sum(2)
            else:
                h = cat.amax(2)
        for i in range(self.num_preconv, self.num_convs):
            h = getattr(self, f"conv{i}")(h, train)
        if self.use_res:
            skip = skip_src if query_idx is None else index_points(skip_src, query_idx)
            if self.skip_layer is not None:
                skip = self.skip_layer(skip)
            h = torch.relu(h + skip)
        return h
