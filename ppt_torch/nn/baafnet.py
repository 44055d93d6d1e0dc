"""BAAF-Net, bilateral augmentation and adaptive fusion, for scene segmentation.

Counterpart of ``ppt_tpu/nn/baafnet.py``, channels-last ``[B, N, C]``:
bilateral context blocks at five levels with FPS between them, a decoder
per level that climbs back by 1-NN gathers, and the decoders' outputs
fused by softmax weights. Module and parameter names mirror the flax tree
(``mlp0/linear``, ``EncoderBCBModules_0/BA/mlp1/bn``,
``DecoderReconModules_0_1``, ``classifier_3``, ...), so
``ppt_torch.convert.from_jax`` maps every leaf.

The traps:
- FPS goes through ``kernels/group.py:fps_batched`` (the kernel on the
  card), as the reference reaches its chip's kernel through
  ``ops.farthest_point_sample``: at the default config B x 4096 -> 1024 ->
  256 -> 64 -> 16 -> 4, five launches a forward. The sample counts come from
  ``config.n_points``, not from the input;
- the kNN and the 1-NN upsampling are ``lax.top_k`` over the expanded
  distance, DESCENDING under ``farthest_knn=True`` (the reference's
  executed defect: its ``topk`` lacks ``largest=False``); ties go to the
  lower index both ways, so both are ``ops/geometry.py:nearest_first``
  (of the negated distances for the descending case), never
  ``torch.topk``;
- ``mlp0`` takes the features ``forward`` is given (rgb on S3DIS: 3 wide,
  whatever ``dims[0]`` says), so it is sized by ``feat_channels``;
- BatchNorm is flax's default (momentum 0.99, eps 1e-5), and the last
  classifier layer has BatchNorm and ReLU too.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ppt_torch.kernels import group as kgroup
from ppt_torch.nn.layers import BatchNorm, Dense, dropout, leaky_relu
from ppt_torch.ops import geometry as ops


def _knn(p_db: torch.Tensor, p_q: torch.Tensor, k: int, farthest: bool) -> torch.Tensor:
    """``[B, Nq, k]`` indices by expanded-form distance, nearest first (or
    farthest first), ties to the lower index (``baafnet.py:_knn``)."""
    d = ops.square_distance(p_q, p_db)
    return ops.nearest_first(-d if farthest else d, k)[1]


class Mlp(nn.Module):
    """Dense (+ BatchNorm) + activation (``relu``, ``lrelu`` at 0.2, or
    ``none``): the reference's 1x1 convolutions and their transposes."""

    def __init__(self, d_in: int, d_out: int, bn: bool = True, act: str = "relu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act = act
        self.linear = Dense(d_in, d_out, dtype=dtype)
        if bn:
            self.bn = BatchNorm(d_out)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.linear(x)
        if hasattr(self, "bn"):
            x = self.bn(x, train)
        if self.act == "relu":
            return torch.relu(x)
        if self.act == "lrelu":
            return leaky_relu(x, 0.2)
        return x


def _embed(x: torch.Tensor, x_knn: torch.Tensor) -> torch.Tensor:
    xe = x[:, :, None, :].expand_as(x_knn)
    return torch.cat([xe, x_knn - xe], dim=-1)


class BilateralAugmentation(nn.Module):
    """Returns (``alc`` [B, N, k, d_out], ``p_knn_tilde`` [B, N, k, 3])."""

    def __init__(self, d_in: int, d_out: int, k: int = 16, farthest_knn: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        h = d_out // 2
        self.k, self.farthest_knn, self.dtype = k, farthest_knn, dtype
        self.mlp0 = Mlp(d_in, h, dtype=dtype)
        self.mlp1 = Mlp(2 * h, 3, dtype=dtype)
        self.mlp2 = Mlp(9, h, dtype=dtype)
        self.mlp3 = Mlp(9, h, dtype=dtype)
        self.mlp4 = Mlp(3 * h, h, dtype=dtype)

    def forward(self, p, f, train: bool = False):
        knn_idx = _knn(p, p, self.k, self.farthest_knn)
        f = self.mlp0(f, train)
        p_knn = ops.index_points(p, knn_idx).to(self.dtype)
        f_knn = ops.index_points(f, knn_idx)
        lgc = _embed(p.to(self.dtype), p_knn)  # [B, N, k, 6]
        lsc = _embed(f, f_knn)
        p_knn_tilde = self.mlp1(lsc, train) + p_knn
        lgc_aug = torch.cat([lgc, p_knn_tilde], dim=-1)  # [B, N, k, 9]
        f_knn_tilde = self.mlp2(lgc_aug, train) + f_knn
        lsc_aug = torch.cat([lsc, f_knn_tilde], dim=-1)
        alc = torch.cat([self.mlp3(lgc_aug, train), self.mlp4(lsc_aug, train)], dim=-1)
        return alc, p_knn_tilde


class MixedLocalAggregation(nn.Module):
    """Softmax-weighted sum and max over the neighbours, then two MLPs:
    ``[B, N, k, d]`` -> ``[B, N, 2d]``."""

    def __init__(self, d: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mlp0 = Mlp(d, d, bn=False, act="none", dtype=dtype)
        self.mlp1 = Mlp(2 * d, d, dtype=dtype)
        self.mlp2 = Mlp(d, 2 * d, act="lrelu", dtype=dtype)

    def forward(self, alc: torch.Tensor, train: bool = False) -> torch.Tensor:
        w = torch.softmax(self.mlp0(alc, train), dim=2)
        s = (alc * w).sum(2, keepdim=True)
        m = alc.amax(2, keepdim=True)
        mla = self.mlp2(self.mlp1(torch.cat([s, m], dim=-1), train), train)
        return mla[:, :, 0, :]


class BilateralContextBlock(nn.Module):
    def __init__(self, d_in: int, d_out: int, k: int = 16, farthest_knn: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.BA = BilateralAugmentation(d_in, d_out, k, farthest_knn, dtype=dtype)
        self.MLA = MixedLocalAggregation(d_out, dtype=dtype)

    def forward(self, p, f, train: bool = False):
        alc, p_knn_tilde = self.BA(p, f, train)
        return self.MLA(alc, train), p_knn_tilde


@dataclasses.dataclass(frozen=True)
class BaafNetConfig:
    n_points: int = 4096
    ds_ratio: int = 4
    k: int = 16
    num_classes: int = 13
    # dims[0]: the input features' channels (read nowhere: see feat_channels);
    # the rest are the encoder widths
    dims: Tuple[int, ...] = (3, 4, 16, 64, 128, 256, 512)
    farthest_knn: bool = False


class BaafNet(nn.Module):
    """``forward(p [B, N, 3], f [B, N, feat_channels]) -> [B, N, classes]``."""

    def __init__(self, config: BaafNetConfig = BaafNetConfig(), feat_channels: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        dims = cfg.dims[1:]
        L = len(dims) - 1
        self.mlp0 = Mlp(feat_channels, 2 * dims[0], act="lrelu", dtype=dtype)
        for i in range(L):
            self.add_module(f"EncoderBCBModules_{i}", BilateralContextBlock(
                2 * dims[i], dims[i + 1], cfg.k, cfg.farthest_knn, dtype=dtype))
        # f_enc's widths: level 0 at full resolution, then each level downsampled
        enc = [2 * dims[1]] + [2 * dims[i + 1] for i in range(L)]
        for n in range(L):
            width = 2 * dims[-1 - n]
            self.add_module(f"DecoderMLPModules_{n}", Mlp(enc[-1 - n], width, dtype=dtype))
            for j in range(L - n):
                out = 2 * dims[-2 - n - j]
                self.add_module(f"DecoderReconModules_{n}_{j}",
                                Mlp(enc[-j - n - 2] + width, out, dtype=dtype))
                width = out
            self.add_module(f"DecoderWeightModules_{n}", Mlp(width, 1, bn=False, act="none",
                                                             dtype=dtype))
        self.classifier_0 = Mlp(2 * dims[0], 64, dtype=dtype)
        self.classifier_1 = Mlp(64, 32, dtype=dtype)
        self.classifier_3 = Mlp(32, cfg.num_classes, dtype=dtype)

    def forward(self, p: torch.Tensor, f: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.config
        L = len(cfg.dims) - 2
        far = cfg.farthest_knn
        f = self.mlp0(f.to(self.dtype), train)
        n_points = cfg.n_points
        f_enc, us_idx = [], []
        for i in range(L):
            f, _ = getattr(self, f"EncoderBCBModules_{i}")(p, f, train)
            if i == 0:
                f_enc.append(f)
            n_points //= cfg.ds_ratio
            ds_idx = kgroup.fps_batched(p, n_points)
            p_ds = ops.index_points(p, ds_idx)
            f = ops.index_points(f, ds_idx)
            f_enc.append(f)
            us_idx.append(_knn(p_ds, p, 1, far)[..., 0])  # [B, N_fine]
            p = p_ds

        f_dec, weights = [], []
        for n in range(L):
            f = getattr(self, f"DecoderMLPModules_{n}")(f_enc[-1 - n], train)
            for j in range(L - n):
                interp = ops.index_points(f, us_idx[-j - n - 1])
                f = getattr(self, f"DecoderReconModules_{n}_{j}")(
                    torch.cat([f_enc[-j - n - 2], interp], dim=-1), train)
            f_dec.append(f)
            weights.append(getattr(self, f"DecoderWeightModules_{n}")(f, train))
        w = torch.softmax(torch.cat(weights, dim=-1), dim=-1)
        f = sum(fd * w[..., n:n + 1] for n, fd in enumerate(f_dec))

        h = self.classifier_1(self.classifier_0(f, train), train)
        return self.classifier_3(dropout(h, 0.5, train, generator), train)
