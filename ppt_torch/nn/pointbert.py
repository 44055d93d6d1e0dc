"""PointBERT (PointTransformer) classification trunk, channels-last.

Counterpart of ``ppt_tpu/nn/pointbert.py``: grouping by the FPS + kNN
kernels, the MiniPointNet group encoder with both BatchNorms folded into
the fused kernel (running statistics in eval; batch statistics in
training, BN1's from the input moments and BN2's from the ``mini_stats``
kernel), and the ViT trunk on the fused block kernels with DropPath as
per-sample branch scales, the last of which also emits the
``[LN(cls), max-pool]`` readout. ``train`` is an explicit argument, not
the module's mode: the frozen tower of prompt tuning still runs in
training mode. Module and parameter names mirror the flax tree so that
``ppt_torch.convert.from_jax`` maps every leaf one to one.

The position embedding is added before EVERY block (reference
``point_encoder.py:98-110``), inside the block kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ppt_torch.kernels.group import fused_group
from ppt_torch.kernels.mini import mini_forward, mini_stats
from ppt_torch.kernels.vitblock import fused_vit_block, fused_vit_block_readout
from ppt_torch.nn.layers import Dense, LayerNormF32, MlpBlock, drop_path_scales, gelu_tanh

BN_EPS = 1e-5  # flax nn.BatchNorm default
BN_MOMENTUM = 0.99  # flax nn.BatchNorm default: ra = 0.99 ra + 0.01 batch


@dataclasses.dataclass(frozen=True)
class PointBertConfig:
    trans_dim: int = 384
    depth: int = 12
    drop_path_rate: float = 0.1
    num_heads: int = 6
    group_size: int = 32
    num_group: int = 512
    encoder_dims: int = 256
    cls_dim: int = 50  # partseg part-label count


def group_points(
    xyz: torch.Tensor, num_group: int, group_size: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """FPS centers + kNN neighbourhoods, center-normalised:
    (neighbourhood [B, G, M, 3], center [B, G, 3])."""
    return fused_group(xyz, num_group, group_size)


class BatchNormStats(nn.Module):
    """BatchNorm parameters and running statistics (flax ``scale``/``bias``
    and ``batch_stats`` ``mean``/``var``), folded into the adjacent Dense
    weights: with the running statistics in eval, with the batch's in
    training, which also moves the running statistics as flax does."""

    def __init__(self, width: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))
        self.register_buffer("running_mean", torch.zeros(width))
        self.register_buffer("running_var", torch.ones(width))

    def fold(self, mean: Optional[torch.Tensor] = None,
             var: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(scale, shift) with BN(x) = x * scale + shift, from the given
        batch statistics or else the running ones."""
        if mean is None:
            mean, var = self.running_mean, self.running_var
        scale = self.weight / torch.sqrt(var + BN_EPS)
        return scale, self.bias - mean * scale

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """flax's update, in place: momentum 0.99 and the BIASED batch
        variance (torch's BatchNorm would use 0.1 and the unbiased one)."""
        self.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1.0 - BN_MOMENTUM)
        self.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1.0 - BN_MOMENTUM)


class MiniPointNet(nn.Module):
    """Per-group feature extractor (``Encoder``, dvae.py:184-215): both
    BNs folded, the whole chain in the ``mini_forward`` kernel
    (``nn/pointbert.py:143-214``). With ``train`` the fold uses batch
    statistics: BN1's come in closed form from the 3x3 input moments (it
    feeds on an affine map of the coordinates), BN2's from the
    ``mini_stats`` kernel; both variances are clamped at 0 in f32, and the
    running statistics are updated in place."""

    def __init__(self, out_dim: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1a = Dense(3, 128, dtype=dtype)
        self.bn1 = BatchNormStats(128)
        self.conv1b = Dense(128, 256, dtype=dtype)
        self.conv2a = Dense(512, 512, dtype=dtype)  # rows [0:256] global, [256:] local
        self.bn2 = BatchNormStats(512)
        self.conv2b = Dense(512, out_dim, dtype=dtype)

    def forward(self, groups: torch.Tensor, train: bool = False) -> torch.Tensor:
        B, G, M, C = groups.shape
        groups2 = groups.reshape(B, G * M, C).float()
        w1, b1 = self.conv1a.kernel, self.conv1a.bias
        w2, b2 = self.conv1b.kernel, self.conv1b.bias
        wsp, bsp = self.conv2a.kernel, self.conv2a.bias
        w3, b3 = self.conv2b.kernel, self.conv2b.bias
        cg = wsp.shape[0] - w2.shape[1]
        wg, wl = wsp[:cg], wsp[cg:]
        n = B * G * M
        mean1 = var1 = mean2 = var2 = None
        if train:
            z = groups2.reshape(-1, C)
            sz, szz = z.sum(0), z.t() @ z  # [3], [3, 3]
            szw = sz @ w1
            mean1 = szw / n + b1
            e2 = ((w1 * (szz @ w1)).sum(0) + 2.0 * b1 * szw + n * b1 * b1) / n
            # E[x^2] - E[x]^2 can round a hair negative for a near-constant channel
            var1 = torch.clamp_min(e2 - mean1 * mean1, 0.0)
        scale1, shift1 = self.bn1.fold(mean1, var1)
        fw1, fb1 = w1 * scale1[None, :], b1 * scale1 + shift1
        if train:
            sumh, sumsqh = mini_stats(M, self.dtype, groups2, fw1, fb1, w2, b2, wg, wl, bsp)
            mean2 = sumh / n
            var2 = torch.clamp_min(sumsqh / n - mean2 * mean2, 0.0)
        scale2, shift2 = self.bn2.fold(mean2, var2)
        out = mini_forward(
            M, self.dtype, groups2, fw1, fb1, w2, b2,
            wg * scale2[None, :], wl * scale2[None, :], bsp * scale2 + shift2, w3, b3,
        )
        if train:
            self.bn1.update_running(mean1, var1)
            self.bn2.update_running(mean2, var2)
        return out


class VitAttention(nn.Module):
    """timm-style attention parameters: fused qkv without bias, proj with
    bias (``point_encoder.py:33-58``)."""

    def __init__(self, width: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.qkv = Dense(width, 3 * width, bias=False, dtype=dtype)
        self.proj = Dense(width, width, dtype=dtype)


class VitBlock(nn.Module):
    """Pre-norm ViT block (``Block``, point_encoder.py:61-79) on the fused
    block kernel. ``dp`` is the per-sample droppath branch scale
    ``[B, 2]`` (all ones in eval, ``drop_path_scales`` in training)."""

    def __init__(self, width: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.norm1 = LayerNormF32(width, eps=1e-6)
        self.attn = VitAttention(width, dtype=dtype)
        self.norm2 = LayerNormF32(width, eps=1e-6)
        self.mlp = MlpBlock(width, int(width * mlp_ratio), dtype=dtype)

    def _weights(self):
        dt = self.dtype
        return (
            self.norm1.weight, self.norm1.bias,
            self.attn.qkv.kernel.to(dt), self.attn.proj.kernel.to(dt),
            self.attn.proj.bias,
            self.norm2.weight, self.norm2.bias,
            self.mlp.fc1.kernel.to(dt), self.mlp.fc1.bias,
            self.mlp.fc2.kernel.to(dt), self.mlp.fc2.bias,
        )

    def forward(
        self, x: torch.Tensor, pos: torch.Tensor, dp: torch.Tensor,
        readout_ln: Optional[LayerNormF32] = None,
    ) -> torch.Tensor:
        """[B, L, C] -> [B, L, C]; with ``readout_ln`` the block also runs
        the trunk's final LayerNorm and returns the [B, 2C] f32 feature."""
        if readout_ln is None:
            return fused_vit_block(x, pos.to(x.dtype), dp, *self._weights(), self.num_heads)
        ro = fused_vit_block_readout(
            x, pos.to(x.dtype), dp, *self._weights(), readout_ln.weight, readout_ln.bias,
            self.num_heads,
        )  # [B, 8, C] f32
        return torch.cat([ro[:, 0], ro[:, 1]], dim=-1)


class PointBert(nn.Module):
    """PointTransformer classification trunk -> [B, 2 * trans_dim] f32."""

    def __init__(self, config: PointBertConfig = PointBertConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.encoder = MiniPointNet(cfg.encoder_dims, dtype=dtype)
        self.reduce_dim = Dense(cfg.encoder_dims, cfg.trans_dim, dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.trans_dim))
        self.cls_pos = nn.Parameter(torch.zeros(1, 1, cfg.trans_dim))
        self.pos_embed1 = Dense(3, 128, dtype=dtype)
        self.pos_embed2 = Dense(128, cfg.trans_dim, dtype=dtype)
        for i in range(cfg.depth):
            self.add_module(f"block_{i}", VitBlock(cfg.trans_dim, cfg.num_heads, dtype=dtype))
        self.norm = LayerNormF32(cfg.trans_dim, eps=1e-6)

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.config.depth)]

    def forward(self, pts: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``train``: batch statistics in the group encoder's BatchNorms
        (and their running update) and DropPath drawn from ``generator``."""
        cfg = self.config
        dt = self.dtype
        neighborhood, center = group_points(pts, cfg.num_group, cfg.group_size)
        tokens = self.reduce_dim(self.encoder(neighborhood, train))
        B = tokens.shape[0]
        pos = self.pos_embed2(gelu_tanh(self.pos_embed1(center)))
        x = torch.cat([self.cls_token.to(dt).expand(B, 1, -1), tokens], dim=1)
        pos = torch.cat([self.cls_pos.to(dt).expand(B, 1, -1), pos], dim=1)
        rates = np.linspace(0.0, cfg.drop_path_rate, cfg.depth).tolist()
        dp = drop_path_scales(rates, B, train, generator, x.device)
        blocks = self.blocks()
        for i, blk in enumerate(blocks[:-1]):
            x = blk(x, pos, dp[i])
        return blocks[-1](x, pos, dp[-1], readout_ln=self.norm)
