"""PointBERT (PointTransformer) classification trunk, channels-last.

Counterpart of ``ppt_tpu/nn/pointbert.py``: grouping by the FPS + kNN
kernels, the MiniPointNet group encoder with both BatchNorms folded into
the fused kernel (running statistics in eval; batch statistics in
training, BN1's from the input moments and BN2's from the ``mini_stats``
kernel), and the ViT trunk with DropPath as per-sample branch scales on
one of the reference's four routes, chosen by ``PointBert(route=...)``
(``tasks/cls.py:point_route_from_env`` reads the reference's switches):

- "block" (the default): the fused block kernel per block, the last one
  also emitting the ``[LN(cls), max-pool]`` readout;
- "tower": the whole trunk and readout in one ``fused_vit_tower`` call;
- "unfused": LayerNorm, Dense, ``fused_mha`` and the MLP as modules;
- "plain": the unfused block with the reference's kernel-free attention
  (bf16 scores in bf16, ``nn/pointbert.py:269-276``; ``flash_mha``'s
  plain path in f32).

A trunk of ``FLASH_MIN_SEQ`` tokens or more takes the unfused block with
``flash_mha`` on every route, as the reference's length guard has it
(``nn/pointbert.py:269-278``, ``:328``, ``:448``). ``train`` is an
explicit argument, not the module's mode: the frozen tower of prompt
tuning still runs in training mode. Module and parameter names mirror the
flax tree so that ``ppt_torch.convert.from_jax`` maps every leaf one to
one.

The position embedding is added before EVERY block (reference
``point_encoder.py:98-110``), inside the block kernel on the fused routes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ppt_torch.kernels.attention import FLASH_MIN_SEQ, flash_mha, fused_mha
from ppt_torch.kernels.group import fused_group
from ppt_torch.kernels.mini import mini_forward, mini_stats
from ppt_torch.kernels.vitblock import fused_vit_block, fused_vit_block_readout, fused_vit_tower
from ppt_torch.nn.layers import (BatchNormStats, CastCache, Dense, LayerNormF32, MlpBlock,
                                 drop_path, drop_path_scales, gelu_tanh)

POINT_ROUTES = ("block", "tower", "unfused", "plain")


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


def bf16_score_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The reference's bf16 attention without kernels (``nn/pointbert.py:
    269-276``), [B, L, H, D]: both products in bf16 with f32 accumulation,
    as the bf16 einsums; scores stored in bf16, scaled by the bf16 scale,
    and the softmax taken op by op in bf16, as ``jax.nn.softmax`` runs it."""
    dt = q.dtype
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))  # [B, H, L, D]
    s = (qh @ kh.transpose(-1, -2)) * torch.tensor(1.0 / q.shape[-1] ** 0.5, dtype=dt)
    u = torch.exp(s - s.amax(-1, keepdim=True))
    p = u / u.sum(-1, keepdim=True)
    return (p @ vh).transpose(1, 2)


class VitAttention(nn.Module):
    """timm-style attention: fused qkv without bias, proj with bias
    (``point_encoder.py:33-58``), for the unfused block (``nn/pointbert.py:
    242-279``)."""

    def __init__(self, width: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.qkv = Dense(width, 3 * width, bias=False, dtype=dtype)
        self.proj = Dense(width, width, dtype=dtype)

    def forward(self, x: torch.Tensor, heads: int, fused: bool) -> torch.Tensor:
        """[B, L, C] -> [B, L, C]. q, k and v are views of the qkv product.
        From ``FLASH_MIN_SEQ`` tokens on ``flash_mha``; else ``fused_mha``
        with ``fused``, the reference's kernel-free attention without."""
        B, L, C = x.shape
        q, k, v = (t.reshape(B, L, heads, C // heads) for t in self.qkv(x).split(C, dim=-1))
        if L >= FLASH_MIN_SEQ:
            out = flash_mha(q, k, v)
        elif fused:
            out = fused_mha(q, k, v)
        elif self.dtype == torch.bfloat16:
            out = bf16_score_attention(q, k, v)
        else:
            out = flash_mha(q, k, v)  # below FLASH_MIN_SEQ: the plain path
        return self.proj(out.reshape(B, L, C))


class VitBlock(nn.Module):
    """Pre-norm ViT block (``Block``, point_encoder.py:61-79). ``dp`` is the
    per-sample droppath branch scale ``[B, 2]`` (all ones in eval,
    ``drop_path_scales`` in training); the unfused routes also take the
    block's DropPath ``rate`` (0 in eval)."""

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
        readout_ln: Optional[LayerNormF32] = None, route: str = "block", rate: float = 0.0,
    ) -> torch.Tensor:
        """[B, L, C] -> [B, L, C]; on the "block" route one fused block
        kernel, which with ``readout_ln`` also runs the trunk's final
        LayerNorm and returns the [B, 2C] f32 feature. The "unfused" and
        "plain" routes run the block as modules (``nn/pointbert.py:373-385``)
        with ``VitAttention``'s ``fused_mha`` or kernel-free attention."""
        if route != "block":
            return self._unfused(x, pos, dp, route == "unfused", rate)
        if readout_ln is None:
            return fused_vit_block(x, pos.to(x.dtype), dp, *self._weights(), self.num_heads)
        ro = fused_vit_block_readout(
            x, pos.to(x.dtype), dp, *self._weights(), readout_ln.weight, readout_ln.bias,
            self.num_heads,
        )  # [B, 8, C] f32
        return torch.cat([ro[:, 0], ro[:, 1]], dim=-1)

    def _unfused(self, x, pos, dp, fused_attn: bool, rate: float) -> torch.Tensor:
        """x + pos, LN1 (f32 statistics, output in the compute dtype),
        attention, DropPath, residual, LN2, MLP, DropPath, residual. DropPath
        is the reference module's (``drop_path``): the kept branch divided in
        the compute dtype by the rounded keep, the samples that ``dp`` drops
        zero, so every route sees the same draw."""
        dt = x.dtype
        x = x + pos.to(dt)
        h = self.attn(self.norm1(x), self.num_heads, fused_attn)
        x = x + drop_path(h, dp[:, 0], rate)
        h = self.mlp(self.norm2(x))
        return x + drop_path(h, dp[:, 1], rate)


class PointBert(nn.Module):
    """PointTransformer classification trunk -> [B, 2 * trans_dim] f32, on
    the trunk ``route`` (``POINT_ROUTES``)."""

    def __init__(self, config: PointBertConfig = PointBertConfig(),
                 dtype: torch.dtype = torch.float32, route: str = "block"):
        super().__init__()
        if route not in POINT_ROUTES:
            raise ValueError(f"PointBert route {route!r} not in {POINT_ROUTES}")
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.route = route
        self._cache = CastCache()
        self.encoder = MiniPointNet(cfg.encoder_dims, dtype=dtype)
        self.reduce_dim = Dense(cfg.encoder_dims, cfg.trans_dim, dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.trans_dim))
        self.cls_pos = nn.Parameter(torch.zeros(1, 1, cfg.trans_dim))
        self.pos_embed1 = Dense(3, 128, dtype=dtype)
        self.pos_embed2 = Dense(128, cfg.trans_dim, dtype=dtype)
        for i in range(cfg.depth):
            self.add_module(f"block_{i}", VitBlock(cfg.trans_dim, cfg.num_heads, dtype=dtype))
        self.norm = LayerNormF32(cfg.trans_dim, eps=1e-6)
        # the tower cache's sources, listed once: walking the modules costs
        # more host time per batch than the key itself (loading a state
        # dict and .to() keep these Parameter objects)
        self._block_params = [p for blk in self.blocks() for p in blk.parameters()]

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.config.depth)]

    def stacked_weights(self):
        """The blocks' 11 weights on a leading depth axis, the matrices in
        the compute dtype, as ``fused_vit_tower`` takes them; cast and
        stacked once until a source parameter changes."""
        blocks = self.blocks()

        def build():
            return [torch.stack(ws) for ws in zip(*(blk._weights() for blk in blocks))]

        return self._cache.get(self._block_params, self.dtype, build)

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
        route = self.route if x.shape[1] < FLASH_MIN_SEQ else "unfused"
        dp = drop_path_scales(rates, B, train, generator, x.device)
        if route == "tower":
            ro = fused_vit_tower(x, pos.to(dt), dp.transpose(0, 1), *self.stacked_weights(),
                                 self.norm.weight, self.norm.bias, cfg.num_heads)  # [B, 8, C] f32
            return torch.cat([ro[:, 0], ro[:, 1]], dim=-1)
        blocks = self.blocks()
        if route == "block":
            for i, blk in enumerate(blocks[:-1]):
                x = blk(x, pos, dp[i])
            return blocks[-1](x, pos, dp[-1], readout_ln=self.norm)
        for i, blk in enumerate(blocks):
            x = blk(x, pos, dp[i], route=route, rate=rates[i] if train else 0.0)
        xn = self.norm(x.float())
        return torch.cat([xn[:, 0], xn[:, 1:].amax(1)], dim=-1)
