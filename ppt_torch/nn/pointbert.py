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

``PointBertPartSeg`` is part segmentation's dense trunk (``nn/pointbert.py:
510-675``): the same grouping, encoder and blocks, LayerNorm taps after
blocks 3, 7 and 11, then 3-NN and EdgeConv propagation back to every point.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ppt_torch.kernels import group as kgroup
from ppt_torch.kernels.attention import FLASH_MIN_SEQ, flash_mha, fused_mha
from ppt_torch.kernels.group import fused_group
from ppt_torch.kernels.mini import mini_forward, mini_stats
from ppt_torch.kernels.vitblock import fused_vit_block, fused_vit_block_readout, fused_vit_tower
from ppt_torch.nn.layers import (BatchNorm, BatchNormStats, CastCache, Dense, GroupNorm,
                                 LayerNormF32, MlpBlock, drop_path, drop_path_scales, dropout,
                                 gelu_tanh, leaky_relu)
from ppt_torch.ops.geometry import index_points, knn_point, three_interpolate
from ppt_torch.parallel import collectives as _dp

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
    running statistics are updated in place. In a data-parallel step the
    moments and sums are the data group's (sync-BN)."""

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
            if _dp.active() is not None:  # sync-BN: the moments over the data group
                sz, szz, n = _dp.sync_sum(sz), _dp.sync_sum(szz), _dp.sync_count(n)
            szw = sz @ w1
            mean1 = szw / n + b1
            e2 = ((w1 * (szz @ w1)).sum(0) + 2.0 * b1 * szw + n * b1 * b1) / n
            # E[x^2] - E[x]^2 can round a hair negative for a near-constant channel
            var1 = torch.clamp_min(e2 - mean1 * mean1, 0.0)
        scale1, shift1 = self.bn1.fold(mean1, var1)
        fw1, fb1 = w1 * scale1[None, :], b1 * scale1 + shift1
        if train:
            sumh, sumsqh = mini_stats(M, self.dtype, groups2, fw1, fb1, w2, b2, wg, wl, bsp)
            if _dp.active() is not None:
                sumh, sumsqh = _dp.sync_sum(sumh), _dp.sync_sum(sumsqh)
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
        tp = getattr(self, "tp", None)
        if tp is not None:  # this rank's heads: qkv's columns of them, proj's rows
            from ppt_torch.parallel.sharding import column_parallel, row_parallel

            heads, C = tp.split(heads, "heads"), tp.split(C, "width")
            qkv = column_parallel(x, self.qkv, tp, fused3=True)
        else:
            qkv = self.qkv(x)
        q, k, v = (t.reshape(B, L, heads, C // heads) for t in qkv.split(C, dim=-1))
        if L >= FLASH_MIN_SEQ:
            out = flash_mha(q, k, v)
        elif fused:
            out = fused_mha(q, k, v)
        elif self.dtype == torch.bfloat16:
            out = bf16_score_attention(q, k, v)
        else:
            out = flash_mha(q, k, v)  # below FLASH_MIN_SEQ: the plain path
        if tp is not None:
            return row_parallel(out.reshape(B, L, C), self.proj, tp)
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

    def embed(self, pts: torch.Tensor, train: bool, generator: Optional[torch.Generator]):
        """Grouping, the group encoder, ``reduce_dim``, the cls token and the
        position embedding: (tokens x [B, 1 + G, C], pos [B, 1 + G, C],
        centres [B, G, 3], the DropPath ladder's rates, their branch scales
        [depth, B, 2], the route this trunk length takes)."""
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
        if getattr(self.block_0.attn, "tp", None) is not None:
            route = "unfused"  # the fused kernels take whole weights, not shards
        dp = drop_path_scales(rates, B, train, generator, x.device)
        return x, pos, center, rates, dp, route

    def forward(self, pts: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``train``: batch statistics in the group encoder's BatchNorms
        (and their running update) and DropPath drawn from ``generator``."""
        x, pos, _, rates, dp, route = self.embed(pts, train, generator)
        return self.trunk(x, pos, dp, rates, route, train)

    def trunk(self, x: torch.Tensor, pos: torch.Tensor, dp: torch.Tensor, rates, route: str,
              train: bool = False) -> torch.Tensor:
        """The blocks and the readout on ``route``, from ``embed``'s tokens,
        position embedding, branch scales and rates -> [B, 2 * trans_dim] f32."""
        cfg = self.config
        dt = self.dtype
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


# ---------------------------------------------------------------------------
# Part segmentation (``ppt_tpu/nn/pointbert.py:510-675``)
# ---------------------------------------------------------------------------


class FeaturePropagation(nn.Module):
    """3-NN inverse-distance upsampling, then ``Dense -> BatchNorm -> ReLU``
    per width (``PointNetFeaturePropagation``): the input is ``[points1,
    interp]`` in that order; the BatchNorms are flax's (f32, batch
    statistics over every row in training, momentum 0.99)."""

    def __init__(self, in_dim: int, mlp: Tuple[int, ...], dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth = len(mlp)
        for i, ch in enumerate(mlp):
            self.add_module(f"conv{i}", Dense(in_dim, ch, dtype=dtype))
            self.add_module(f"bn{i}", BatchNorm(ch))
            in_dim = ch

    def forward(self, xyz1: torch.Tensor, xyz2: torch.Tensor, points1: Optional[torch.Tensor],
                points2: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Targets xyz1 [B, N, 3], sources xyz2 [B, S, 3], target features
        points1 [B, N, D1] or None, source features points2 [B, S, D2] ->
        [B, N, mlp[-1]] f32."""
        x = three_interpolate(xyz1, xyz2, points2)
        if points1 is not None:
            x = torch.cat([points1, x], dim=-1)  # promotes as jnp's concat does
        for i in range(self.depth):
            x = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x), train))
        return x


class DgcnnPropagation(nn.Module):
    """Two EdgeConv rounds (``DGCNN_Propagation``): the k=4 nearest coarse
    points of each fine point by coordinates (no gradient through the
    index), edge feature ``[nbr - q, q]``, ``Dense`` without bias, flax's
    ``GroupNorm(4)`` in f32, leaky ReLU 0.2, max over k; the second round
    takes the fine set against itself."""

    def __init__(self, in_dim: int, k: int = 4, hidden_dim: int = 512, out_dim: int = 384,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.k = k
        self.layer1 = Dense(2 * in_dim, hidden_dim, bias=False, dtype=dtype)
        self.gn1 = GroupNorm(hidden_dim)
        self.layer2 = Dense(2 * hidden_dim, out_dim, bias=False, dtype=dtype)
        self.gn2 = GroupNorm(out_dim)

    def _edge(self, coor_q, x_q, coor_k, x_k) -> torch.Tensor:
        idx = knn_point(self.k, coor_k.detach(), coor_q.detach())  # [B, Nq, k]
        nbrs = index_points(x_k, idx)  # [B, Nq, k, D]
        q = x_q[:, :, None, :].expand_as(nbrs)
        return torch.cat([nbrs - q, q], dim=-1)

    def forward(self, coor: torch.Tensor, f: torch.Tensor, coor_q: torch.Tensor,
                f_q: torch.Tensor) -> torch.Tensor:
        """Coarse coor [B, G, 3] / f [B, G, D], fine coor_q [B, N, 3] / f_q
        [B, N, D] -> [B, N, out_dim] f32."""
        h = self.layer1(self._edge(coor_q, f_q, coor, f))
        h = leaky_relu(self.gn1(h), 0.2).amax(dim=2)
        h2 = self.layer2(self._edge(coor_q, h, coor_q, h))
        return leaky_relu(self.gn2(h2), 0.2).amax(dim=2)


PARTSEG_TAPS = (3, 7, 11)  # the blocks whose LayerNormed outputs feed the heads


class PointBertPartSeg(PointBert):
    """Dense per-point trunk (``PointTransformer_partseg``) -> [B, N, 128]
    f32: ``PointBert``'s grouping, encoder and 12 blocks, each of the blocks
    in ``PARTSEG_TAPS`` tapped through the one shared ``norm`` (f32,
    cls token dropped), FPS to 512 and 256 points on ``fps_batched``, then
    the propagations in the reference's order and ``conv1 -> bn1 -> ReLU ->
    Dropout(0.5)``. As in the reference, ``propagation_2`` and
    ``propagation_1`` take the sampled coordinates as their ``points1``
    features, and the level-0 features are ``[one-hot, pts]``.

    Routes: the taps need every block's tokens, so no readout is fused.
    "block" runs ``fused_vit_block`` twelve times; "unfused" and "plain" are
    ``PointBert``'s. The reference's partseg trunk never reads the tower
    switch (``nn/pointbert.py:630-638`` builds plain ``VitBlock``s), so
    "tower" runs as "block". From ``FLASH_MIN_SEQ`` tokens every route runs
    the unfused block with ``flash_mha``."""

    def __init__(self, config: PointBertConfig = PointBertConfig(), num_categories: int = 16,
                 dtype: torch.dtype = torch.float32, route: str = "block"):
        super().__init__(config, dtype=dtype, route=route)
        C = config.trans_dim
        self.num_categories = num_categories
        mlp = (4 * C, C)
        self.propagation_2 = FeaturePropagation(3 + C, mlp, dtype=dtype)
        self.propagation_1 = FeaturePropagation(3 + C, mlp, dtype=dtype)
        self.dgcnn_pro_2 = DgcnnPropagation(C, k=4, out_dim=C, dtype=dtype)
        self.dgcnn_pro_1 = DgcnnPropagation(C, k=4, out_dim=C, dtype=dtype)
        self.propagation_0 = FeaturePropagation(num_categories + 3 + C, mlp, dtype=dtype)
        self.conv1 = Dense(C, 128, dtype=dtype)
        self.bn1 = BatchNorm(128)

    def forward(self, pts: torch.Tensor, cls_onehot: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """pts [B, N, 3], cls_onehot [B, num_categories] -> [B, N, 128] f32.
        ``train``: batch statistics in every BatchNorm (and their running
        update), DropPath and the head's dropout drawn from ``generator``."""
        x, pos, center, rates, dp, route = self.embed(pts, train, generator)
        feats = []
        route = "block" if route == "tower" else route
        for i, blk in enumerate(self.blocks()):
            x = blk(x, pos, dp[i], route=route, rate=rates[i] if train else 0.0)
            if i in PARTSEG_TAPS:
                feats.append(self.norm(x.float())[:, 1:])  # [B, G, C] f32
        return self.head(pts, cls_onehot, center, feats, train, generator)

    def head(self, pts: torch.Tensor, cls_onehot: torch.Tensor, center: torch.Tensor,
             feats, train: bool = False,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The propagation head from the group centres [B, G, 3] and the three
        LayerNormed taps [B, G, C] f32 -> [B, N, 128] f32."""
        B, N, _ = pts.shape
        dt = self.dtype
        # hierarchical coordinates: N -> 512 -> 256 -> G
        xyz = pts.detach()
        xyz_512 = index_points(xyz, kgroup.fps_batched(xyz, 512))
        xyz_256 = index_points(xyz, kgroup.fps_batched(xyz, 256))
        onehot = cls_onehot[:, None, :].to(dt).expand(B, N, self.num_categories)
        f_level_0 = torch.cat([onehot, pts.to(dt)], dim=-1)

        f_256 = self.propagation_2(xyz_256, center, xyz_256, feats[1], train)
        f_512 = self.propagation_1(xyz_512, center, xyz_512, feats[0], train)
        f_256 = self.dgcnn_pro_2(center, feats[2], xyz_256, f_256)
        f_512 = self.dgcnn_pro_1(xyz_256, f_256, xyz_512, f_512)
        f_all = self.propagation_0(pts, xyz_512, f_level_0, f_512, train)
        h = torch.relu(self.bn1(self.conv1(f_all), train))
        return dropout(h, 0.5, train, generator)
