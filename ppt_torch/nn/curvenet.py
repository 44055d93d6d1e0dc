"""CurveNet encoder (classification), channels-last.

Counterpart of ``ppt_tpu/nn/curvenet.py``: a local point-feature
aggregation stem (``Lpfa``), eight curve-intervention blocks (``Cic``:
bottleneck, guided walks along curves with their aggregation back into the
points, local aggregation, residual), the max over points and an FC trunk
to the 256-d feature ULIP projects. Module and parameter names mirror the
flax tree (``lpfa0/mlp0``, ``cic0/walk/agent_kernel``,
``cic0/curveagg/convd_bn``, ``cic2/shortcut_bn``, ``fc1``/``fbn1``, ...),
so ``ppt_torch.convert.from_jax`` maps every leaf.

The traps:
- ``Walk`` keeps ``agent_kernel`` ``[2C, 1]`` and ``momentum_kernel``
  ``[2C, 2]`` as its own parameters, as flax names them; cast to the
  compute dtype, they multiply f32 features, so the products run in f32;
- the walk's noise: ``Walk`` takes the Gumbel uniforms ``[curve_length, B,
  curve_num, k]`` in ``[1e-20, 1)``. The reference draws them in eval from
  the fixed key ``PRNGKey(0)``, the same key in each of the four curve
  stages (``curvenet.py:252``), and in training from its ``gumbel`` rng
  stream. The port takes a caller's uniforms when given (the tests pass
  the reference's draws); else in eval it draws them from a generator
  seeded 0 on the tower's device, afresh in each curve stage, so eval is
  deterministic (not the reference's values: ``ROADMAP.md`` Queue 3); in
  training without them it refuses, as the reference's train step, which
  passes no ``gumbel`` stream, fails;
- the walk's start points are ``lax.top_k`` of the attention (its sigmoid
  as XLA expands it, ``_logistic``): a stable descending sort, ties to the
  lower index;
- ``CurveAggregation``'s BatchNorm always normalises with its running
  statistics, in training too, and never moves them;
- ``Cic``'s downsampling FPS runs on ``kernels/group.py:fps_batched`` (the
  kernel on the card: 1024 -> 256, 256 -> 64 and 64 -> 16 a batch); its
  ball query stays ``ops/geometry.py:query_ball_point`` and its kNN
  ``knn_point`` (the expanded-form distance), as the reference runs both
  as XLA.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ppt_torch.kernels import group as kgroup
from ppt_torch.nn.layers import BatchNorm, Dense, dropout, leaky_relu
from ppt_torch.ops import geometry as ops

EVAL_SEED = 0  # the eval draws' generator seed, every curve stage


def eval_uniforms(shape, device) -> torch.Tensor:
    """The eval draws of one curve stage: f32 uniforms in ``[1e-20, 1)``, as
    ``jax.random.uniform(key, shape, minval=1e-20, maxval=1.0)`` bounds them,
    from a generator seeded ``EVAL_SEED`` on ``device``, afresh each call."""
    gen = torch.Generator(device=device).manual_seed(EVAL_SEED)
    return torch.rand(shape, generator=gen, device=device).clamp_min(1e-20)


def gumbel_softmax(uniforms: torch.Tensor, logits: torch.Tensor,
                   temperature: float = 1.0) -> torch.Tensor:
    """``softmax((logits + g) / T)`` with ``g = -log(-log(u))``
    (``ppt_tpu/nn/curvenet.py:36-40``)."""
    g = -torch.log(-torch.log(uniforms))
    return torch.softmax((logits + g) / temperature, dim=-1)


def _matmul(t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``t @ w`` in the two operands' promoted dtype, as ``jnp`` takes it."""
    dt = torch.promote_types(t.dtype, w.dtype)
    return t.to(dt) @ w.to(dt)


def _logistic(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA expands it, ``1 / (1 + exp(-x))`` with each
    op rounded in ``x``'s dtype: in bf16 ``torch.sigmoid`` (rounded once)
    differs from it by one unit in a third of the values, and the walks'
    start points are a top-k over these values, whose ties one unit
    reorders."""
    return 1.0 / (1.0 + torch.exp(-x))


def _gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table [B, N, D]``, ``idx [B, S]`` -> ``[B, S, D]``."""
    return torch.gather(table, 1, idx[..., None].expand(-1, -1, table.shape[-1]))


class Walk(nn.Module):
    """Guided walks (``ppt_tpu/nn/curvenet.py:43-140``): from the start
    points, ``curve_length`` steps each pick a neighbour by a Gumbel softmax
    over an agent's logits, a 2-way momentum gate blending the running
    descriptor, and cosine crossover suppression; ``[B, curve_num,
    curve_length, C]``."""

    def __init__(self, k: int, curve_num: int, curve_length: int, channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.k, self.curve_num, self.curve_length = k, curve_num, curve_length
        self.dtype = dtype
        self.agent_kernel = nn.Parameter(torch.empty(2 * channels, 1))
        self.momentum_kernel = nn.Parameter(torch.empty(2 * channels, 2))

    def forward(self, feats: torch.Tensor, adj: torch.Tensor, start: torch.Tensor,
                uniforms: torch.Tensor) -> torch.Tensor:
        """``feats [B, N, C]``, ``adj [B, N, k]`` neighbour indices, ``start
        [B, curve_num]``, ``uniforms [curve_length, B, curve_num, k]``."""
        agent = self.agent_kernel.to(self.dtype)
        momentum = self.momentum_kernel.to(self.dtype)
        cur_idx = start.long()
        adj = adj.long()
        cur = pre = _gather_rows(feats, cur_idx)  # [B, cn, C]
        curves = []
        for step in range(self.curve_length):
            if step:  # the momentum gate between the current and the running descriptor
                att = torch.softmax(_matmul(torch.cat([cur, pre], -1), momentum).float(), -1)
                pre = att[..., 0:1] * cur + att[..., 1:2] * pre
            nbr_idx = _gather_rows(adj, cur_idx)  # [B, cn, k]
            nbr = ops.index_points(feats, nbr_idx)  # [B, cn, k, C]
            logits = _matmul(torch.cat([nbr, pre[:, :, None, :].expand_as(nbr)], -1),
                             agent)[..., 0].float()
            if step:  # crossover suppression: cosine(direction so far, step direction)
                move = (cur - pre).detach()
                steps_dir = (nbr - cur[:, :, None, :]).detach()
                dot = torch.einsum("bnc,bnkc->bnk", move, steps_dir)
                denom = torch.clamp_min(torch.sqrt((move * move).sum(-1))[..., None]
                                        * torch.sqrt((steps_dir * steps_dir).sum(-1)), 1e-8)
                logits = logits * torch.clamp(1.0 + dot / denom, 0.0, 1.0)
            pick = gumbel_softmax(uniforms[step], logits)  # [B, cn, k]
            cur = torch.einsum("bnk,bnkc->bnc", pick.to(nbr.dtype), nbr)
            cur_idx = torch.gather(nbr_idx, -1, pick.argmax(-1, keepdim=True))[..., 0]
            curves.append(cur)
        return torch.stack(curves, dim=2)


class CurveAggregation(nn.Module):
    """Inter/intra-curve attention readout (``ppt_tpu/nn/curvenet.py:
    143-175``); its BatchNorm always takes the running statistics."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = channels // 2
        self.line_conv_att = Dense(channels, 1, bias=False, dtype=dtype)
        self.conva = Dense(channels, mid, bias=False, dtype=dtype)
        self.convb = Dense(channels, mid, bias=False, dtype=dtype)
        self.convc = Dense(channels, mid, bias=False, dtype=dtype)
        self.convn = Dense(mid, mid, bias=False, dtype=dtype)
        self.convl = Dense(mid, mid, bias=False, dtype=dtype)
        self.convd = Dense(2 * mid, channels, bias=False, dtype=dtype)
        self.convd_bn = BatchNorm(channels)

    def forward(self, x: torch.Tensor, curves: torch.Tensor) -> torch.Tensor:
        # x [B, N, C]; curves [B, cn, cl, C]
        att = self.line_conv_att(curves)[..., 0]  # [B, cn, cl]
        inter = torch.einsum("bnlc,bnl->bnc", curves,
                             torch.softmax(att, dim=-1).to(curves.dtype))  # per curve
        intra = torch.einsum("bnlc,bnl->blc", curves,
                             torch.softmax(att, dim=1).to(curves.dtype))  # per position
        inter_a, intra_b, xq = self.conva(inter), self.convb(intra), self.convc(x)
        w_inter = torch.softmax(torch.bmm(xq, inter_a.transpose(1, 2)), dim=-1)
        w_intra = torch.softmax(torch.bmm(xq, intra_b.transpose(1, 2)), dim=-1)
        x_inter = torch.bmm(w_inter, self.convn(inter_a))
        x_intra = torch.bmm(w_intra, self.convl(intra_b))
        fused = self.convd_bn(self.convd(torch.cat([x_inter, x_intra], dim=-1)), False)
        return leaky_relu(x + fused, 0.2)


class Lpfa(nn.Module):
    """Local point-feature aggregation (``ppt_tpu/nn/curvenet.py:178-220``):
    ``[center, neighbour, neighbour - center]`` over kNN; the stem
    (``initial``) maxes its MLP over the neighbours, a block lifts the
    geometry to the features, adds the neighbours' offsets and averages."""

    def __init__(self, in_channels: int, out_channel: int, k: int, mlp_num: int = 2,
                 initial: bool = False, xyz_channels: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.k, self.mlp_num, self.initial, self.dtype = k, mlp_num, initial, dtype
        cin = 3 * xyz_channels
        if not initial:
            self.xyz2feature = Dense(cin, in_channels, bias=False, dtype=dtype)
            self.xyz2feature_bn = BatchNorm(in_channels)
            cin = in_channels
        for i in range(mlp_num):
            self.add_module(f"mlp{i}", Dense(cin, out_channel, bias=False, dtype=dtype))
            self.add_module(f"mlp_bn{i}", BatchNorm(out_channel))
            cin = out_channel

    def forward(self, feats: Optional[torch.Tensor], xyz: torch.Tensor,
                idx: Optional[torch.Tensor] = None, train: bool = False) -> torch.Tensor:
        if idx is None:
            idx = ops.knn_point(self.k, xyz, xyz)
        nbr_xyz = ops.index_points(xyz, idx)  # [B, N, k, 3]
        center = xyz[:, :, None, :].expand_as(nbr_xyz)
        geo = torch.cat([center, nbr_xyz, nbr_xyz - center], dim=-1).to(self.dtype)
        if self.initial:
            h = geo
        else:
            geo_f = self.xyz2feature_bn(self.xyz2feature(geo), train)
            h = leaky_relu(ops.index_points(feats, idx) - feats[:, :, None, :] + geo_f, 0.2)
        for i in range(self.mlp_num):
            h = leaky_relu(getattr(self, f"mlp_bn{i}")(getattr(self, f"mlp{i}")(h), train), 0.2)
        return h.amax(dim=2) if self.initial else h.mean(dim=2)


class Cic(nn.Module):
    """Curve intervention convolution (``ppt_tpu/nn/curvenet.py:223-286``):
    FPS + ball-query max pooling down to ``npoint`` when the cloud is
    larger, a bottleneck Dense, the curves (``curve_config``), ``Lpfa``, a
    Dense back up and the residual."""

    def __init__(self, in_channels: int, npoint: int, radius: float, k: int,
                 output_channels: int, bottleneck_ratio: int = 2, mlp_num: int = 2,
                 curve_config: Optional[Tuple[int, int]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.npoint, self.radius, self.k = npoint, radius, k
        self.curve_config = curve_config
        planes = in_channels // bottleneck_ratio
        self.conv1 = Dense(in_channels, planes, bias=False, dtype=dtype)
        self.bn1 = BatchNorm(planes)
        if curve_config is not None:
            self.start_att = Dense(planes, 1, bias=False, dtype=dtype)
            self.walk = Walk(k, curve_config[0], curve_config[1], planes, dtype=dtype)
            self.curveagg = CurveAggregation(planes, dtype=dtype)
        self.lpfa = Lpfa(planes, planes, k, mlp_num=mlp_num, dtype=dtype)
        self.conv2 = Dense(planes, output_channels, bias=False, dtype=dtype)
        self.bn2 = BatchNorm(output_channels)
        if in_channels != output_channels:
            self.shortcut = Dense(in_channels, output_channels, bias=False, dtype=dtype)
            self.shortcut_bn = BatchNorm(output_channels)

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor, train: bool = False,
                uniforms: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``uniforms [curve_length, B, curve_num, k]``: the walk's draws,
        which a block with curves requires."""
        if feats.shape[1] != self.npoint:  # FPS, then the max over each ball
            new_xyz = ops.index_points(xyz, kgroup.fps_batched(xyz, self.npoint))
            nbr = ops.query_ball_point(self.radius, self.k, xyz, new_xyz)
            feats = ops.index_points(feats, nbr).amax(dim=2)
            xyz = new_xyz
        shortcut = feats
        h = leaky_relu(self.bn1(self.conv1(feats), train), 0.2)
        idx = ops.knn_point(self.k + 1, xyz, xyz)
        if self.curve_config is not None:
            att = _logistic(self.start_att(h))[..., 0]  # [B, N]
            h = h * att[..., None]
            # lax.top_k: the largest first, ties to the lower index
            start = torch.sort(att, dim=-1, descending=True, stable=True).indices
            curves = self.walk(h, idx[:, :, 1:], start[:, :self.curve_config[0]], uniforms)
            h = self.curveagg(h, curves)
        h = self.lpfa(h, xyz, idx=idx[:, :, :self.k], train=train)
        h = self.bn2(self.conv2(h), train)
        if hasattr(self, "shortcut"):
            shortcut = self.shortcut_bn(self.shortcut(shortcut), train)
        return xyz, leaky_relu(h + shortcut, 0.2)


@dataclasses.dataclass(frozen=True)
class CurveNetConfig:
    k: int = 32
    # (npoint, radius, k, out, bottleneck, curve_config) per CIC block, the
    # reference's 'default' setting at 1024 input points
    stages: Tuple = (
        (1024, 0.2, 32, 64, 2, (100, 5)),
        (1024, 0.2, 32, 64, 4, (100, 5)),
        (256, 0.4, 32, 128, 2, (100, 5)),
        (256, 0.4, 32, 128, 4, (100, 5)),
        (64, 0.8, 32, 256, 2, None),
        (64, 0.8, 32, 256, 4, None),
        (16, 1.2, 15, 512, 2, None),
        (16, 1.2, 15, 512, 4, None),
    )


class CurveNet(nn.Module):
    """The CurveNet encoder -> ``[B, 256]`` f32
    (``ppt_tpu/nn/curvenet.py:306-317``)."""

    def __init__(self, config: CurveNetConfig = CurveNetConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.lpfa0 = Lpfa(0, 32, config.k, mlp_num=1, initial=True, dtype=dtype)
        cin = 32
        for i, (npoint, radius, k, out, ratio, curve) in enumerate(config.stages):
            self.add_module(f"cic{i}", Cic(cin, npoint, radius, k, out, bottleneck_ratio=ratio,
                                           curve_config=curve, dtype=dtype))
            cin = out
        self.fc1 = Dense(cin, 512, bias=False, dtype=dtype)
        self.fbn1 = BatchNorm(512)
        self.fc2 = Dense(512, 256, dtype=dtype)
        self.fbn2 = BatchNorm(256)

    def walk_shapes(self, batch: int) -> List[Tuple[int, int, int, int]]:
        """The uniforms' shape ``(curve_length, B, curve_num, k)`` of each
        curve stage, in order."""
        return [(curve[1], batch, curve[0], k)
                for _, _, k, _, _, curve in self.config.stages if curve is not None]

    def forward(self, xyz: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                uniforms: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """``generator``: the head's dropout stream; ``uniforms``: the walks'
        draws, one tensor a curve stage (``walk_shapes``); without them eval
        draws ``eval_uniforms`` and training refuses."""
        shapes = self.walk_shapes(xyz.shape[0])
        if uniforms is None:
            if train:
                raise ValueError(
                    "ULIP_CurveNet: the training forward draws its walks' Gumbel noise from a "
                    "'gumbel' random stream, and the train step passes none (the reference's "
                    "passes only 'dropout' and 'droppath', ppt_tpu/train/trainer.py:149, and "
                    "fails there too); CurveNet serves in eval only")
            uniforms = [eval_uniforms(s, xyz.device) for s in shapes]
        if len(uniforms) != len(shapes):
            raise ValueError(f"CurveNet: {len(uniforms)} uniform draws for {len(shapes)} "
                             "curve stages")
        draws = iter(uniforms)
        feats = self.lpfa0(None, xyz, train=train)
        p = xyz
        for i, stage in enumerate(self.config.stages):
            p, feats = getattr(self, f"cic{i}")(
                p, feats, train, uniforms=next(draws) if stage[5] is not None else None)
        x = feats.amax(dim=1)
        x = dropout(leaky_relu(self.fbn1(self.fc1(x), train), 0.2), 0.5, train, generator)
        return leaky_relu(self.fbn2(self.fc2(x), train), 0.2)
