"""Stratified Transformer for scene segmentation, over packed clouds.

Counterpart of ``ppt_tpu/nn/stratified.py`` (openpoints'
``Stratified_transformer.py``): a KPConv stem, shifted-window attention
whose keys are STRATIFIED (every member of the query's own fine window,
plus the FPS-downsampled members of its 2x coarse window that lie in
another fine window), quantised relative-position bias tables, FPS
transitions between stages and an interpolating decoder. The reference's
fixed-capacity dense form is kept: a per-window member table
``[n_windows, cap]`` from one stable sort, one masked softmax over the
``fine_cap + coarse_cap`` keys of each query.

What differs from the reference, with the same values:

- the key tables depend only on a layer's points, window and shift, so
  they are built once per (layer, shift) and not in every block, and the
  downsampling FPS runs once per layer; the transition to the next layer
  samples the same count from the same points, so it takes that FPS's
  indices (``fps_batched``: four launches a forward at the default config,
  one on the ``[B, n, 3]`` view each);
- the relative-position bias is never gathered as the reference's
  ``[n, K, 3, h, hd, 3]`` table (about 2 GB a table a block at 8 x 4096
  points): for each axis a, ``q . T[:, :, :, a]`` is an ``[n, 2L, h]``
  projection per query point, and ``k . T[:, :, :, a]`` one per key point,
  each gathered at the quantised index. Only the order of summation
  changes;
- ``member_table`` writes no overflowing member: the reference sends every
  one to slot ``[nw - 1, cap - 1]`` and XLA applies those writes in order,
  so that slot loses its member exactly when window ``nw - 1`` itself
  holds more than ``cap`` points. That rule is applied explicitly here (a
  scatter with duplicate indices has no defined order on the card);
- the window hash wraps in ``uint32`` in the reference and is folded by a
  power of two that divides 2^32, so ``int64`` arithmetic and the same
  fold give the same ids, collisions included;
- the window and bias indices come from ``floor`` of f32 quotients, and
  the compiled reference divides by a constant as a product with the
  constant's f32 reciprocal (XLA's rewrite): the port multiplies by the
  same f32 reciprocal, so the CPU, the card and the reference pick the
  same index at a cell's edge.

DropPath drops per packed point (``ppt_tpu/nn/layers.py:85`` draws a mask
of shape ``(n, 1)``). ``window_overflow`` (the most points any window held
past its cap, max over the blocks: the reference's
``diagnostics/window_overflow``) is an attribute set by every forward,
a 0-dim tensor, outside the ``state_dict``. The KPConv kernel points are
the reference's own stated stand-in (centre + Fibonacci sphere,
``ppt_tpu/nn/stratified.py:31-34``). Module and parameter names mirror the
flax tree (``stem_0/kpconv/weights``, ``layer1_blk0/attn/
relative_pos_query_table``, ``down1/norm``, ``up0/linear1``, ``head_bn``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ppt_torch.nn.layers import BatchNorm, Dense, LayerNormF32, drop_path, gelu_tanh, leaky_relu
from ppt_torch.ops import ragged

BN_MOMENTUM = 0.98  # the KPConv blocks' BatchNorms (flax's convention: ra = m ra + (1 - m) b)
LN_EPS = 1e-6  # flax nn.LayerNorm


def _offsets(B: int, n: int) -> Tuple[int, ...]:
    return tuple(n * (i + 1) for i in range(B))


def _div(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` as the compiled reference takes it: ``x`` times the f32
    reciprocal of ``s`` (a Python float that f32 holds exactly), on every
    device."""
    return x * float(np.float32(1.0) / np.float32(s))


# ---------------------------------------------------------------------------
# window bookkeeping
# ---------------------------------------------------------------------------


def window_ids(xyz: torch.Tensor, seg: torch.Tensor, size: float, shift: bool,
               n_windows_cap: int) -> torch.Tensor:
    """Voxel-window id of every point ``[n]`` int64 (``grid_sample``): the
    cell of ``(xyz - min over all points [+ size / 2 when shifted]) / size``
    and the cloud id, hashed and folded into ``[0, n_windows_cap)``."""
    p = xyz.float() - xyz.float().amin(0)
    if shift:
        p = p + 0.5 * size
    cell = torch.floor(_div(p, size)).long()
    h = (cell[:, 0] * 73856093 + cell[:, 1] * 19349663 + cell[:, 2] * 83492791
         + seg.long() * 2654435761)
    return h % n_windows_cap


def member_table(win: torch.Tensor, n_windows: int, cap: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[n] window ids -> (members ``[n_windows, cap]`` point indices, n where
    empty; valid). Ranks follow point order; members past ``cap`` are
    dropped, and so is the member at rank ``cap - 1`` of window
    ``n_windows - 1`` when that window overflows (the reference's write
    order, see the module's note). No value is read back to the host."""
    n = win.shape[0]
    dev = win.device
    order = torch.argsort(win, stable=True)
    sorted_win = win[order]
    idx = torch.arange(n, device=dev)
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = sorted_win[1:] != sorted_win[:-1]
    run_start = torch.cummax(torch.where(first, idx, 0), 0).values
    rank = idx - run_start
    ok = rank < cap
    # the overflowing members go to a spare row, dropped after the write
    members = torch.full((n_windows + 1, cap), n, dtype=torch.long, device=dev)
    members[torch.where(ok, sorted_win, n_windows), torch.where(ok, rank, 0)] = order
    members = members[:n_windows]
    last_full = (sorted_win == n_windows - 1).sum() > cap
    members[-1, -1] = torch.where(last_full, n, members[-1, -1])
    return members, members < n


def _population_max(win: torch.Tensor, n_windows: int) -> torch.Tensor:
    counts = torch.zeros(n_windows, dtype=torch.long, device=win.device)
    return counts.index_add_(0, win, torch.ones_like(win)).amax()


def downsample_flags(xyz: torch.Tensor, offsets, ds_npoint: int) -> Tuple[torch.Tensor,
                                                                          torch.Tensor]:
    """(the per-cloud FPS indices ``[B, ds_npoint]``, ``[n + 1]`` flags of the
    sampled points; the last entry, for the padding index n, is False)."""
    n = xyz.shape[0]
    ds_idx = ragged.farthest_point_sample_packed(xyz, offsets, ds_npoint)
    is_ds = torch.zeros(n + 1, dtype=torch.bool, device=xyz.device)
    is_ds[ds_idx.reshape(-1).long()] = True
    return ds_idx, is_ds


def layer_keys(xyz: torch.Tensor, seg: torch.Tensor, window: float, shift: bool,
               fine_cap: int, coarse_cap: int, is_ds: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every query's keys from the downsample flags ``is_ds``: see
    ``stratified_keys``."""
    n = xyz.shape[0]
    nw = int(2 ** np.ceil(np.log2(max(2, n))))  # hash capacity
    fine = window_ids(xyz, seg, window, shift, nw)
    coarse = window_ids(xyz, seg, 2 * window, shift, nw)
    fm, fv = member_table(fine, nw, fine_cap)
    cm, cv = member_table(coarse, nw, coarse_cap)
    overflow = torch.clamp_min(torch.maximum(_population_max(fine, nw) - fine_cap,
                                             _population_max(coarse, nw) - coarse_cap), 0)
    k1 = fm[fine]
    v1 = fv[fine] & (k1 < n)
    k2 = cm[coarse]
    v2 = (cv[coarse] & (k2 < n) & is_ds[k2.clamp_max(n)]
          & (fine[k2.clamp_max(n - 1)] != fine[:, None]))
    return torch.cat([k1, k2], 1), torch.cat([v1, v2], 1), overflow


def stratified_keys(xyz: torch.Tensor, seg: torch.Tensor, offsets, window: float, shift: bool,
                    fine_cap: int, coarse_cap: int, ds_npoint: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each query's key set (``get_indice_pairs``): its fine window's members
    and the downsampled (per-cloud FPS to ``ds_npoint``) members of its
    coarse window that lie in another fine window. Returns (keys_idx
    ``[n, fine_cap + coarse_cap]``, n where padded; valid; overflow, a 0-dim
    tensor: the most points any window held past its cap)."""
    _, is_ds = downsample_flags(xyz, offsets, ds_npoint)
    return layer_keys(xyz, seg, window, shift, fine_cap, coarse_cap, is_ds)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def table_size(window_size: float, quant_size: float) -> int:
    """L: the tables hold 2L quantised offsets a axis."""
    return int((2 * window_size + 1e-4) // quant_size)


def relative_index(xyz: torch.Tensor, safe: torch.Tensor, window_size: float,
                   quant_size: float) -> torch.Tensor:
    """The quantised offset of every (query, key) pair on each axis,
    ``[n, K, 3]`` int64 in ``[0, 2L)``: the offset rounded to 1e-5, then
    ``floor((rel + 2 w - 1e-4) / quant)``, op by op in f32."""
    rel = xyz[:, None, :] - xyz[safe]
    rel = _div(torch.round(rel * 100000), 100000.0)
    ridx = torch.floor(_div(rel + 2 * window_size - 0.0001, quant_size)).long()
    return ridx.clamp(0, 2 * table_size(window_size, quant_size) - 1)


def _table_bias(t: torch.Tensor, table: torch.Tensor, rows: torch.Tensor,
                ridx: torch.Tensor) -> torch.Tensor:
    """``sum_a t[rows] . table[ridx[..., a], :, :, a]`` as ``[n, h, K]``: the
    projections ``t . table[:, :, :, a]`` (``[m, 2L, 3, h]``, one row of 2L
    per point of ``t``) gathered at ``(rows, ridx[..., a], a)``."""
    m, h = t.shape[0], t.shape[1]
    two_l = table.shape[0]
    proj = torch.einsum("mhd,lhda->mlah", t, table).reshape(m * two_l * 3, h)
    axes = torch.arange(3, device=t.device)
    flat = (rows[..., None] * two_l + ridx) * 3 + axes  # [n, K, 3]
    return proj[flat].sum(2).permute(0, 2, 1)


class StratifiedWindowAttention(nn.Module):
    """WindowAttention (``ppt_tpu/nn/stratified.py:119-198``) over each
    query's fixed-capacity key set."""

    def __init__(self, dim: int, num_heads: int, window_size: float, quant_size: float,
                 rel_query: bool = True, rel_key: bool = True, qkv_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.window_size, self.quant_size = window_size, quant_size
        self.dtype = dtype
        hd = dim // num_heads
        shape = (2 * table_size(window_size, quant_size), num_heads, hd, 3)
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias, dtype=dtype)
        self.relative_pos_query_table = nn.Parameter(torch.zeros(shape)) if rel_query else None
        self.relative_pos_key_table = nn.Parameter(torch.zeros(shape)) if rel_key else None
        self.proj = Dense(dim, dim, dtype=dtype)

    def forward(self, feats: torch.Tensor, xyz: torch.Tensor, keys_idx: torch.Tensor,
                keys_valid: torch.Tensor) -> torch.Tensor:
        """feats [n, C], xyz [n, 3] f32, keys_idx/keys_valid [n, K] -> [n, C]."""
        n, C = feats.shape
        h, dt = self.num_heads, self.dtype
        hd = C // h
        qkv = self.qkv(feats).reshape(n, 3, h, hd)
        q = qkv[:, 0] * (hd ** -0.5)
        k, v = qkv[:, 1], qkv[:, 2]
        rows = torch.arange(n, device=feats.device)[:, None].expand_as(keys_idx)
        # a padded key reads its query's own row: masked all the same (the
        # reference reads row n - 1), and one row repeated across most of
        # the padding would make the gathers' backward serial on the card
        safe = torch.where(keys_idx < n, keys_idx.long(), rows)
        logits = torch.einsum("nhd,nkhd->nhk", q, k[safe])
        ridx = relative_index(xyz, safe, self.window_size, self.quant_size)
        if self.relative_pos_query_table is not None:
            logits = logits + _table_bias(q, self.relative_pos_query_table.to(dt), rows, ridx)
        if self.relative_pos_key_table is not None:
            logits = logits + _table_bias(k, self.relative_pos_key_table.to(dt), safe, ridx)
        valid = keys_valid[:, None, :]
        logits = torch.where(valid, logits.float(), float("-inf"))
        attn = torch.where(valid, torch.softmax(logits, -1), 0.0).to(dt)
        out = torch.einsum("nhk,nkhd->nhd", attn, v[safe]).reshape(n, C)
        return self.proj(out)


def _drop_path(h: torch.Tensor, rate: float, train: bool,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """The reference's DropPath on ``[n, C]``: one draw per packed point."""
    if not train or rate == 0.0:
        return h
    keep = torch.rand(h.shape[0], generator=generator, device=h.device) < 1.0 - rate
    return drop_path(h, keep.float(), rate)


class StratifiedBlock(nn.Module):
    """SwinTransformerBlock (``:201-227``): pre-LN attention and tanh-GELU
    MLP, each residual behind DropPath; the LayerNorms f32 (eps 1e-6)."""

    def __init__(self, dim: int, num_heads: int, window_size: float, quant_size: float,
                 drop_path: float = 0.0, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.drop_path = drop_path
        self.dtype = dtype
        self.norm1 = LayerNormF32(dim, eps=LN_EPS)
        self.attn = StratifiedWindowAttention(dim, num_heads, window_size, quant_size,
                                              dtype=dtype)
        self.norm2 = LayerNormF32(dim, eps=LN_EPS)
        self.fc1 = Dense(dim, int(dim * mlp_ratio), dtype=dtype)
        self.fc2 = Dense(int(dim * mlp_ratio), dim, dtype=dtype)

    def forward(self, feats, xyz, keys_idx, keys_valid, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.attn(self.norm1(feats).to(self.dtype), xyz, keys_idx, keys_valid)
        feats = feats + _drop_path(h, self.drop_path, train, generator)
        h = self.fc2(gelu_tanh(self.fc1(self.norm2(feats))))
        return feats + _drop_path(h, self.drop_path, train, generator)


# ---------------------------------------------------------------------------
# KPConv stem
# ---------------------------------------------------------------------------


def kernel_dispositions(num_points: int = 15) -> np.ndarray:
    """Kernel-point layout ``[num_points, 3]`` f32: the centre, then a
    Fibonacci sphere (the reference's stand-in for torch_points3d's
    optimised dispositions)."""
    m = num_points - 1
    i = np.arange(m)
    phi = np.pi * (3.0 - np.sqrt(5.0))
    y = 1 - 2 * (i + 0.5) / m
    r = np.sqrt(np.maximum(0.0, 1 - y * y))
    pts = np.stack([r * np.cos(phi * i), y, r * np.sin(phi * i)], axis=1)
    return np.concatenate([np.zeros((1, 3)), pts], axis=0).astype(np.float32)


class KPConv(nn.Module):
    """Kernel-point convolution, linear influence
    ``max(0, 1 - |rel - kp extent| / extent)`` over valid neighbours."""

    def __init__(self, in_channels: int, out_channels: int, extent: float,
                 num_kpoints: int = 15, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.extent = extent
        self.dtype = dtype
        self.weights = nn.Parameter(torch.zeros(num_kpoints, in_channels, out_channels))
        self._kp = torch.from_numpy(kernel_dispositions(num_kpoints) * extent)

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor, nbr_idx: torch.Tensor,
                nbr_valid: torch.Tensor) -> torch.Tensor:
        """xyz [n, 3], feats [n, C], neighbours [n, M] -> [n, out]."""
        n = feats.shape[0]
        dt = self.dtype
        safe = nbr_idx.long().clamp_max(n - 1)
        if self._kp.device != xyz.device:  # the layout, copied to the device once
            self._kp = self._kp.to(xyz.device)
        rel = xyz[safe] - xyz[:, None, :]  # [n, M, 3]
        diff = rel[:, :, None, :] - self._kp
        d = torch.sqrt((diff * diff).sum(-1))  # [n, M, K]
        infl = torch.clamp_min(1.0 - d / self.extent, 0.0)
        infl = torch.where(nbr_valid[:, :, None], infl, 0.0).to(dt)
        agg = torch.einsum("nmk,nmc->nkc", infl, feats[safe].to(dt))
        return torch.einsum("nkc,kco->no", agg, self.weights.to(dt))


class KPConvSimpleBlock(nn.Module):
    """KPConv + BatchNorm (momentum 0.98) + LeakyReLU 0.2 (``:240-254``)."""

    def __init__(self, in_channels: int, out_channels: int, extent: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kpconv = KPConv(in_channels, out_channels, extent, dtype=dtype)
        self.bn = BatchNorm(out_channels, momentum=BN_MOMENTUM)

    def forward(self, xyz, feats, nbr_idx, nbr_valid, train: bool = False) -> torch.Tensor:
        return leaky_relu(self.bn(self.kpconv(xyz, feats, nbr_idx, nbr_valid), train), 0.2)


class KPConvResBlock(nn.Module):
    """Bottleneck KPConv residual block (``:257-290``)."""

    def __init__(self, in_channels: int, out_channels: int, extent: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d2 = out_channels // 4
        self.unary_1_lin = Dense(in_channels, d2, bias=False, dtype=dtype)
        self.unary_1_bn = BatchNorm(d2, momentum=BN_MOMENTUM)
        self.kpconv = KPConv(d2, d2, extent, dtype=dtype)
        self.unary_2_lin = Dense(d2, out_channels, bias=False, dtype=dtype)
        self.unary_2_bn = BatchNorm(out_channels, momentum=BN_MOMENTUM)
        if in_channels != out_channels:
            self.shortcut_lin = Dense(in_channels, out_channels, bias=False, dtype=dtype)
            self.shortcut_bn = BatchNorm(out_channels, momentum=BN_MOMENTUM)
        else:
            self.shortcut_lin = self.shortcut_bn = None

    def forward(self, xyz, feats, nbr_idx, nbr_valid, train: bool = False) -> torch.Tensor:
        h = leaky_relu(self.unary_1_bn(self.unary_1_lin(feats), train), 0.2)
        h = self.kpconv(xyz, h, nbr_idx, nbr_valid)
        h = leaky_relu(self.unary_2_bn(self.unary_2_lin(h), train), 0.2)
        sc = feats if self.shortcut_lin is None else self.shortcut_bn(self.shortcut_lin(feats),
                                                                      train)
        return h + sc


# ---------------------------------------------------------------------------
# transitions
# ---------------------------------------------------------------------------


class TransitionDown(nn.Module):
    """(``:340-361``) the sampled points' k nearest, LayerNorm, Linear and
    the max over the neighbours; the FPS indices come from the caller."""

    def __init__(self, in_channels: int, out_channels: int, k: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.k = k
        self.norm = LayerNormF32(in_channels, eps=LN_EPS)
        self.linear = Dense(in_channels, out_channels, bias=False, dtype=dtype)

    def forward(self, feats, xyz, offsets, idx: torch.Tensor):
        """idx: ``[B, npoint]`` packed FPS indices -> (features, xyz, offsets)
        of the sampled points."""
        B, npoint = idx.shape
        new_xyz = xyz[idx.reshape(-1).long()]
        new_off = _offsets(B, npoint)
        nbr, _ = ragged.knn_query_packed(self.k, xyz, offsets, new_xyz, new_off)
        h = self.linear(self.norm(feats[nbr.long()]))
        return h.amax(1), new_xyz, new_off


class Upsample(nn.Module):
    """(``:364-383``) ``linear1(LN(skip)) + interp(linear2(LN(coarse)))``."""

    def __init__(self, skip_channels: int, in_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNormF32(skip_channels, eps=LN_EPS)
        self.linear1 = Dense(skip_channels, skip_channels, dtype=dtype)
        self.norm2 = LayerNormF32(in_channels, eps=LN_EPS)
        self.linear2 = Dense(in_channels, skip_channels, dtype=dtype)

    def forward(self, feats, xyz, offsets, skip_feats, skip_xyz, skip_off) -> torch.Tensor:
        a = self.linear1(self.norm1(skip_feats))
        b = self.linear2(self.norm2(feats))
        return a + ragged.interpolation_packed(xyz, offsets, skip_xyz, skip_off, b)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@torch.no_grad()
def init_leaves_(module: nn.Module, gen: torch.Generator) -> None:
    """The leaves no Dense holds, under ``module``, drawn from ``gen`` on the
    CPU: each KPConv's ``weights`` lecun-normal (fan-in kernel points x in
    channels), the relative-position tables N(0, 0.02), as the reference
    initialises them."""
    for mod in module.modules():
        if isinstance(mod, KPConv):
            K, C, _ = mod.weights.shape
            mod.weights.copy_(torch.randn(mod.weights.shape, generator=gen) / math.sqrt(K * C))
        elif isinstance(mod, StratifiedWindowAttention):
            for t in (mod.relative_pos_query_table, mod.relative_pos_key_table):
                if t is not None:
                    t.copy_(0.02 * torch.randn(t.shape, generator=gen))


@dataclasses.dataclass(frozen=True)
class StratifiedConfig:
    """Encoder hyper-parameters (StratifiedEncoder.__init__)."""

    depths: Tuple[int, ...] = (2, 2, 6, 2)
    channels: Tuple[int, ...] = (48, 96, 192, 384)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: float = 4.0  # multiplier over patch size
    patch_size: float = 4.0  # multiplier over grid size
    grid_size: float = 0.04
    quant_size: float = 0.01
    downsample_scale: int = 4
    drop_path_rate: float = 0.2
    in_channels: int = 3  # read nowhere, as in the reference: see feat_channels
    num_classes: int = 13
    k: int = 16
    sigma: float = 1.0
    stem_transformer: bool = False
    fine_cap: int = 48
    coarse_cap: int = 24
    stem_radius_mult: float = 2.5


class StratifiedSeg(nn.Module):
    """Encoder, decoder and head over equal-size clouds: ``forward(pts
    [B, N, 3], feats [B, N, feat_channels] | None)`` -> ``[B, N, classes]``
    (the coordinates are the features when there are none). The offsets
    are Python ints, so nothing is read back from the card."""

    def __init__(self, config: StratifiedConfig = StratifiedConfig(), feat_channels: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        self.window_overflow: Optional[torch.Tensor] = None
        L = len(cfg.depths)
        ch = cfg.channels
        extent = cfg.grid_size * cfg.sigma
        windows, quants = self._windows()
        self.stem_0 = KPConvSimpleBlock(feat_channels, ch[0], extent, dtype=dtype)
        skip_ch = []
        if not cfg.stem_transformer:
            self.stem_1 = KPConvResBlock(ch[0], ch[0], extent, dtype=dtype)
            self.stem_down = TransitionDown(ch[0], ch[1], cfg.k, dtype=dtype)
            skip_ch.append(ch[0])
        dpr = np.linspace(0, cfg.drop_path_rate, sum(cfg.depths))
        blk_id = 0
        for li in range(self.layer_start, L):
            for d in range(cfg.depths[li]):
                self.add_module(f"layer{li}_blk{d}", StratifiedBlock(
                    ch[li], cfg.num_heads[li], windows[li], quants[li],
                    drop_path=float(dpr[blk_id]), dtype=dtype))
                blk_id += 1
            skip_ch.append(ch[li])
            if li < L - 1:
                self.add_module(f"down{li}", TransitionDown(ch[li], ch[li + 1], cfg.k,
                                                            dtype=dtype))
        coarse = skip_ch.pop()
        for ui in range(len(skip_ch)):
            skip = skip_ch.pop()
            self.add_module(f"up{ui}", Upsample(skip, coarse, dtype=dtype))
            coarse = skip
        self.head_fc1 = Dense(ch[0], ch[0], dtype=dtype)
        self.head_bn = BatchNorm(ch[0])
        self.head_fc2 = Dense(ch[0], cfg.num_classes, dtype=dtype)

    @property
    def layer_start(self) -> int:
        return 0 if self.config.stem_transformer else 1

    def _windows(self) -> Tuple[List[float], List[float]]:
        cfg = self.config
        patch = cfg.grid_size * cfg.patch_size
        L = len(cfg.depths)
        return ([patch * cfg.window_size * (2 ** i) for i in range(L)],
                [cfg.quant_size * (2 ** i) for i in range(L)])

    def init_leaves_(self, gen: torch.Generator) -> None:
        init_leaves_(self, gen)

    def forward(self, pts: torch.Tensor, feats: Optional[torch.Tensor] = None,
                train: bool = False, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """``train``: batch statistics in the BatchNorms (their running
        statistics move) and DropPath drawn from ``generator``."""
        cfg = self.config
        B, N, _ = pts.shape
        L = len(cfg.depths)
        dev = pts.device
        windows, _ = self._windows()
        p = pts.reshape(B * N, 3).float()
        x = (feats if feats is not None else pts).reshape(B * N, -1).to(self.dtype)
        offsets = _offsets(B, N)

        radius = cfg.stem_radius_mult * cfg.grid_size * cfg.sigma
        nbr, d2 = ragged.knn_query_packed(cfg.k, p, offsets, p, offsets)
        nbr_valid = d2 <= radius * radius
        x = self.stem_0(p, x, nbr, nbr_valid, train)
        skips = []
        count = N
        if not cfg.stem_transformer:
            x = self.stem_1(p, x, nbr, nbr_valid, train)
            skips.append((x, p, offsets))
            count = N // cfg.downsample_scale
            idx = ragged.farthest_point_sample_packed(p, offsets, count)
            x, p, offsets = self.stem_down(x, p, offsets, idx)

        overflow = torch.zeros((), dtype=torch.long, device=dev)
        for li in range(self.layer_start, L):
            seg = torch.arange(B * count, device=dev) // count
            ds_idx, is_ds = downsample_flags(p, offsets, max(1, count // cfg.downsample_scale))
            keys = {}
            for d in range(cfg.depths[li]):
                shift = d % 2 == 1
                if shift not in keys:
                    keys[shift] = layer_keys(p, seg, windows[li], shift, cfg.fine_cap,
                                             cfg.coarse_cap, is_ds)
                    overflow = torch.maximum(overflow, keys[shift][2])
                x = getattr(self, f"layer{li}_blk{d}")(x, p, *keys[shift][:2], train, generator)
            skips.append((x, p, offsets))
            if li < L - 1:
                # the next layer's count is this layer's downsampling count:
                # the transition samples with the same FPS
                count = count // cfg.downsample_scale
                x, p, offsets = getattr(self, f"down{li}")(x, p, offsets, ds_idx)
        self.window_overflow = overflow

        x, p, offsets = skips.pop()
        for ui in range(len(skips)):
            sk_x, sk_p, sk_o = skips.pop()
            x = getattr(self, f"up{ui}")(x, p, offsets, sk_x, sk_p, sk_o)
            p, offsets = sk_p, sk_o
        h = torch.relu(self.head_bn(self.head_fc1(x), train))
        return self.head_fc2(h).reshape(B, N, cfg.num_classes)
