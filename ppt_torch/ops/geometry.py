"""Point-cloud geometry ops: the plain PyTorch specification.

Counterpart of ``ppt_tpu/ops/geometry.py:28-343``. These are the
semantic ground truth for the grouping kernels in
``ppt_torch.kernels.group``; everything is batched ``[B, N, C]``,
channels-last, with fixed-size index outputs. ``sample_and_group`` is the
set-abstraction front end and goes through those kernels' wrappers.
``three_nn`` / ``three_interpolate`` upsample part segmentation's
features; the TPU runs them as XLA, not as kernels, so they stay plain
here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distance ``[B, N, M]`` in the expanded form
    ``|s|^2 + |d|^2 - 2 s.d`` (may round slightly negative)."""
    src = src.float()
    dst = dst.float()
    cross = torch.bmm(src, dst.transpose(1, 2))
    s2 = (src * src).sum(-1)[:, :, None]
    d2 = (dst * dst).sum(-1)[:, None, :]
    return s2 + d2 - 2.0 * cross


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched gather: ``out[b, ..., :] = points[b, idx[b, ...], :]``."""
    B, C = points.shape[0], points.shape[-1]
    flat = idx.reshape(B, -1).long()
    out = torch.gather(points, 1, flat[:, :, None].expand(-1, -1, C))
    return out.reshape(*idx.shape, C)


def farthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Iterative FPS, ``[B, npoint]`` int32; starts at index 0 and takes
    the first argmax of the running min distance."""
    B, N, _ = xyz.shape
    xyz = xyz.float()
    far = torch.zeros(B, dtype=torch.long, device=xyz.device)
    dist = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    out = torch.empty(B, npoint, dtype=torch.int32, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    for i in range(npoint):
        out[:, i] = far.to(torch.int32)
        c = xyz[rows, far][:, None, :]
        d = xyz - c
        dist = torch.minimum(dist, (d * d).sum(-1))
        far = torch.argmax(dist, dim=-1)
    return out




def nearest_first(d: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest entries of each row of ``d`` and their indices,
    nearest first, a tie going to the lower index, as ``lax.top_k`` orders
    them (``torch.topk`` orders ties otherwise, and may keep another tied
    index at the k-th place): a stable sort of the whole row."""
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def knn_point(nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor) -> torch.Tensor:
    """k nearest neighbours ``[B, S, nsample]`` int32, nearest first, ties to
    the lower index, over the expanded-form distance (the reference's CPU
    contract; the grouping kernel uses the exact-difference form instead)."""
    return nearest_first(square_distance(new_xyz, xyz), nsample)[1].to(torch.int32)


def three_nn(unknown: torch.Tensor, known: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Three nearest ``known`` points of each ``unknown`` point: (squared
    distances [B, N, 3] in the expanded form, clamped at 0, nearest first;
    indices [B, N, 3] int32), ties to the lower index
    (``ppt_tpu/ops/geometry.py:301-314``)."""
    d, idx = nearest_first(square_distance(unknown, known), 3)
    return torch.clamp_min(d, 0.0), idx.to(torch.int32)


def three_interpolate(unknown_xyz: torch.Tensor, known_xyz: torch.Tensor,
                      known_feats: torch.Tensor) -> torch.Tensor:
    """Inverse-distance-weighted 3-NN interpolation ``[B, N, D]`` in
    ``known_feats``' dtype: weights ``1 / (d + 1e-8)`` normalised over the
    three (``ppt_tpu/ops/geometry.py:317-343``); a coincident point (d = 0)
    takes almost all the weight."""
    dists, idx = three_nn(unknown_xyz, known_xyz)
    recip = 1.0 / (dists + 1e-8)
    weight = recip / recip.sum(-1, keepdim=True)  # [B, N, 3]
    gathered = index_points(known_feats, idx)  # [B, N, 3, D]
    return (gathered * weight[..., None]).sum(2).to(known_feats.dtype)


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """:func:`index_points` for ``[B, S, K]`` neighbourhoods; its gradient
    (a scatter-add) is autograd's."""
    return index_points(points, idx)


def query_ball_point(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor) -> torch.Tensor:
    """The first ``nsample`` indices (ascending) within ``radius`` of each
    query, ``[B, S, nsample]`` int32, over the expanded-form distance (the
    reference's CPU contract; the ball-query kernels test the
    exact-difference form instead). Short rows are padded with the first
    hit; a query with no hit gives ``N - 1``."""
    N = xyz.shape[1]
    in_ball = square_distance(new_xyz, xyz) <= radius ** 2
    masked = torch.where(in_ball, torch.arange(N, device=xyz.device), N)
    group_idx = torch.sort(masked, dim=-1).values[..., :nsample]
    group_idx = torch.where(group_idx == N, group_idx[..., :1], group_idx)
    return torch.clamp_max(group_idx, N - 1).to(torch.int32)


def sample_and_group(
    npoint: int, radius: float, nsample: int, xyz: torch.Tensor,
    points: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """FPS + ball query + gather + centre-normalise, through the grouping
    kernels' wrappers: ``new_xyz [B, npoint, 3]`` and ``new_points
    [B, npoint, nsample, 3 + D]`` (relative coordinates first; ``[..., 3]``
    when ``points`` is None)."""
    from ppt_torch.kernels import group as kgroup  # it imports nothing of this module

    fps_idx = kgroup.fps_batched(xyz, npoint)
    new_xyz = index_points(xyz, fps_idx)
    if points is None:
        _, rel = kgroup.ball_query_gather(float(radius), nsample, xyz, new_xyz)
        return new_xyz, rel.to(xyz.dtype)
    _, rel, grouped = kgroup.ball_query_gather_feats(float(radius), nsample, xyz, new_xyz, points)
    return new_xyz, torch.cat([rel.to(xyz.dtype), grouped], dim=-1)  # promotes as jnp does


def sample_and_group_all(
    xyz: torch.Tensor, points: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One group holding the whole cloud: ``new_xyz [B, 1, C]`` zeros and
    ``new_points [B, 1, N, C + D]`` (absolute coordinates first)."""
    B, _, C = xyz.shape
    new_xyz = torch.zeros(B, 1, C, dtype=xyz.dtype, device=xyz.device)
    grouped = xyz[:, None]
    if points is not None:
        grouped = torch.cat([grouped, points[:, None]], dim=-1)
    return new_xyz, grouped
