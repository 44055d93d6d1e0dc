"""Point-cloud geometry ops: the plain PyTorch specification.

Counterpart of ``ppt_tpu/ops/geometry.py:28-298``. These are the
semantic ground truth for the grouping kernels in
``ppt_torch.kernels.group``; everything is batched ``[B, N, C]``,
channels-last, with fixed-size index outputs. ``sample_and_group`` is the
set-abstraction front end and goes through those kernels' wrappers.
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


def knn_point(nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor) -> torch.Tensor:
    """k nearest neighbours ``[B, S, nsample]`` int32, nearest first, over
    the expanded-form distance (the reference's CPU contract; the grouping
    kernel uses the exact-difference form instead)."""
    d = square_distance(new_xyz, xyz)
    return torch.topk(-d, nsample, dim=-1).indices.to(torch.int32)


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
