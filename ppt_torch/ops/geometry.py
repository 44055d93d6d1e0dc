"""Point-cloud geometry ops: the plain PyTorch specification.

Counterpart of ``ppt_tpu/ops/geometry.py:28-183``. These are the
semantic ground truth for the grouping kernels in
``ppt_torch.kernels.group``; everything is batched ``[B, N, C]``,
channels-last, with fixed-size index outputs.
"""

from __future__ import annotations

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
