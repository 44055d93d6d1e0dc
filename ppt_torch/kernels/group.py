"""Grouping kernels: batched FPS and kNN with the neighbourhood gather.

Replaces ``ppt_tpu/kernels/group.py:fps_batched`` and ``:knn_gather``
(chained by ``:fused_group``). The CUDA side is ``csrc/group.cu``, whose
header says what bounds each kernel on the H100 and how its design
answers that.

Contracts (exact, ties included):
- FPS starts at index 0, keeps a running min distance initialised to
  1e10 and takes the FIRST argmax;
- kNN extracts the k smallest exact-difference distances
  ``((qx-x)^2 + (qy-y)^2) + (qz-z)^2``, ties to the lowest index, nearest
  first. This is the kernel contract the reference runs on its chip
  (``group.py:194``), not the expanded-form ``ops.knn_point``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ppt_torch.kernels import _build

_SMEM_LIMIT = 227 * 1024


def _sq3(dx: torch.Tensor, dy: torch.Tensor, dz: torch.Tensor) -> torch.Tensor:
    # ((dx*dx + dy*dy) + dz*dz), each op rounded separately
    return (dx * dx + dy * dy) + dz * dz


def fps_plain(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Plain PyTorch FPS, [B, npoint] int32."""
    B, N, _ = xyz.shape
    xyz = xyz.float()
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    dist = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    out = torch.empty(B, npoint, dtype=torch.int32, device=xyz.device)
    far = torch.zeros(B, 1, dtype=torch.long, device=xyz.device)
    for i in range(npoint):
        out[:, i] = far[:, 0].to(torch.int32)
        c = torch.gather(xyz, 1, far[:, :, None].expand(-1, -1, 3))  # [B, 1, 3]
        d = _sq3(x - c[..., 0], y - c[..., 1], z - c[..., 2])
        dist = torch.minimum(dist, d)
        far = torch.argmax(dist, dim=-1, keepdim=True)  # first max
    return out


def fps_batched(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """FPS indices [B, npoint] int32 (start index 0 per cloud)."""
    if xyz.device.type == "cpu":
        return fps_plain(xyz, npoint)
    B, N, _ = xyz.shape
    if npoint > N:
        raise ValueError(f"fps_batched: npoint={npoint} > N={N}")
    if 16 * N > _SMEM_LIMIT:
        raise ValueError(f"fps_batched: N={N} does not fit one block's shared memory")
    xyz = xyz.float().contiguous()
    out = torch.empty(B, npoint, dtype=torch.int32, device=xyz.device)
    lib = _build.load("group")
    lib.ppt_fps.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                            ctypes.c_void_p, ctypes.c_void_p]
    rc = lib.ppt_fps(_build.ptr(xyz), B, N, npoint, _build.ptr(out), _build.stream_ptr(xyz))
    _build.check(lib, rc, "fps_batched")
    _build.LAUNCHES["fps_batched"] += 1
    return out


def knn_gather_plain(
    k: int, xyz: torch.Tensor, new_xyz: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch kNN + gather: (idx [B,S,k] int32, nbr - centre [B,S,k,3] f32)."""
    xyz = xyz.float()
    q = new_xyz.float()
    d = _sq3(
        q[:, :, None, 0] - xyz[:, None, :, 0],
        q[:, :, None, 1] - xyz[:, None, :, 1],
        q[:, :, None, 2] - xyz[:, None, :, 2],
    )  # [B, S, N]
    # a stable ascending sort ranks ties by index: the k min-extractions
    idx = torch.sort(d, dim=-1, stable=True).indices[..., :k]
    B, S = idx.shape[:2]
    nbr = torch.gather(xyz, 1, idx.reshape(B, S * k, 1).expand(-1, -1, 3)).reshape(B, S, k, 3)
    return idx.to(torch.int32), nbr - q[:, :, None, :]


def _knn_warps_per_block(N: int) -> int:
    wpb = 8
    while wpb and 4 * N * (3 + wpb) > _SMEM_LIMIT:
        wpb //= 2
    if not wpb:
        raise ValueError(f"knn_gather: N={N} does not fit one block's shared memory")
    return wpb


def knn_gather(
    k: int, xyz: torch.Tensor, new_xyz: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN + centre-relative neighbour coordinates in one kernel:
    (idx [B, S, k] int32, neighbourhood - centre [B, S, k, 3] f32)."""
    if xyz.device.type == "cpu":
        return knn_gather_plain(k, xyz, new_xyz)
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    if k > N:
        raise ValueError(f"knn_gather: k={k} > N={N}")
    xyz = xyz.float().contiguous()
    q = new_xyz.float().contiguous()
    _build.check_tensors("knn_gather", xyz, q)
    wpb = _knn_warps_per_block(N)
    idx = torch.empty(B, S, k, dtype=torch.int32, device=xyz.device)
    nbr = torch.empty(B, S, k, 3, dtype=torch.float32, device=xyz.device)
    lib = _build.load("group")
    lib.ppt_knn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    rc = lib.ppt_knn(_build.ptr(xyz), _build.ptr(q), B, N, S, k, wpb, _build.ptr(idx),
                     _build.ptr(nbr), _build.stream_ptr(xyz))
    _build.check(lib, rc, "knn_gather")
    _build.LAUNCHES["knn_gather"] += 1
    return idx, nbr


def fused_group(
    xyz: torch.Tensor, num_group: int, group_size: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group divider: (neighbourhood - center [B, G, M, 3], center [B, G, 3])."""
    xyz = xyz.detach()
    idx = fps_batched(xyz, num_group)
    center = torch.gather(xyz, 1, idx.long()[:, :, None].expand(-1, -1, 3))
    _, neighborhood = knn_gather(group_size, xyz, center)
    return neighborhood.to(xyz.dtype), center
