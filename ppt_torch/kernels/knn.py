"""k-nearest-neighbour indices of single clouds, one warp a query.

Replaces ``ppt_tpu/kernels/knn.py:knn_pallas``; the CUDA side is
``csrc/cloud.cu:knn_single_kernel`` over ``csrc/knn_select.cuh``, whose
header says what bounds the selection on the H100 and how its design
answers that: the cloud streams through shared memory in chunks of
:data:`CHUNK` points, read by all of a CTA's query warps, and each warp
keeps its query's running top-k in registers, filtering each 32 distances
by a ballot against the k-th pair. ``group.py:knn_gather`` runs the same
selection and also gathers the neighbourhood.

Contract (exact, ties included): cloud ``[B, N, 3]``, queries ``[B, S,
3]`` -> ``[B, S, k]`` int32, the k smallest ``((qx-x)^2 + (qy-y)^2) +
(qz-z)^2``, nearest first, ties to the lowest index. S must tile by
``min(128, S)``, as ``knn_pallas`` asserts; every N and every k in [1, N]
runs (past 64, in passes of 64 over the cloud).

No module calls ``knn_single``, here or in the reference: the reference's
``knn_pallas`` is reached only by its tests.
"""

from __future__ import annotations

import ctypes

import torch

from ppt_torch.kernels import _build, _ops
from ppt_torch.kernels.group import CHUNK, _knn_fake, _knn_flops, knn_gather_plain


def _check(k: int, xyz: torch.Tensor, new_xyz: torch.Tensor) -> None:
    """The checks ``knn_pallas`` makes."""
    B, N, C = xyz.shape
    if C != 3 or new_xyz.dim() != 3 or new_xyz.shape[0] != B or new_xyz.shape[2] != 3:
        raise ValueError(f"knn_single: expects xyz [B, N, 3] and queries [B, S, 3], got "
                         f"{tuple(xyz.shape)} and {tuple(new_xyz.shape)}")
    S = new_xyz.shape[1]
    s_blk = min(128, S)
    if s_blk == 0 or S % s_blk:
        raise ValueError(f"knn_single: S={S} must tile by {s_blk} (min(128, S))")
    if not 1 <= k <= N:
        raise ValueError(f"knn_single: k={k} must lie in [1, N={N}]")


def knn_single_plain(k: int, xyz: torch.Tensor, new_xyz: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, [B, S, k] int32: the indices of
    ``knn_gather``'s plain version, the same function."""
    _check(k, xyz, new_xyz)
    return knn_gather_plain(k, xyz, new_xyz)[0]


def _knn_single_cuda(k: int, xyz: torch.Tensor, new_xyz: torch.Tensor) -> torch.Tensor:
    """``ppt::knn_single`` on the card."""
    _check(k, xyz, new_xyz)
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    xyz = xyz.float().contiguous()
    q = new_xyz.float().contiguous()
    _build.check_tensors("knn_single", xyz, q)
    out = torch.empty(B, S, k, dtype=torch.int32, device=xyz.device)
    if B == 0:
        return out
    lib = _build.load("cloud")
    lib.ppt_knn_single.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p] * 2
    rc = lib.ppt_knn_single(_build.ptr(xyz), _build.ptr(q), B, N, S, k, CHUNK,
                            _build.ptr(out), _build.stream_ptr(xyz))
    _build.check(lib, rc, "knn_single")
    _build.LAUNCHES["knn_single"] += 1
    return out


def _knn_single_fake(k: int, xyz: torch.Tensor, new_xyz: torch.Tensor) -> torch.Tensor:
    return _knn_fake(k, xyz, new_xyz)[0]


_knn_single_op = _ops.register("knn_single(int k, Tensor xyz, Tensor new_xyz) -> Tensor",
                               knn_single_plain, _knn_single_cuda, _knn_single_fake, _knn_flops)


def knn_single(k: int, xyz: torch.Tensor, new_xyz: torch.Tensor) -> torch.Tensor:
    """k nearest neighbours' indices [B, S, k] int32, nearest first
    (``torch.ops.ppt.knn_single``): the kernel on the card, the plain
    version on the CPU."""
    return _knn_single_op(k, xyz, new_xyz)
