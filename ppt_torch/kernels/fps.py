"""Farthest point sampling, one cloud per kernel instance.

Replaces ``ppt_tpu/kernels/fps.py:fps_pallas``; the CUDA side is
``csrc/cloud.cu:fps_single_kernel``, whose header says what bounds it on
the H100 and how its design answers that. A kernel of its own beside
``group.py:fps_batched``'s: the same function, another design (1024
threads a cloud, two barriers a step, the winner's coordinates carried
through the reduction).

Contract (exact, ties included): ``[B, N, 3]`` coordinates of any float
type, taken as f32 -> ``[B, npoint]`` int32; start at index 0, running
minimum distance initialised to 1e10, ``((x-cx)^2 + (y-cy)^2) + (z-cz)^2``
with each operation rounded, the FIRST argmax each step. The kernel takes
N up to ``MAX_POINTS``.

No module calls ``fps_single``, here or in the reference: the reference's
``fps_pallas`` is reached only by its tests.
"""

from __future__ import annotations

import ctypes

import torch

from ppt_torch.kernels import _build
from ppt_torch.kernels.group import fps_plain

# 1024 threads x 16 points held per thread (csrc/cloud.cu)
MAX_POINTS = 16384


def fps_single_plain(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Plain PyTorch version, [B, npoint] int32: the FPS recurrence."""
    return fps_plain(xyz, npoint)


def fps_single(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """FPS indices [B, npoint] int32 (start index 0 per cloud): the kernel
    on the card, the plain version on the CPU."""
    if xyz.device.type == "cpu":
        return fps_single_plain(xyz, npoint)
    B, N, C = xyz.shape
    if C != 3:
        raise ValueError(f"fps_single: expects xyz [B, N, 3], got {tuple(xyz.shape)}")
    if N > MAX_POINTS:
        raise ValueError(f"fps_single: N={N} exceeds the kernel's cap of {MAX_POINTS} points "
                         "(1024 threads x 16 points a thread)")
    xyz = xyz.float().contiguous()
    out = torch.empty(B, npoint, dtype=torch.int32, device=xyz.device)
    if B == 0 or npoint == 0:
        return out
    lib = _build.load("cloud")
    lib.ppt_fps_single.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    rc = lib.ppt_fps_single(_build.ptr(xyz), B, N, npoint, _build.ptr(out),
                            _build.stream_ptr(xyz))
    _build.check(lib, rc, "fps_single")
    _build.LAUNCHES["fps_single"] += 1
    return out
