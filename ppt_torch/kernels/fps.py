"""Farthest point sampling of single clouds.

Replaces ``ppt_tpu/kernels/fps.py:fps_pallas``. It computes
``group.py:fps_batched``'s function, so it launches the same kernel,
``csrc/group.cu:fps_batched_kernel``, through the launcher the two share
(``group.py:fps_launch``, whose ``ppt_fps`` picks the warps a cloud);
that header says what bounds the kernel on the H100 and how its design
answers that. Only the launch counter and the refusals are its own.

Contract (exact, ties included): ``[B, N, 3]`` coordinates of any float
type, taken as f32 -> ``[B, npoint]`` int32; start at index 0, running
minimum distance initialised to 1e10, ``((x-cx)^2 + (y-cy)^2) + (z-cz)^2``
with each operation rounded, the FIRST argmax each step. The kernel takes
N up to ``MAX_POINTS``. Unlike ``fps_batched`` it takes npoint past N, as
``fps_pallas`` does: once every distinct point is picked, every running
distance is 0 and each later step picks index 0.

No module calls ``fps_single``, here or in the reference: the reference's
``fps_pallas`` is reached only by its tests.
"""

from __future__ import annotations

import torch

from ppt_torch.kernels import _ops
from ppt_torch.kernels.group import FPS_MAX_POINTS, _fps_fake, _fps_flops, fps_launch, fps_plain

MAX_POINTS = FPS_MAX_POINTS


def fps_single_plain(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Plain PyTorch version, [B, npoint] int32: the FPS recurrence."""
    return fps_plain(xyz, npoint)


def _fps_single_cuda(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """``ppt::fps_single`` on the card: npoint past N too."""
    return fps_launch("fps_single", xyz, npoint)


_fps_single_op = _ops.register("fps_single(Tensor xyz, int npoint) -> Tensor", fps_single_plain,
                               _fps_single_cuda, _fps_fake, _fps_flops)


def fps_single(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """FPS indices [B, npoint] int32 (start index 0 per cloud),
    ``torch.ops.ppt.fps_single``: the kernel on the card, the plain version
    on the CPU."""
    return _fps_single_op(xyz, npoint)
