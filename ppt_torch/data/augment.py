"""Train-time point-cloud augmentation on device tensors.

Counterpart of ``ppt_tpu/data/augment.py`` for what the PPT task scripts use
(``:40-46``, ``:114-141``): batch functions over ``[B, N, 3]`` that draw
from an explicit ``torch.Generator`` on the tensor's device. The
distributions are the reference's; the numbers are not (another
generator), so tests compare distributions.
"""

from __future__ import annotations

import torch


def _uniform(gen: torch.Generator, shape, lo: float, hi: float, like: torch.Tensor):
    u = torch.rand(shape, generator=gen, device=like.device, dtype=torch.float32)
    return (u * (hi - lo) + lo).to(like.dtype)


def translate_pointcloud(gen: torch.Generator, pc: torch.Tensor) -> torch.Tensor:
    """Per-cloud anisotropic scale U[2/3, 3/2] and shift U[-0.2, 0.2]."""
    B = pc.shape[0]
    scale = _uniform(gen, (B, 1, 3), 2.0 / 3.0, 3.0 / 2.0, pc)
    shift = _uniform(gen, (B, 1, 3), -0.2, 0.2, pc)
    return pc * scale + shift


def shuffle_points(gen: torch.Generator, pc: torch.Tensor) -> torch.Tensor:
    """A random permutation of each cloud's points (randomises the FPS
    seed point, like ``np.random.shuffle`` in the reference's loaders)."""
    B, N, C = pc.shape
    perm = torch.rand(B, N, generator=gen, device=pc.device).argsort(dim=1)
    return torch.gather(pc, 1, perm[..., None].expand(-1, -1, C))


def append_height(pc: torch.Tensor, gravity_dim: int = 1) -> torch.Tensor:
    """Append ``y - min(y)`` as a 4th channel (PointNeXt's use_height)."""
    h = pc[..., gravity_dim:gravity_dim + 1]
    return torch.cat([pc, h - h.amin(dim=-2, keepdim=True)], dim=-1)


def train_augment(gen: torch.Generator, pc: torch.Tensor,
                  use_height: bool = False) -> torch.Tensor:
    """The PPT tasks' train-time pipeline: anisotropic scale + shift,
    then point shuffle, then the optional height channel."""
    out = shuffle_points(gen, translate_pointcloud(gen, pc))
    return append_height(out) if use_height else out
