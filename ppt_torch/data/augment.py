"""Point-cloud augmentation on device tensors.

Counterpart of ``ppt_tpu/data/augment.py``: batch functions over
``[B, N, 3]`` that draw from an explicit ``torch.Generator`` on the
tensor's device. The PPT task scripts use ``translate_pointcloud`` and
``shuffle_points`` (``train_augment``; votes in evaluation); the others
(``:30-112``) are the reference's toolbox. The distributions are the
reference's; the numbers are not (another generator), so tests compare
distributions.
"""

from __future__ import annotations

import math

import torch


def _uniform(gen: torch.Generator, shape, lo: float, hi: float, like: torch.Tensor):
    u = torch.rand(shape, generator=gen, device=like.device, dtype=torch.float32)
    return (u * (hi - lo) + lo).to(like.dtype)


def _normal(gen: torch.Generator, shape, like: torch.Tensor):
    return torch.randn(shape, generator=gen, device=like.device, dtype=torch.float32)


def normalize_to_unit_sphere(pc: torch.Tensor) -> torch.Tensor:
    """Centre each cloud at its centroid and scale it to radius 1
    (``pc_normalize``; no draw)."""
    centered = pc - pc.mean(dim=-2, keepdim=True)
    return centered / torch.linalg.vector_norm(centered, dim=-1, keepdim=True).amax(
        dim=-2, keepdim=True)


def rotate_y(gen: torch.Generator, pc: torch.Tensor) -> torch.Tensor:
    """A rotation about the up (y) axis per cloud, its angle U[0, 2 pi)."""
    B = pc.shape[0]
    angle = _uniform(gen, (B,), 0.0, 2.0 * math.pi, pc.float())
    c, s = torch.cos(angle), torch.sin(angle)
    zeros, ones = torch.zeros_like(c), torch.ones_like(c)
    rot = torch.stack([c, zeros, s, zeros, ones, zeros, -s, zeros, c], -1).reshape(B, 3, 3)
    return torch.bmm(pc.float(), rot).to(pc.dtype)


def rotate_perturbation(gen: torch.Generator, pc: torch.Tensor, angle_sigma: float = 0.06,
                        angle_clip: float = 0.18) -> torch.Tensor:
    """Small rotations about all three axes per cloud: angles
    N(0, sigma^2) clipped to [-clip, clip], applied as Rz Ry Rx."""
    B = pc.shape[0]
    angles = torch.clamp(angle_sigma * _normal(gen, (B, 3), pc), -angle_clip, angle_clip)
    cx, cy, cz = torch.cos(angles).unbind(-1)
    sx, sy, sz = torch.sin(angles).unbind(-1)
    zeros, ones = torch.zeros_like(cx), torch.ones_like(cx)
    rx = torch.stack([ones, zeros, zeros, zeros, cx, -sx, zeros, sx, cx], -1).reshape(B, 3, 3)
    ry = torch.stack([cy, zeros, sy, zeros, ones, zeros, -sy, zeros, cy], -1).reshape(B, 3, 3)
    rz = torch.stack([cz, -sz, zeros, sz, cz, zeros, zeros, zeros, ones], -1).reshape(B, 3, 3)
    return torch.bmm(pc.float(), rz @ ry @ rx).to(pc.dtype)


def jitter(gen: torch.Generator, pc: torch.Tensor, sigma: float = 0.01,
           clip: float = 0.05) -> torch.Tensor:
    """Per-point noise N(0, sigma^2), clipped to [-clip, clip]."""
    return pc + torch.clamp(sigma * _normal(gen, pc.shape, pc), -clip, clip).to(pc.dtype)


def random_scale(gen: torch.Generator, pc: torch.Tensor, lo: float = 0.8,
                 hi: float = 1.25) -> torch.Tensor:
    """One isotropic scale U[lo, hi] per cloud."""
    return pc * _uniform(gen, (pc.shape[0], 1, 1), lo, hi, pc)


def shift(gen: torch.Generator, pc: torch.Tensor, rng: float = 0.1) -> torch.Tensor:
    """One shift U[-rng, rng]^3 per cloud."""
    return pc + _uniform(gen, (pc.shape[0], 1, 3), -rng, rng, pc)


def random_point_dropout(gen: torch.Generator, pc: torch.Tensor,
                         max_dropout_ratio: float = 0.875) -> torch.Tensor:
    """Each cloud draws a ratio r ~ U[0, 1) and replaces each point with
    its first point with probability r * max_dropout_ratio (the shape stays
    static, as the reference keeps it)."""
    B, N, _ = pc.shape
    ratio = _uniform(gen, (B, 1), 0.0, 1.0, pc.float())
    u = _uniform(gen, (B, N), 0.0, 1.0, pc.float())
    drop = u <= ratio * max_dropout_ratio
    return torch.where(drop[..., None], pc[:, :1, :], pc)


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
