"""PointNeXt-S (Qian et al. 2022, ``pointnext-s.yaml``), written plainly.

- Input: xyz and the height above the cloud's lowest point (4 channels),
  a linear stem to ``width``.
- Four set abstractions of stride 2: farthest point sampling of half the
  points, a ball query (the first ``nsample`` points by index within the
  radius, the rest of the slots filled with the first of them), features
  ``[(p_j - c) / r, f_j]``, two Linear -> BatchNorm layers with a ReLU
  between (the first ``out / 2`` wide), max over the ball, plus a linear
  skip of the centre's own feature, then ReLU. The radius starts at
  ``radius`` and grows by ``radius_scaling`` after each stage.
- A global stage: ``[xyz, f]`` through two Linear -> BatchNorm -> ReLU
  layers and a max over all points; a head of Linear -> BatchNorm -> ReLU
  per width (dropout off in evaluation).
BatchNorm (eps 1e-5) with the running statistics: the reference runs the
recognition path only.
"""

from __future__ import annotations

from typing import Dict

import torch

from h100_bench.reference.pointbert import batch_norm, dense, fps, gather, sq_dist
from h100_bench.reference.precision import Products


def ball_query(radius: float, nsample: int, xyz: torch.Tensor, centers: torch.Tensor):
    """Indices [B, S, nsample] of the first ``nsample`` points within
    ``radius`` of each centre, by index; short balls repeat their first."""
    hit = sq_dist(centers, xyz) <= radius * radius  # [B, S, N]
    N = xyz.shape[1]
    order = torch.where(hit, torch.arange(N, device=xyz.device), N)
    idx = torch.sort(order, -1).values[..., :nsample]
    return torch.where(idx == N, idx[..., :1], idx)


class PointNextTower:
    """``__call__(pc [B, N, 3 + extra])`` -> [B, head_mlps[-1]]."""

    def __init__(self, W: Dict[str, torch.Tensor], cfg: Dict, P: Products,
                 prefix: str = "point_encoder."):
        self.W = {k[len(prefix):]: v for k, v in W.items() if k.startswith(prefix)}
        self.cfg, self.P = cfg, P

    def __call__(self, pc: torch.Tensor) -> torch.Tensor:
        W, P, c = self.W, self.P, self.cfg
        xyz, f = pc[..., :3], dense(P, pc, W, "stem")
        radius = c["radius"]
        for s in range(1, len(c["strides"])):
            if c["strides"][s] == 1:  # the global stage
                h = torch.cat([xyz, f], -1)
                for i in range(c["sa_layers"]):
                    name = f"stage{s}_global.conv{i}"
                    h = torch.relu(batch_norm(dense(P, h, W, name + ".conv"), W, name + ".bn",
                                              False))
                f = h.amax(1)
                break
            name = f"stage{s}_sa"
            idx = fps(xyz, xyz.shape[1] // c["strides"][s])
            centers = gather(xyz, idx)
            ball = ball_query(radius, c["nsample"], xyz, centers)
            h = torch.cat([(gather(xyz, ball) - centers[:, :, None]) / radius, gather(f, ball)],
                          -1)
            for i in range(c["sa_layers"]):
                h = batch_norm(dense(P, h, W, f"{name}.conv{i}.conv"), W, f"{name}.conv{i}.bn",
                               False)
                h = torch.relu(h) if i < c["sa_layers"] - 1 else h
            f = torch.relu(h.amax(2) + dense(P, gather(f, idx), W, f"{name}.skipconv"))
            xyz = centers
            radius *= c["radius_scaling"]
        for i in range(len(c["head_mlps"])):
            f = torch.relu(batch_norm(dense(P, f, W, f"head_fc{i}"), W, f"head_bn{i}", False))
        return f


def with_height(pc: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """[B, N, 3] -> [B, N, 4]: the height above the lowest point on ``axis``."""
    h = pc[..., axis:axis + 1]
    return torch.cat([pc, h - h.amin(1, keepdim=True)], -1)
