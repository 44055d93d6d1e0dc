"""3D reconstruction losses: Chamfer distance and Earth Mover's Distance.

Counterpart of ``ppt_tpu/ops/losses3d.py:42-205``, the plain PyTorch
specification. The Chamfer variants (L2: mean squared minima; L1: mean of
their square roots; ``_split``: each direction apart) take the expanded
squared distance clamped at 0 (``ops.geometry.square_distance``), and stay
plain on every device, as the reference keeps them in XLA: the blocked
nearest-neighbour kernel is ``kernels.chamfer``.

EMD in two forms:

- :func:`emd_matchcost` / :func:`earth_mover_distance`: the reference's
  contract, Fan's ``approxmatch`` auction (``kernels.emd``) with its
  squared-distance cost and the match a constant in the gradient.
  ``earth_mover_distance`` sends a CUDA tensor to the auction kernel unless
  ``PPT_FORCE_XLA_EMD`` is set (the reference's own switch, any value), and
  a CPU tensor to the plain version.
- :func:`emd_distance`: entropy-regularised transport by Sinkhorn in log
  space with the euclidean cost and a differentiable plan, the reference's
  alternative; plain only, and not comparable with the auction's numbers.
"""

from __future__ import annotations

import math
import os
from typing import Tuple

import torch

from ppt_torch.kernels import emd as kemd
from ppt_torch.ops.geometry import square_distance

_EPS = 1e-12

# the plain auction (``ppt_tpu/ops/losses3d.py:77``): ten levels, integer
# supplies, the reference kernel's update order
approx_match = kemd.approx_match_plain


def chamfer_distance_split(xyz1: torch.Tensor,
                           xyz2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d1 [B, N], d2 [B, M]): each point's squared distance to its nearest
    neighbour in the other cloud."""
    d = torch.clamp_min(square_distance(xyz1, xyz2), 0.0)
    return d.amin(2), d.amin(1)


def chamfer_l2(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """ChamferDistanceL2: mean squared minima, both directions summed."""
    d1, d2 = chamfer_distance_split(xyz1, xyz2)
    return d1.mean() + d2.mean()


def chamfer_l2_split(xyz1: torch.Tensor, xyz2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    d1, d2 = chamfer_distance_split(xyz1, xyz2)
    return d1.mean(), d2.mean()


def chamfer_l1(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """ChamferDistanceL1: mean euclidean (square-root) minima."""
    d1, d2 = chamfer_distance_split(xyz1, xyz2)
    return torch.sqrt(d1 + _EPS).mean() + torch.sqrt(d2 + _EPS).mean()


def chamfer_l1_split(xyz1: torch.Tensor, xyz2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    d1, d2 = chamfer_distance_split(xyz1, xyz2)
    return torch.sqrt(d1 + _EPS).mean(), torch.sqrt(d2 + _EPS).mean()


def emd_matchcost(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """``matchcost(approxmatch(x1, x2))``, plain: the total squared-distance
    transport cost per cloud [B]; autograd differentiates the distances
    only (the match is detached), which is the reference's closed form."""
    match = approx_match(xyz1, xyz2).detach()
    return (torch.clamp_min(square_distance(xyz1, xyz2), 0.0) * match).sum((1, 2))


def emd_uses_kernel(device: torch.device) -> bool:
    """The auction kernel serves CUDA tensors unless ``PPT_FORCE_XLA_EMD``
    is set to anything (``ppt_tpu/ops/losses3d.py:156-160``)."""
    return torch.device(device).type == "cuda" and not os.environ.get("PPT_FORCE_XLA_EMD")


def earth_mover_distance(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """The reference's module-level EMD (``emd.py:32-48``): the match cost
    over N1, averaged over the batch. Scalar."""
    cost_fn = kemd.emd_matchcost if emd_uses_kernel(xyz1.device) else emd_matchcost
    return (cost_fn(xyz1, xyz2) / xyz1.shape[1]).mean()


def emd_distance(xyz1: torch.Tensor, xyz2: torch.Tensor, eps: float = 0.02,
                 iters: int = 50) -> torch.Tensor:
    """Approximate EMD per cloud [B]: ``iters`` log-space Sinkhorn
    iterations of entropy-regularised transport with uniform marginals and
    the euclidean cost; the mean transport cost of each cloud's plan."""
    B, N, _ = xyz1.shape
    M = xyz2.shape[1]
    cost = torch.sqrt(torch.clamp_min(square_distance(xyz1, xyz2), 0.0) + _EPS)
    log_k = -cost / eps
    log_mu, log_nu = -math.log(N), -math.log(M)
    f = torch.zeros(B, N, dtype=cost.dtype, device=cost.device)
    g = torch.zeros(B, M, dtype=cost.dtype, device=cost.device)
    for _ in range(iters):
        f = eps * (log_mu - torch.logsumexp((g[:, None, :] + log_k * eps) / eps, dim=2))
        g = eps * (log_nu - torch.logsumexp((f[:, :, None] + log_k * eps) / eps, dim=1))
    plan = torch.exp((f[:, :, None] + g[:, None, :]) / eps + log_k)
    return (plan * cost).sum((1, 2))
