"""The auction approxmatch behind the EMD, and its match cost.

Replaces ``ppt_tpu/kernels/emd.py:approx_match_pallas``
(``_approx_match_kernel``) and ``:emd_matchcost_pallas``; the CUDA side is
``csrc/losses3d.cu``, whose header says what bounds the kernel on the H100
and how its design answers that.

``approx_match(xyz1, xyz2)`` is Fan's ten-level auction (the reference
EMD's ``approxmatch``, ``openpoints/cpp/emd/cuda/emd_kernel.cu:29-161``):
the transport plan ``match [B, N, M]`` f32 over the squared distances
``d2 = clamp(square_distance(xyz1, xyz2), 0)``, which the wrapper computes
outside the kernel as the reference does (``emd.py:119``). Supplies are
``multi_l = max(M // N, 1)`` per left point and ``multi_r = max(N // M, 1)``
per right point, integer ratios. Clouds of at most ``WARP_MAX`` points a
side (the dVAE's 8 x 32 and 32 x 32) run one warp a cloud, the rule
:func:`warp_auction` that the plain version's summation order follows too;
larger ones run one block a cloud, d2 and the match in shared memory when
they fit and streamed from device memory otherwise. ``emd_fits_pallas``
is the TPU's VMEM bound, kept for API parity and used for no routing.

``emd_matchcost`` is ``sum(d2 * match)`` per cloud with the reference's
closed-form backward (``emd.py:171-180``, ``matchcostgrad1/2``): the match
is a constant, and the two batched products of the gradient stay
``torch.bmm``, as the reference leaves them to XLA.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ppt_torch.kernels import _build, _losses3d
from ppt_torch.kernels._autograd import refuse_second_order
from ppt_torch.ops.geometry import square_distance

# -4^j for j = 7..-1, then a final exact level 0 (``emd.py:46``)
LEVELS = tuple(-(4.0 ** j) for j in range(7, -2, -1)) + (0.0,)

_VMEM_ELEMS = 786_432  # the TPU kernel's scoped-VMEM cap (``emd.py:52``)
WARP_MAX = 32  # the warp kernel's limit on either side (``csrc/losses3d.cu:kAmWarpMax``)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def emd_fits_pallas(n: int, m: int) -> bool:
    """The reference's TPU bound (``emd.py:57``): whether one cloud's
    auction fits its kernel's VMEM. The port's kernel runs every shape."""
    return _round_up(n, 8) * _round_up(m, 128) <= _VMEM_ELEMS


def supplies(n: int, m: int) -> Tuple[float, float]:
    """(multi_l, multi_r): each left point's and each right point's supply."""
    return (1.0, float(n // m)) if n >= m else (float(m // n), 1.0)


def match_d2(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """The auction's squared distances [B, N, M] f32, clamped at 0."""
    return torch.clamp_min(square_distance(xyz1, xyz2), 0.0)


def warp_auction(n: int, m: int) -> bool:
    """The shape rule: an n x m cloud runs ``approx_match_warp_kernel`` (one
    warp a cloud, every sum in :func:`_sum4`'s order) when neither side
    passes ``WARP_MAX``, else ``approx_match_kernel`` (one block a cloud,
    row sums over 32 lanes and a butterfly, column sums in index order).
    The wrapper launches by it and :func:`auction_plain` sums by it."""
    return max(n, m) <= WARP_MAX


def _row_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the block kernel's order: 32 lanes each sum
    the entries ``m = lane, lane + 32, ...`` in turn, then a butterfly of
    pairwise adds (xor 16, 8, 4, 2, 1); lane 0's value."""
    M = t.shape[-1]
    t = torch.nn.functional.pad(t, (0, -M % 32)).unflatten(-1, (-1, 32))
    s = t[..., 0, :]
    for k in range(1, t.shape[-2]):
        s = s + t[..., k, :]
    lane = torch.arange(32, device=t.device)
    for o in (16, 8, 4, 2, 1):
        s = s + s[..., lane ^ o]
    return s[..., 0]


def _seq_sum(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` in index order: the block kernel's column sums."""
    t = t.movedim(dim, 0)
    s = t[0]
    for k in range(1, t.shape[0]):
        s = s + t[k]
    return s


def _sum4(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` in the warp kernel's order (``csrc/losses3d.cu:Sum4``):
    four partial sums of the entries ``k = j, j + 4, ...``, each in index
    order, then ``(s0 + s1) + (s2 + s3)``."""
    t = t.movedim(dim, 0)
    s = [torch.zeros_like(t[0]) for _ in range(4)]
    for k in range(t.shape[0]):
        s[k % 4] = s[k % 4] + t[k]
    return (s[0] + s[1]) + (s[2] + s[3])


def auction_plain(d2: torch.Tensor, multi_l: float, multi_r: float) -> torch.Tensor:
    """Plain PyTorch auction over ``d2`` [B, N, M] f32 -> match [B, N, M],
    in the kernel's update order, every op rounded on its own and every sum
    in the kernel's order: the auction is ill-conditioned where a row's
    bids nearly vanish (``ratio_l = remain_l / (1e-9 + suml)``), and there
    two summation orders of the same f32 values differ by up to 4e-4 of a
    unit supply over 4096 clouds of 32 x 32 points. The row sums take the
    order of the kernel that :func:`warp_auction` picks."""
    B, N, M = d2.shape
    if warp_auction(N, M):
        row_sum, col_sum = (lambda t: _sum4(t, -1)), (lambda t: _sum4(t, 1))
    else:
        row_sum, col_sum = _row_sum, (lambda t: _seq_sum(t, 1))
    remain_l = torch.full((B, N), multi_l, dtype=torch.float32, device=d2.device)
    remain_r = torch.full((B, M), multi_r, dtype=torch.float32, device=d2.device)
    match = torch.zeros_like(d2)
    for level in LEVELS:
        w = torch.exp(level * d2)
        suml = 1e-9 + row_sum(w * remain_r[:, None, :])
        ratio_l = remain_l / suml
        sumr = col_sum(w * ratio_l[:, :, None]) * remain_r
        consumption = torch.clamp_max(remain_r / (sumr + 1e-9), 1.0)
        ratio_r = consumption * remain_r
        remain_r = torch.clamp_min(remain_r - sumr, 0.0)
        flow = w * ratio_l[:, :, None] * ratio_r[:, None, :]
        match = match + flow
        remain_l = torch.clamp_min(remain_l - row_sum(flow), 0.0)
    return match


def approx_match_plain(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`approx_match` (the port of
    ``ppt_tpu/ops/losses3d.py:77 approx_match``)."""
    return auction_plain(match_d2(xyz1, xyz2), *supplies(xyz1.shape[1], xyz2.shape[1]))


def _auction_run(d2: torch.Tensor) -> torch.Tensor:
    B, N, M = d2.shape
    if N < 1 or M < 1:
        raise ValueError(f"approx_match: needs N, M >= 1, got d2 {tuple(d2.shape)}")
    d2 = d2.detach().float().contiguous()
    match = torch.empty_like(d2)
    if B == 0:
        return match
    lib = _losses3d.lib()
    if warp_auction(N, M):
        rc = lib.ppt_approx_match_warp(_build.ptr(d2), B, N, M, *supplies(N, M),
                                       _build.ptr(match), _build.stream_ptr(d2))
    else:
        scratch = None
        if lib.ppt_approx_match_needs_scratch(N, M):  # the supply vectors alone pass 227 KB
            scratch = torch.empty(B, 2 * (N + M), dtype=torch.float32, device=d2.device)
        rc = lib.ppt_approx_match(_build.ptr(d2), B, N, M, *supplies(N, M),
                                  None if scratch is None else _build.ptr(scratch),
                                  _build.ptr(match), _build.stream_ptr(d2))
    _build.check(lib, rc, "approx_match")
    _build.LAUNCHES["approx_match"] += 1
    return match


def _match(d2: torch.Tensor) -> torch.Tensor:
    if d2.device.type == "cpu":
        return auction_plain(d2, *supplies(*d2.shape[1:]))
    return _auction_run(d2)


def approx_match(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """Transport plan ``match [B, N, M]`` f32 of ``xyz1 [B, N, 3]`` onto
    ``xyz2 [B, M, 3]``: the kernel on the card, the plain version on the
    CPU."""
    return _match(match_d2(xyz1, xyz2))


class _MatchCost(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz1, xyz2):
        d2 = match_d2(xyz1, xyz2)
        match = _match(d2)
        ctx.save_for_backward(xyz1, xyz2, match)
        return (d2 * match).sum((1, 2))

    @staticmethod
    def backward(ctx, g):
        refuse_second_order("approx_match")
        # matchcostgrad1/2: d cost / d x1_n = 2 sum_m match[n, m] (x1_n - x2_m)
        xyz1, xyz2, match = ctx.saved_tensors
        x1, x2 = xyz1.float(), xyz2.float()
        g1 = 2.0 * (x1 * match.sum(2)[..., None] - torch.bmm(match, x2))
        g2 = 2.0 * (x2 * match.sum(1)[..., None] - torch.bmm(match.transpose(1, 2), x1))
        s = g.float()[:, None, None]
        return (s * g1).to(xyz1.dtype), (s * g2).to(xyz2.dtype)


def emd_matchcost(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """The reference-contract EMD match cost [B] through :func:`approx_match`:
    ``sum(d2 * match)`` per cloud, the match a constant in the backward."""
    return _MatchCost.apply(xyz1, xyz2)
