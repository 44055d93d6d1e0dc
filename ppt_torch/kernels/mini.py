"""Fused MiniPointNet kernels: the forward with both BatchNorms folded,
and the train-mode BN2 statistics sweep.

Replaces ``ppt_tpu/kernels/mini.py:mini_forward`` (``_forward_kernel``)
and ``:mini_stats`` (``_stats_kernel`` + the closed-form epilogue of
``_stats_pallas``); the CUDA side is ``csrc/mini.cu``, whose headers say
what bounds each kernel on the H100 and how its design answers that. In
bf16 the forward is ``mini_forward_wgmma_kernel``: persistent CTAs whose
producer streams the four weight matrices by TMA into a ring that two
consumer warpgroups read with wgmma; it takes PointBERT's widths, and the
masked-point autoencoder's, whose last layer is 128 wide (a template on
the output width, ``CO`` 128 or 256).

Chain per group of M points (``mini.py:148-175``), in the compute dtype
with f32 accumulation, rounding after every dot product and after every
bias add::

    x1 = relu(x @ fw1 + fb1)           x2 = x1 @ w2 + b2
    g  = max_M x2                      h  = relu(x2 @ fwl + g @ fwg + fbs)
    out = max_M (h @ w3 + b3)          -> [B, G, CO]

``mini_stats`` returns ``(sum h, sum h^2)`` of the pre-BN2 activations
``h = x2 @ wl + g @ wg + bsplit`` over all rows without ever forming
``h``: the kernel sweeps x2 once for its second-moment matrix and the
per-group column sums and maxes, and a closed form in f32 does the rest
(``mini.py:207-272``). In bf16 the sweep is ``mini_stats_wgmma_kernel``:
persistent CTAs with w2 resident in shared memory (one TMA load), x2 and
the upper triangle of the symmetric m2 on wgmma, m2's accumulators in
registers across a CTA's tiles, the group sums on the tensor cores too
(x2^T against a group indicator) and the maxes read back from x2's tile;
a reduce kernel adds the CTAs' partials in order and mirrors the
triangle.

Both are registered operators, ``torch.ops.ppt.mini_forward`` and
``torch.ops.ppt.mini_stats`` (``_ops.py``): the plain version on the CPU
key; on the CUDA key the forward kernel, and the sweep with its f32
epilogue. Neither kernel has a backward kernel in the reference; both
public functions carry the gradient of their plain version
(``_autograd.py``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ppt_torch.kernels import _build, _ops
from ppt_torch.kernels._autograd import recompute_grad
from ppt_torch.kernels.vitblock import check_tma

_MAX_M = 32
_TC_WIDTHS = (128, 256, 512)  # C1, C2, H of the bf16 wgmma forward (C1, C2 of mini_stats)
_TC_OUT = (128, 256)  # CO of the bf16 forward: MAE's tokens, PointBERT's


def _mm(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """f32-accumulated product of dtype operands, rounded to dtype."""
    return (a.to(dtype).float() @ b.to(dtype).float()).to(dtype)


def mini_forward_plain(
    m_size: int, dtype: torch.dtype, groups2: torch.Tensor, fw1, fb1, w2, b2, fwg, fwl,
    fbsplit, w3, b3,
) -> torch.Tensor:
    """Plain PyTorch version: groups2 [B, G*M, 3] f32 -> [B, G, CO] dtype."""
    B, GM, _ = groups2.shape
    G = GM // m_size

    def bias(t):
        return t.to(dtype)

    x = groups2.to(dtype)
    x1 = torch.relu(_mm(x, fw1, dtype) + bias(fb1))  # flax's relu: gradient 0 at 0
    x2 = _mm(x1, w2, dtype) + bias(b2)  # [B, GM, C2]
    x2g = x2.reshape(B, G, m_size, -1)
    g = x2g.amax(dim=2)  # [B, G, C2]
    gh = _mm(g, fwg, dtype)  # [B, G, H]
    x2h = _mm(x2g, fwl, dtype)  # [B, G, M, H]
    h = torch.relu(x2h + gh[:, :, None, :] + bias(fbsplit))
    y = _mm(h, w3, dtype) + bias(b3)
    return y.amax(dim=2)


def _mini_forward_cuda(
    m_size: int, dtype: torch.dtype, groups2: torch.Tensor, fw1, fb1, w2, b2, fwg, fwl,
    fbsplit, w3, b3,
) -> torch.Tensor:
    """``ppt::mini_forward`` on the card."""
    args = (fw1, fb1, w2, b2, fwg, fwl, fbsplit, w3, b3)
    B, GM, C = groups2.shape
    C1, C2, H, CO = fw1.shape[1], w2.shape[1], fwl.shape[1], w3.shape[1]
    if C != 3 or GM % m_size or m_size > _MAX_M:
        raise ValueError(f"mini_forward: groups2 {tuple(groups2.shape)} with M={m_size} "
                         f"(needs [B, G*M, 3], M <= {_MAX_M})")
    if dtype == torch.bfloat16 and ((C1, C2, H) != _TC_WIDTHS or CO not in _TC_OUT):
        raise ValueError(f"mini_forward: bf16 takes (C1, C2, H) = {_TC_WIDTHS} and CO in "
                         f"{_TC_OUT}, got {(C1, C2, H, CO)}")
    if any(c % 4 for c in (C1, C2, H)) or CO > 256:
        raise ValueError(f"mini_forward: widths C1={C1} C2={C2} H={H} must be multiples "
                         f"of 4 and CO={CO} <= 256")
    code = _build.dtype_code("mini_forward", dtype)
    x = groups2.float().contiguous()
    w = [t.to(dtype).contiguous() for t in args]
    # the bf16 kernel streams the four matrices by TMA
    check_tma("mini_forward", w2=w[2], fwg=w[4], fwl=w[5], w3=w[7])
    _build.check_tensors("mini_forward", x, *w)
    n_groups = B * (GM // m_size)
    out = torch.empty(B, GM // m_size, CO, dtype=dtype, device=x.device)
    lib = _build.load("mini")
    lib.ppt_mini_forward.argtypes = (
        [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 11
    )
    rc = lib.ppt_mini_forward(code, _build.ptr(x), n_groups, m_size, C1, C2, H, CO,
                              *[_build.ptr(t) for t in w], _build.ptr(out),
                              _build.stream_ptr(x))
    _build.check(lib, rc, "mini_forward")
    _build.LAUNCHES["mini_forward"] += 1
    return out


def _mini_forward_fake(m_size, dtype, groups2, fw1, fb1, w2, b2, fwg, fwl, fbsplit, w3, b3):
    B, GM = groups2.shape[:2]
    return groups2.new_empty(B, GM // m_size, w3.shape[1], dtype=dtype)


def _mini_forward_flops(m_size, dtype, groups2, fw1, fb1, w2, b2, fwg, fwl, fbsplit, w3,
                        b3) -> int:
    B, GM, C = groups2
    C1, C2, H, CO = fw1[1], w2[1], fwl[1], w3[1]
    # four products a point, and the group maxima's product with fwg once a group
    return 2 * B * GM * (C * C1 + C1 * C2 + C2 * H + H * CO) + 2 * B * (GM // m_size) * C2 * H


_mini_forward_run = _ops.register(
    "mini_forward(int m_size, ScalarType dtype, Tensor groups2, Tensor fw1, Tensor fb1, "
    "Tensor w2, Tensor b2, Tensor fwg, Tensor fwl, Tensor fbsplit, Tensor w3, Tensor b3) "
    "-> Tensor", mini_forward_plain, _mini_forward_cuda, _mini_forward_fake, _mini_forward_flops)


def mini_forward(
    m_size: int, dtype: torch.dtype, groups2: torch.Tensor, fw1, fb1, w2, b2, fwg, fwl,
    fbsplit, w3, b3,
) -> torch.Tensor:
    """Fused MiniPointNet tokens [B, G, CO] in ``dtype`` (BNs pre-folded).

    groups2: [B, G*M, 3] f32; weights [in, out] and biases in any float
    type (rounded to ``dtype`` as the TPU kernel does). Differentiable:
    the backward recomputes ``mini_forward_plain``."""
    return recompute_grad("mini_forward", _mini_forward_run, mini_forward_plain, m_size, dtype,
                          groups2, fw1, fb1, w2, b2, fwg, fwl, fbsplit, w3, b3)


# ---------------------------------------------------------------------------
# mini_stats
# ---------------------------------------------------------------------------


def _stats_epilogue(m_size: int, m2, sg, gmax, wg, wl, bsplit):
    """(sum h, sum h^2) [H] f32 from the sweep's outputs, with the f32
    ``wl``/``wg``/``bsplit`` (``mini.py:256-272``): with a = x2 @ wl per
    point and b_g = gmax_g @ wg + bsplit per group,

        sum h   = (sum_g S_g) @ wl + M sum_g b_g
        sum h^2 = diag(wl^T m2 wl) + 2 sum_g (S_g @ wl) * b_g + M sum_g b_g^2
    """
    wl32, wg32 = wl.float(), wg.float()
    b_g = gmax @ wg32 + bsplit.float()  # [BG, H]
    a_g = sg @ wl32  # [BG, H]: sum of a over the group's points
    diag = (wl32 * (m2 @ wl32)).sum(0)  # sum over points of a^2, per channel
    sum_h = a_g.sum(0) + m_size * b_g.sum(0)
    sumsq_h = diag + 2.0 * (a_g * b_g).sum(0) + m_size * (b_g * b_g).sum(0)
    return sum_h, sumsq_h


def mini_stats_sweep_plain(m_size: int, dtype: torch.dtype, groups2: torch.Tensor, fw1, fb1,
                           w2, b2):
    """Plain PyTorch version of the sweep: (m2 [C2, C2], sg, gmax [B*G, C2])
    f32, with x2 rounded to ``dtype`` and every sum accumulated in f32."""
    B, GM, _ = groups2.shape
    x = groups2.to(dtype)
    x1 = torch.relu(_mm(x, fw1, dtype) + fb1.to(dtype))
    x2 = (_mm(x1, w2, dtype) + b2.to(dtype)).reshape(B * GM, -1)  # [N, C2] dtype
    x2f = x2.float()
    x2g = x2.reshape(B * GM // m_size, m_size, -1)
    return x2f.t() @ x2f, x2g.float().sum(1), x2g.amax(1).float()


def mini_stats_plain(
    m_size: int, dtype: torch.dtype, groups2: torch.Tensor, fw1, fb1, w2, b2, wg, wl, bsplit,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version, step by step as ``_stats_pallas``: x2 rounded
    to ``dtype``, m2 = x2^T x2 and the group sums accumulated in f32 from
    the rounded x2, then the f32 epilogue. (The reference's ``_stats_twin``
    forms per-point h with dtype-rounded ``wl``/``wg`` instead, which in
    bf16 differs by design.)"""
    m2, sg, gmax = mini_stats_sweep_plain(m_size, dtype, groups2, fw1, fb1, w2, b2)
    return _stats_epilogue(m_size, m2, sg, gmax, wg, wl, bsplit)


def mini_stats_sweep(m_size: int, dtype: torch.dtype, groups2: torch.Tensor, fw1, fb1, w2, b2):
    """The kernel alone on the card: (m2 [C2, C2], sg, gmax [B*G, C2]) f32.
    In bf16 ``mini_stats_wgmma_kernel`` (w2 loaded once a CTA by TMA, x2 and
    m2's upper triangle on wgmma, m2 mirrored by the reduce kernel)."""
    B, GM, C = groups2.shape
    C1, C2 = fw1.shape[1], w2.shape[1]
    if C != 3 or GM % m_size or m_size > _MAX_M:
        raise ValueError(f"mini_stats: groups2 {tuple(groups2.shape)} with M={m_size} "
                         f"(needs [B, G*M, 3], M <= {_MAX_M})")
    if (C1, C2) != _TC_WIDTHS[:2]:
        raise ValueError(f"mini_stats: takes PointBERT's widths {_TC_WIDTHS[:2]}, "
                         f"got {(C1, C2)}")
    code = _build.dtype_code("mini_stats", dtype)
    x = groups2.float().contiguous()
    w = [t.to(dtype).contiguous() for t in (fw1, fb1, w2, b2)]
    check_tma("mini_stats", w2=w[2])  # the bf16 kernel loads w2 by TMA
    _build.check_tensors("mini_stats", x, *w)
    n_groups = B * (GM // m_size)
    lib = _build.load("mini")
    lib.ppt_mini_stats_blocks.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ppt_mini_stats.argtypes = (
        [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 9
    )

    def f32(*shape):
        return torch.empty(*shape, dtype=torch.float32, device=x.device)

    part = f32(lib.ppt_mini_stats_blocks(code, n_groups), C2, C2)
    m2, sg, gmax = f32(C2, C2), f32(n_groups, C2), f32(n_groups, C2)
    rc = lib.ppt_mini_stats(code, _build.ptr(x), n_groups, m_size, C1, C2,
                            *[_build.ptr(t) for t in w], _build.ptr(part), _build.ptr(m2),
                            _build.ptr(sg), _build.ptr(gmax), _build.stream_ptr(x))
    _build.check(lib, rc, "mini_stats")
    _build.LAUNCHES["mini_stats"] += 1
    return m2, sg, gmax


def _mini_stats_cuda(m_size, dtype, groups2, fw1, fb1, w2, b2, wg, wl, bsplit):
    """``ppt::mini_stats`` on the card: the sweep, then its f32 epilogue."""
    m2, sg, gmax = mini_stats_sweep(m_size, dtype, groups2, fw1, fb1, w2, b2)
    return _stats_epilogue(m_size, m2, sg, gmax, wg, wl, bsplit)


def _mini_stats_fake(m_size, dtype, groups2, fw1, fb1, w2, b2, wg, wl, bsplit):
    H = wl.shape[1]
    return (groups2.new_empty(H, dtype=torch.float32), groups2.new_empty(H, dtype=torch.float32))


def _mini_stats_flops(m_size, dtype, groups2, fw1, fb1, w2, b2, wg, wl, bsplit) -> int:
    B, GM, C = groups2
    C1, C2 = fw1[1], w2[1]
    # the sweep: two products a point and the upper triangle of the symmetric
    # m2 = x2^T x2; the epilogue's f32 products are left out, as in the bound
    return 2 * B * GM * (C * C1 + C1 * C2) + B * GM * C2 * (C2 + 1)


_mini_stats_run = _ops.register(
    "mini_stats(int m_size, ScalarType dtype, Tensor groups2, Tensor fw1, Tensor fb1, "
    "Tensor w2, Tensor b2, Tensor wg, Tensor wl, Tensor bsplit) -> (Tensor, Tensor)",
    mini_stats_plain, _mini_stats_cuda, _mini_stats_fake, _mini_stats_flops)


def mini_stats(
    m_size: int, dtype: torch.dtype, groups2: torch.Tensor, fw1, fb1, w2, b2, wg, wl, bsplit,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum h, sum h^2) [H] f32 of the pre-BN2 activations over all
    B*G*M rows (BN1 folded into fw1/fb1; wg/wl/bsplit unfolded).
    Differentiable: the backward recomputes ``mini_stats_plain``."""
    return recompute_grad("mini_stats", _mini_stats_run, mini_stats_plain, m_size, dtype, groups2,
                          fw1, fb1, w2, b2, wg, wl, bsplit)
