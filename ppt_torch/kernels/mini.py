"""Fused MiniPointNet forward with both BatchNorms folded (eval mode).

Replaces ``ppt_tpu/kernels/mini.py:mini_forward`` (``_forward_kernel``);
the CUDA side is ``csrc/mini.cu``, whose header says what bounds it on
the H100 and how its design answers that. The train-mode statistics
kernel (``mini_stats``) belongs to the training slice.

Chain per group of M points (``mini.py:148-175``), in the compute dtype
with f32 accumulation, rounding after every dot product and after every
bias add::

    x1 = relu(x @ fw1 + fb1)           x2 = x1 @ w2 + b2
    g  = max_M x2                      h  = relu(x2 @ fwl + g @ fwg + fbs)
    out = max_M (h @ w3 + b3)          -> [B, G, CO]
"""

from __future__ import annotations

import ctypes

import torch

from ppt_torch.kernels import _build

_MAX_M = 32
_TC_WIDTHS = (128, 256, 512, 256)  # C1, C2, H, CO of the bf16 tensor-core kernel


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
    x1 = torch.clamp_min(_mm(x, fw1, dtype) + bias(fb1), 0)
    x2 = _mm(x1, w2, dtype) + bias(b2)  # [B, GM, C2]
    x2g = x2.reshape(B, G, m_size, -1)
    g = x2g.amax(dim=2)  # [B, G, C2]
    gh = _mm(g, fwg, dtype)  # [B, G, H]
    x2h = _mm(x2g, fwl, dtype)  # [B, G, M, H]
    h = torch.clamp_min(x2h + gh[:, :, None, :] + bias(fbsplit), 0)
    y = _mm(h, w3, dtype) + bias(b3)
    return y.amax(dim=2)


def mini_forward(
    m_size: int, dtype: torch.dtype, groups2: torch.Tensor, fw1, fb1, w2, b2, fwg, fwl,
    fbsplit, w3, b3,
) -> torch.Tensor:
    """Fused MiniPointNet tokens [B, G, CO] in ``dtype`` (BNs pre-folded).

    groups2: [B, G*M, 3] f32; weights [in, out] and biases in any float
    type (rounded to ``dtype`` as the TPU kernel does)."""
    args = (fw1, fb1, w2, b2, fwg, fwl, fbsplit, w3, b3)
    if groups2.device.type == "cpu":
        return mini_forward_plain(m_size, dtype, groups2, *args)
    B, GM, C = groups2.shape
    C1, C2, H, CO = fw1.shape[1], w2.shape[1], fwl.shape[1], w3.shape[1]
    if C != 3 or GM % m_size or m_size > _MAX_M:
        raise ValueError(f"mini_forward: groups2 {tuple(groups2.shape)} with M={m_size} "
                         f"(needs [B, G*M, 3], M <= {_MAX_M})")
    if dtype == torch.bfloat16 and (C1, C2, H, CO) != _TC_WIDTHS:
        raise ValueError(f"mini_forward: bf16 takes PointBERT's widths {_TC_WIDTHS}, "
                         f"got {(C1, C2, H, CO)}")
    if any(c % 4 for c in (C1, C2, H)) or CO > 256:
        raise ValueError(f"mini_forward: widths C1={C1} C2={C2} H={H} must be multiples "
                         f"of 4 and CO={CO} <= 256")
    code = _build.dtype_code("mini_forward", dtype)
    x = groups2.float().contiguous()
    w = [t.to(dtype).contiguous() for t in args]
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
