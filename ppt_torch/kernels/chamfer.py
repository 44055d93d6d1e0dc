"""Nearest-neighbour squared distances for the Chamfer distance.

Replaces ``ppt_tpu/kernels/chamfer.py:chamfer_pallas`` (``_nn_dist_kernel``,
``_nn_dists``); the CUDA side is ``csrc/losses3d.cu``, whose header says
what bounds the kernel on the H100 and how its design answers that.

``nn_dists(q, x)[b, n]`` is the smallest ``((qx-xs)^2 + (qy-ys)^2) +
(qz-zs)^2`` over the support points of cloud ``b``, in f32: the
exact-difference form of the TPU kernel (``chamfer.py:52``), never the
``[B, N, M]`` matrix at once. Any B, N and M: the reference's ``N % 8``
is a TPU layout limit. ``chamfer`` is ``chamfer_pallas``'s counterpart,
with the gradient of the plain ``chamfer_l2`` recomputed, as
``_chamfer_bwd`` takes it.

No module calls ``chamfer``, here or in the reference: the dVAE's loss is
``ops.losses3d.chamfer_l1``, plain on every platform, and the reference's
``chamfer_pallas`` is reached only by its tests and
``tools/kernel_check.py``.
"""

from __future__ import annotations

import ctypes

import torch

from ppt_torch.kernels import _build
from ppt_torch.kernels._autograd import recompute_grad
from ppt_torch.ops.losses3d import chamfer_l2

_CHUNK_PAIRS = 1 << 25  # query-support pairs a chunk of the plain version holds at once


def nn_dists_plain(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: [B, N, 3] queries, [B, M, 3] support -> [B, N]
    f32 minimum squared distances, chunked over the queries so that a
    16k-point cloud needs no [B, N, M] tensor."""
    q, x = q.float(), x.float()
    B, N, _ = q.shape
    chunk = max(1, _CHUNK_PAIRS // max(B * x.shape[1], 1))
    out = []
    for s in range(0, N, chunk):
        qc = q[:, s:s + chunk, None, :]
        dx, dy, dz = (qc[..., i] - x[:, None, :, i] for i in range(3))
        out.append(((dx * dx + dy * dy) + dz * dz).amin(-1))
    return torch.cat(out, dim=1) if out else q.new_zeros(B, 0)


def chamfer_plain(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """Chamfer-L2 from :func:`nn_dists_plain`: mean of each direction's
    minima, summed. Scalar."""
    return nn_dists_plain(xyz1, xyz2).mean() + nn_dists_plain(xyz2, xyz1).mean()


def nn_dists(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[B, N] f32 minimum squared distance of each query to its cloud's
    support points: the kernel on the card, the plain version on the CPU."""
    if q.device.type == "cpu":
        return nn_dists_plain(q, x)
    B, N, C = q.shape
    if C != 3 or x.dim() != 3 or x.shape[0] != B or x.shape[2] != 3 or x.shape[1] < 1:
        raise ValueError(f"nn_dists: expects q [B, N, 3] and x [B, M>=1, 3], got "
                         f"{tuple(q.shape)} and {tuple(x.shape)}")
    q = q.detach().float().contiguous()
    x = x.detach().float().contiguous()
    _build.check_tensors("nn_dists", q, x)
    out = torch.empty(B, N, dtype=torch.float32, device=q.device)
    if B * N == 0:
        return out
    lib = _build.load("losses3d")
    lib.ppt_nn_dists.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.c_void_p]
    rc = lib.ppt_nn_dists(_build.ptr(q), _build.ptr(x), B, N, x.shape[1], _build.ptr(out),
                          _build.stream_ptr(q))
    _build.check(lib, rc, "nn_dists")
    _build.LAUNCHES["chamfer_nn_dists"] += 1
    return out


def _chamfer_run(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    return nn_dists(xyz1, xyz2).mean() + nn_dists(xyz2, xyz1).mean()


def chamfer(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """Chamfer-L2 through :func:`nn_dists`, both directions. Scalar.
    Differentiable: the backward recomputes the plain ``chamfer_l2``
    (``ops.losses3d``), whose gradient reaches each point's nearest
    neighbour only."""
    return recompute_grad(_chamfer_run, chamfer_l2, xyz1, xyz2)
