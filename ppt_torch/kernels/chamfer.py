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
``_chamfer_bwd`` takes it; its two directions go to the card in one
launch.

No module calls ``chamfer``, here or in the reference: the dVAE's loss is
``ops.losses3d.chamfer_l1``, plain on every platform, and the reference's
``chamfer_pallas`` is reached only by its tests and
``tools/kernel_check.py``.
"""

from __future__ import annotations

import torch

from ppt_torch.kernels import _build, _losses3d
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


# the kernel's blocking (``csrc/losses3d.cu``: its instances, kNnThreads,
# kNnMaxSplit)
QUERIES = (4, 2, 1)  # queries a thread, in registers: the instances, most first
THREADS = 128  # threads a block
MAX_SPLIT = 8  # support chunks a query block's cluster takes, at most
MIN_CHUNK = 64  # support points a split CTA scans, at least
TARGET_CTAS = 4 * 132  # four CTAs on each of the H100's 132 SMs


def nn_blocks(B: int, N: int, queries: int) -> int:
    """Query blocks of one direction: ``queries`` queries of one cloud a
    thread, ``THREADS`` threads a block, the clouds' query groups flattened."""
    return -(-B * -(-N // queries) // THREADS)


def nn_plan(shapes):
    """(queries a thread, support split) of one launch over ``shapes``
    [(B, N, M), ...] (one direction, or both): the most queries a thread of
    ``QUERIES`` whose grid reaches ``TARGET_CTAS`` CTAs, splitting the
    support set when the query blocks alone do not, into as many chunks as
    keep ``MIN_CHUNK`` points of every direction's cloud each (at most
    ``MAX_SPLIT``); one query a thread when no grid reaches the target.
    Chosen from a sweep of every (queries, split) on the H100 at the
    dVAE's, kernel_check's and larger shapes (``chip_smoke.py --only
    losses3d`` runs it)."""
    shapes = [(B, N, M) for B, N, M in shapes if B * N > 0]
    most = MAX_SPLIT
    while most > 1 and any(M < most * MIN_CHUNK for _, _, M in shapes):
        most //= 2
    for queries in QUERIES:
        blocks = sum(nn_blocks(B, N, queries) for B, N, _ in shapes)
        split = 1 if blocks >= TARGET_CTAS else most
        if blocks * split >= TARGET_CTAS:
            break
    return queries, split


def _checked(q: torch.Tensor, x: torch.Tensor):
    B, N, C = q.shape
    if C != 3 or x.dim() != 3 or x.shape[0] != B or x.shape[2] != 3 or x.shape[1] < 1:
        raise ValueError(f"nn_dists: expects q [B, N, 3] and x [B, M>=1, 3], got "
                         f"{tuple(q.shape)} and {tuple(x.shape)}")
    return q.detach().float().contiguous(), x.detach().float().contiguous()


def _nn_run(pairs):
    """One launch for one or two directions ``[(q, x), ...]`` -> their
    minima."""
    pairs = [_checked(q, x) for q, x in pairs]
    _build.check_tensors("nn_dists", *(t for pair in pairs for t in pair))
    outs = [torch.empty(q.shape[:2], dtype=torch.float32, device=q.device) for q, _ in pairs]
    shapes = [(q.shape[0], q.shape[1], x.shape[1]) for q, x in pairs]
    if all(B * N == 0 for B, N, _ in shapes):
        return outs
    args = []
    for (q, x), out, shape in zip(pairs, outs, shapes):
        args += [_build.ptr(q), _build.ptr(x), _build.ptr(out), *shape]
    if len(pairs) == 1:
        args += [None, None, None, 0, 0, 1]
    lib = _losses3d.lib()
    rc = lib.ppt_nn_dists(*args, *nn_plan(shapes), _build.stream_ptr(pairs[0][0]))
    _build.check(lib, rc, "nn_dists")
    _build.LAUNCHES["chamfer_nn_dists"] += 1
    return outs


def nn_dists(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[B, N] f32 minimum squared distance of each query to its cloud's
    support points: the kernel on the card, the plain version on the CPU."""
    if q.device.type == "cpu":
        return nn_dists_plain(q, x)
    return _nn_run([(q, x)])[0]


def nn_dists_both(a: torch.Tensor, b: torch.Tensor):
    """``(nn_dists(a, b), nn_dists(b, a))``, on the card in one launch."""
    if a.device.type == "cpu":
        return nn_dists_plain(a, b), nn_dists_plain(b, a)
    return tuple(_nn_run([(a, b), (b, a)]))


def _chamfer_run(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    d1, d2 = nn_dists_both(xyz1, xyz2)
    return d1.mean() + d2.mean()


def chamfer(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """Chamfer-L2 through :func:`nn_dists_both`, both directions in one
    launch. Scalar. Differentiable: the backward recomputes the plain
    ``chamfer_l2`` (``ops.losses3d``), whose gradient reaches each point's
    nearest neighbour only."""
    return recompute_grad("chamfer_nn_dists", _chamfer_run, chamfer_l2, xyz1, xyz2)
