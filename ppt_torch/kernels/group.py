"""Grouping kernels: batched FPS, kNN with the neighbourhood gather, and
the ball queries of the set-abstraction towers.

Replaces ``ppt_tpu/kernels/group.py:fps_batched`` and ``:knn_gather``
(chained by ``:fused_group``), ``:ball_query_gather``,
``:ball_query_gather_feats`` and the rank formulation
``:_ball_query_kernel_v2``. The CUDA side is ``csrc/group.cu``, whose
header says what bounds each kernel on the H100 and how its design
answers that. ``ball_query_gather_v2`` computes ``ball_query_gather``'s
function, so it launches the same walk with the same plan; ``fps_launch``
is the FPS launcher that ``fps_batched`` and ``kernels/fps.py:fps_single``
share. Every entry point is a registered operator, ``torch.ops.ppt.<name>``
(``_ops.py``): the plain version on the CPU key, the launch on the CUDA key.

Contracts (exact, ties included):
- FPS starts at index 0, keeps a running min distance initialised to
  1e10 and takes the FIRST argmax;
- kNN extracts the k smallest exact-difference distances
  ``((qx-x)^2 + (qy-y)^2) + (qz-z)^2``, ties to the lowest index, nearest
  first. This is the kernel contract the reference runs on its chip
  (``group.py:194``), not the expanded-form ``ops.knn_point``.
- ball query keeps the first ``nsample`` indices, in ascending order, of
  the points with ``((qx-x)^2 + (qy-y)^2) + (qz-z)^2 <= f32(radius * radius)``
  (the reference kernel's test, ``group.py:642-643``; the product is a
  Python double rounded once to f32). A short row is padded with its first
  hit; a query with no hit gives ``N - 1`` everywhere, with that point's
  coordinates minus the centre. The CPU oracle ``ops.query_ball_point``
  tests the expanded-form distance instead: the two agree on any cloud
  whose distances keep clear of ``radius**2`` by more than f32 rounding.
  The reference's ``relative`` and ``mode`` options are not here: every
  caller asks for centre-relative coordinates, and the modes are three
  schedules of this one function.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ppt_torch.kernels import _build, _ops
from ppt_torch.kernels._autograd import recompute_grad

FPS_MAX_POINTS = 16384  # the cloud in shared memory (12 N bytes), 16 points a thread
CHUNK = 1024  # cloud points a kNN CTA stages at a time (double-buffered: 24 KB)
# the ball query's walk (csrc/ball_select.cuh): points a warp tests a round (4
# a lane), and the points a CTA stages at a time once the cloud is larger
# (double-buffered: 48 KB); a cloud of at most BALL_CHUNK points is staged whole
BALL_ROUND = 128
BALL_CHUNK = 2048
_BALL_WARPS = 8  # queries (warps) a block: ball_select.cuh's BALL_WARPS

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "ppt_fps": [_P] + [_I] * 3 + [_P] * 2,
    "ppt_knn": [_P] * 2 + [_I] * 5 + [_P] * 3,
    "ppt_ball_query": [_P] * 2 + [_I] * 4 + [_F] + [_I] * 2 + [_P] * 3,
    "ppt_ball_query_feats": [_P] * 3 + [_I] * 4 + [_F] + [_I] * 4 + [_P] * 4,
    "ppt_ball_launch_floor": [_I] * 6 + [_P],
}
_lib_typed = None


def _lib() -> ctypes.CDLL:
    """``csrc/group.cu``'s library, its entry points' argument types set
    once, when it is first loaded here."""
    global _lib_typed
    if _lib_typed is None:
        lib = _build.load("group")
        for name, types in _ARGTYPES.items():
            getattr(lib, name).argtypes = types
        _lib_typed = lib
    return _lib_typed


def _sq3(dx: torch.Tensor, dy: torch.Tensor, dz: torch.Tensor) -> torch.Tensor:
    # ((dx*dx + dy*dy) + dz*dz), each op rounded separately
    return (dx * dx + dy * dy) + dz * dz


def fps_plain(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Plain PyTorch FPS, [B, npoint] int32."""
    B, N, _ = xyz.shape
    xyz = xyz.float()
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    dist = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    out = torch.empty(B, npoint, dtype=torch.int32, device=xyz.device)
    far = torch.zeros(B, 1, dtype=torch.long, device=xyz.device)
    for i in range(npoint):
        out[:, i] = far[:, 0].to(torch.int32)
        c = torch.gather(xyz, 1, far[:, :, None].expand(-1, -1, 3))  # [B, 1, 3]
        d = _sq3(x - c[..., 0], y - c[..., 1], z - c[..., 2])
        dist = torch.minimum(dist, d)
        far = torch.argmax(dist, dim=-1, keepdim=True)  # first max
    return out


def fps_launch(name: str, xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """FPS indices [B, npoint] int32 from ``csrc/group.cu:ppt_fps`` (its warp
    rule picks the launch), counted under ``name``. Any float type, taken
    as f32; N up to ``FPS_MAX_POINTS``; any npoint: once every distinct
    point is picked, every running distance is 0 and each later step picks
    index 0, as in the plain version."""
    B, N, C = xyz.shape
    if C != 3:
        raise ValueError(f"{name}: expects xyz [B, N, 3], got {tuple(xyz.shape)}")
    if N > FPS_MAX_POINTS:
        raise ValueError(f"{name}: N={N} exceeds the kernel's cap of {FPS_MAX_POINTS} "
                         "points (1024 threads x 16 points a thread, the cloud in shared memory)")
    if N == 0 and npoint > 0:
        raise ValueError(f"{name}: an empty cloud has no first point to start from")
    xyz = xyz.float().contiguous()
    out = torch.empty(B, npoint, dtype=torch.int32, device=xyz.device)
    if B == 0 or npoint == 0:
        return out
    lib = _lib()
    rc = lib.ppt_fps(_build.ptr(xyz), B, N, npoint, _build.ptr(out), _build.stream_ptr(xyz))
    _build.check(lib, rc, name)
    _build.LAUNCHES[name] += 1
    return out


def _fps_batched_cuda(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """``ppt::fps_batched`` on the card: npoint up to N."""
    if npoint > xyz.shape[1]:
        raise ValueError(f"fps_batched: npoint={npoint} > N={xyz.shape[1]}")
    return fps_launch("fps_batched", xyz, npoint)


def _fps_fake(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    return xyz.new_empty(xyz.shape[0], npoint, dtype=torch.int32)


def _fps_flops(xyz_shape, npoint: int) -> int:
    B, N, _ = xyz_shape
    return 10 * B * npoint * N  # 3 sub, 3 mul, 2 add, min, compare a point a step


_ops.register("fps_batched(Tensor xyz, int npoint) -> Tensor", fps_plain, _fps_batched_cuda,
              _fps_fake, _fps_flops)


def fps_batched(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """FPS indices [B, npoint] int32 (start index 0 per cloud):
    ``torch.ops.ppt.fps_batched``, the kernel on the card, the plain version
    on the CPU. The kernel takes N up to ``FPS_MAX_POINTS``, and npoint up
    to N."""
    return torch.ops.ppt.fps_batched(xyz, npoint)


def knn_gather_plain(
    k: int, xyz: torch.Tensor, new_xyz: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch kNN + gather: (idx [B,S,k] int32, nbr - centre [B,S,k,3] f32)."""
    xyz = xyz.float()
    q = new_xyz.float()
    d = _sq3(
        q[:, :, None, 0] - xyz[:, None, :, 0],
        q[:, :, None, 1] - xyz[:, None, :, 1],
        q[:, :, None, 2] - xyz[:, None, :, 2],
    )  # [B, S, N]
    # a stable ascending sort ranks ties by index: the k min-extractions
    idx = torch.sort(d, dim=-1, stable=True).indices[..., :k]
    B, S = idx.shape[:2]
    nbr = torch.gather(xyz, 1, idx.reshape(B, S * k, 1).expand(-1, -1, 3)).reshape(B, S, k, 3)
    return idx.to(torch.int32), nbr - q[:, :, None, :]


def _knn_gather_cuda(
    k: int, xyz: torch.Tensor, new_xyz: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ppt::knn_gather`` on the card."""
    B, N, C = xyz.shape
    if C != 3 or new_xyz.dim() != 3 or new_xyz.shape[0] != B or new_xyz.shape[2] != 3:
        raise ValueError(f"knn_gather: expects xyz [B, N, 3] and queries [B, S, 3], got "
                         f"{tuple(xyz.shape)} and {tuple(new_xyz.shape)}")
    if not 1 <= k <= N:
        raise ValueError(f"knn_gather: k={k} must lie in [1, N={N}]")
    S = new_xyz.shape[1]
    xyz = xyz.float().contiguous()
    q = new_xyz.float().contiguous()
    _build.check_tensors("knn_gather", xyz, q)
    idx = torch.empty(B, S, k, dtype=torch.int32, device=xyz.device)
    nbr = torch.empty(B, S, k, 3, dtype=torch.float32, device=xyz.device)
    if B == 0 or S == 0:
        return idx, nbr
    lib = _lib()
    rc = lib.ppt_knn(_build.ptr(xyz), _build.ptr(q), B, N, S, k, CHUNK, _build.ptr(idx),
                     _build.ptr(nbr), _build.stream_ptr(xyz))
    _build.check(lib, rc, "knn_gather")
    _build.LAUNCHES["knn_gather"] += 1
    return idx, nbr


def _knn_fake(k: int, xyz: torch.Tensor, new_xyz: torch.Tensor):
    B, S = new_xyz.shape[:2]
    return (new_xyz.new_empty(B, S, k, dtype=torch.int32),
            new_xyz.new_empty(B, S, k, 3, dtype=torch.float32))


def _knn_flops(k: int, xyz_shape, q_shape) -> int:
    B, N, _ = xyz_shape
    return 9 * B * q_shape[1] * N  # the distance (8) and one comparison a candidate


_ops.register("knn_gather(int k, Tensor xyz, Tensor new_xyz) -> (Tensor, Tensor)",
              knn_gather_plain, _knn_gather_cuda, _knn_fake, _knn_flops)


def knn_gather(
    k: int, xyz: torch.Tensor, new_xyz: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN + centre-relative neighbour coordinates in one kernel
    (``torch.ops.ppt.knn_gather``): (idx [B, S, k] int32, neighbourhood -
    centre [B, S, k, 3] f32). Any S, any N, any k in [1, N]."""
    return torch.ops.ppt.knn_gather(k, xyz, new_xyz)


def _ball_picks(radius: float, nsample: int, xyz: torch.Tensor,
                new_xyz: torch.Tensor) -> torch.Tensor:
    """The ball query's indices [B, S, nsample] int64, by ranks: a hit's
    inclusive prefix count is its slot + 1."""
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    d = _sq3(
        new_xyz[:, :, None, 0] - xyz[:, None, :, 0],
        new_xyz[:, :, None, 1] - xyz[:, None, :, 1],
        new_xyz[:, :, None, 2] - xyz[:, None, :, 2],
    )  # [B, S, N]
    hit = d <= torch.tensor(radius * radius, dtype=torch.float32, device=xyz.device)
    rank = torch.cumsum(hit, dim=-1)
    count = rank[..., -1:]
    # each hit of rank <= nsample lands in slot rank - 1; the rest in a spare slot
    slot = torch.where(hit & (rank <= nsample), rank - 1, nsample)
    lane = torch.arange(N, device=xyz.device).expand(B, S, N)
    picks = torch.full((B, S, nsample + 1), N - 1, dtype=torch.long, device=xyz.device)
    picks.scatter_(2, slot, lane)
    picks = picks[..., :nsample]
    first = torch.where(count > 0, picks[..., :1], N - 1)
    return torch.where(torch.arange(nsample, device=xyz.device) < count, picks, first)


def _gather_rows(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[b, s, k, :] = points[b, idx[b, s, k], :]``."""
    B, S, K = idx.shape
    C = points.shape[-1]
    flat = idx.reshape(B, S * K, 1).long().expand(-1, -1, C)
    return torch.gather(points, 1, flat).reshape(B, S, K, C)


def ball_query_gather_plain(
    radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch ball query + coordinate gather:
    (idx [B,S,nsample] int32, picks - centre [B,S,nsample,3] f32)."""
    xyz = xyz.float()
    q = new_xyz.float()
    picks = _ball_picks(radius, nsample, xyz, q)
    return picks.to(torch.int32), _gather_rows(xyz, picks) - q[:, :, None, :]


def ball_query_gather_feats_plain(
    radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor, feats: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch ball query + coordinate gather + feature gather:
    (idx, picks - centre, feats[picks] [B,S,nsample,F] in ``feats``' dtype)."""
    idx, rel = ball_query_gather_plain(radius, nsample, xyz, new_xyz)
    return idx, rel, _gather_rows(feats, idx)


def _ball_plan(B: int, S: int) -> Tuple[int, int]:
    """(queries a warp takes in turn, points a stage) for a ball query of B
    clouds x S centres: 4 queries a warp (a CTA stages its cloud once for
    32 of them) while that leaves at least 2 CTAs an SM of an H100's 132
    in the grid, else 2, else 1."""
    qw = 4
    while qw > 1 and B * -(-S // (qw * _BALL_WARPS)) < 2 * 132:
        qw //= 2
    return qw, BALL_CHUNK


def _ball_args(name: str, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor):
    B, N, C = xyz.shape
    if C != 3 or new_xyz.shape[0] != B or new_xyz.shape[2] != 3:
        raise ValueError(f"{name}: expects xyz [B, N, 3] and centres [B, S, 3], got "
                         f"{tuple(xyz.shape)} and {tuple(new_xyz.shape)}")
    if not 1 <= nsample <= N:
        raise ValueError(f"{name}: nsample={nsample} not in [1, N={N}]")
    xyz = xyz.float().contiguous()
    q = new_xyz.float().contiguous()
    _build.check_tensors(name, xyz, q)
    S = q.shape[1]
    idx = torch.empty(B, S, nsample, dtype=torch.int32, device=xyz.device)
    rel = torch.empty(B, S, nsample, 3, dtype=torch.float32, device=xyz.device)
    return xyz, q, B, N, S, idx, rel


def _ball_run(name: str, radius: float, nsample: int, xyz: torch.Tensor,
              new_xyz: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``csrc/group.cu:ppt_ball_query`` (``ball_select.cuh``'s walk) with
    ``_ball_plan``'s plan, counted under ``name``."""
    xyz, q, B, N, S, idx, rel = _ball_args(name, nsample, xyz, new_xyz)
    if B == 0 or S == 0:
        return idx, rel
    lib = _lib()
    rc = lib.ppt_ball_query(_build.ptr(xyz), _build.ptr(q), B, N, S, nsample, radius * radius,
                            *_ball_plan(B, S), _build.ptr(idx), _build.ptr(rel),
                            _build.stream_ptr(xyz))
    _build.check(lib, rc, name)
    _build.LAUNCHES[name] += 1
    return idx, rel


def _ball_feats_run(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor,
                    feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``ppt::ball_query_gather_feats`` on the card."""
    name = "ball_query_gather_feats"
    xyz, q, B, N, S, idx, rel = _ball_args(name, nsample, xyz, new_xyz)
    if feats.dim() != 3 or feats.shape[:2] != (B, N):
        raise ValueError(f"{name}: feats {tuple(feats.shape)} is not [B={B}, N={N}, F]")
    if feats.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"{name}: feats dtype {feats.dtype} not in (float32, bfloat16)")
    feats = feats.detach().contiguous()
    _build.check_tensors(name, xyz, feats)
    fj = torch.empty(B, S, nsample, feats.shape[2], dtype=feats.dtype, device=xyz.device)
    if B == 0 or S == 0:
        return idx, rel, fj
    row_bytes = feats.shape[2] * feats.element_size()
    # the widest copy unit that divides a row and keeps both pointers aligned
    unit = next(u for u in (16, 4, 2)
                if row_bytes % u == 0 and feats.data_ptr() % u == 0 and fj.data_ptr() % u == 0)
    lib = _lib()
    rc = lib.ppt_ball_query_feats(_build.ptr(xyz), _build.ptr(q), _build.ptr(feats), B, N, S,
                                  nsample, radius * radius, row_bytes, unit, *_ball_plan(B, S),
                                  _build.ptr(idx), _build.ptr(rel), _build.ptr(fj),
                                  _build.stream_ptr(xyz))
    _build.check(lib, rc, name)
    _build.LAUNCHES[name] += 1
    return idx, rel, fj


def _ball_fake(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor):
    B, S = new_xyz.shape[:2]
    return (new_xyz.new_empty(B, S, nsample, dtype=torch.int32),
            new_xyz.new_empty(B, S, nsample, 3, dtype=torch.float32))


def _ball_feats_fake(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor,
                     feats: torch.Tensor):
    B, S = new_xyz.shape[:2]
    return (*_ball_fake(radius, nsample, xyz, new_xyz),
            feats.new_empty(B, S, nsample, feats.shape[2]))


def _ball_flops(radius: float, nsample: int, xyz_shape, q_shape, *feats_shape) -> int:
    """The walk's work, as ``PERF.md`` §6 bounds rows 12-14: 9 operations
    (the distance and its test) for every point a centre looks at; the
    gathers move bytes."""
    B, N, _ = xyz_shape
    return 9 * B * q_shape[1] * N


def _ball_cuda(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor):
    """``ppt::ball_query_gather`` on the card."""
    return _ball_run("ball_query_gather", radius, nsample, xyz, new_xyz)


def _ball_v2_cuda(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor):
    """``ppt::ball_query_gather_v2`` on the card: the same walk and plan."""
    return _ball_run("ball_query_gather_v2", radius, nsample, xyz, new_xyz)


_BALL = "(float radius, int nsample, Tensor xyz, Tensor new_xyz"
_ball_op = _ops.register(f"ball_query_gather{_BALL}) -> (Tensor, Tensor)",
                         ball_query_gather_plain, _ball_cuda, _ball_fake, _ball_flops)
_ball_v2_op = _ops.register(f"ball_query_gather_v2{_BALL}) -> (Tensor, Tensor)",
                            ball_query_gather_plain, _ball_v2_cuda, _ball_fake, _ball_flops)
_ball_feats_op = _ops.register(
    f"ball_query_gather_feats{_BALL}, Tensor feats) -> (Tensor, Tensor, Tensor)",
    ball_query_gather_feats_plain, _ball_feats_run, _ball_feats_fake, _ball_flops)


def ball_query_gather(
    radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ball query + centre-relative coordinates in one kernel
    (``torch.ops.ppt.ball_query_gather``): (idx [B, S, nsample] int32,
    picks - centre [B, S, nsample, 3] f32). Any N, any S. No gradient."""
    return _ball_op(radius, nsample, xyz.detach(), new_xyz.detach())


def ball_query_gather_v2(
    radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The counterpart of the reference's rank formulation
    (``_ball_query_kernel_v2``: a hit's prefix count is its slot), which
    computes ``ball_query_gather``'s function: the same outputs, bit for
    bit, from the same walk and plan, counted apart
    (``torch.ops.ppt.ball_query_gather_v2``). Any N, any S. No module calls
    it (nor does the reference call its own)."""
    return _ball_v2_op(radius, nsample, xyz.detach(), new_xyz.detach())


def ball_query_gather_feats(
    radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor, feats: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ball query + centre-relative coordinates + the picks' feature rows in
    one kernel (``torch.ops.ppt.ball_query_gather_feats``): (idx [B, S,
    nsample] int32, picks - centre [B, S, nsample, 3] f32, feats[picks] [B,
    S, nsample, F] in ``feats``' dtype, f32 or bf16). ``fj`` carries a
    gradient to ``feats`` (the plain gather's, by ``recompute_grad``); the
    indices and the coordinates carry none."""
    xyz, new_xyz = xyz.detach(), new_xyz.detach()
    if not (feats.requires_grad and torch.is_grad_enabled()):
        return _ball_feats_op(radius, nsample, xyz, new_xyz, feats)
    kept = {}

    def forward(f):
        kept["idx"], kept["rel"], fj = _ball_feats_op(radius, nsample, xyz, new_xyz, f)
        return fj

    fj = recompute_grad("ball_query_gather_feats", forward,
                        lambda f: _gather_rows(f, kept["idx"]), feats)
    return kept["idx"], kept["rel"], fj


def fused_group(
    xyz: torch.Tensor, num_group: int, group_size: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group divider: (neighbourhood - center [B, G, M, 3], center [B, G, 3])."""
    xyz = xyz.detach()
    idx = fps_batched(xyz, num_group)
    center = torch.gather(xyz, 1, idx.long()[:, :, None].expand(-1, -1, 3))
    _, neighborhood = knn_gather(group_size, xyz, center)
    return neighborhood.to(xyz.dtype), center
