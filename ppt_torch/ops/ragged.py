"""Offset-based (packed) point ops: clouds of any sizes in one ``[total, C]``
array, cloud ``i`` ending at ``offsets[i]`` (the ``pointops`` convention).

Counterpart of ``ppt_tpu/ops/ragged.py``, the plain PyTorch specification
of its contracts. The reference masks one ``[total, total]`` distance
matrix with +inf across clouds; here each cloud's block of the same
expanded-form distance ``|q|^2 + |p|^2 - 2 q.p`` is computed on its own
(one batched product when every cloud has the same size), so the
candidates, their order and the ties are the reference's while the memory
drops by a factor of the cloud count (4.3 GB a call at 8 x 4096 points).

``offsets`` is a tensor or a sequence of ints; a caller that knows its
sizes (``nn/pointtransformer.py``) passes ints, so no call reads a tensor
back from the card. FPS goes through ``kernels/group.py:fps_batched``: one
launch on the ``[B, n, 3]`` view when every cloud holds ``n`` points, one
a cloud otherwise; each cloud starts at its first point and takes the
first argmax, as the reference's packed loop does.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch

from ppt_torch.kernels import group as kgroup
from ppt_torch.ops.geometry import nearest_first

Offsets = Union[torch.Tensor, Sequence[int]]


def bounds(offsets: Offsets) -> List[Tuple[int, int]]:
    """(start, end) of every cloud."""
    ends = offsets.tolist() if isinstance(offsets, torch.Tensor) else [int(e) for e in offsets]
    return list(zip([0] + ends[:-1], ends))


def _equal(spans: List[Tuple[int, int]]) -> int:
    """The common cloud size, or 0 when the sizes differ."""
    sizes = {e - s for s, e in spans}
    return sizes.pop() if len(sizes) == 1 else 0


def segment_ids_from_offsets(offsets: Offsets, total: int) -> torch.Tensor:
    """The cloud of every packed point, ``[total]`` int32: the number of
    offsets at or below its index."""
    ends = torch.as_tensor(offsets if isinstance(offsets, torch.Tensor) else list(offsets))
    idx = torch.arange(total, device=ends.device, dtype=ends.dtype)
    return torch.searchsorted(ends, idx, right=True).to(torch.int32)


def _sqdist(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``[..., Q, P]`` expanded-form squared distances, as the reference's
    ``_masked_sqdist`` forms them: ``(|q|^2 + |p|^2) - 2 q.p``."""
    cross = q @ p.transpose(-1, -2)
    return ((q * q).sum(-1)[..., :, None] + (p * p).sum(-1)[..., None, :]) - 2.0 * cross


def _blocks(points: torch.Tensor, offsets: Offsets, queries: torch.Tensor,
            query_offsets: Offsets):
    """Per cloud: (query rows, its points' start, their distances ``[Q_b, n_b]``);
    one batched product when every cloud and every query set has one size."""
    p_spans, q_spans = bounds(offsets), bounds(query_offsets)
    if len(p_spans) != len(q_spans):
        raise ValueError(f"{len(p_spans)} point clouds but {len(q_spans)} query clouds")
    p, q = points.float(), queries.float()
    n, m = _equal(p_spans), _equal(q_spans)
    if n and m:
        B = len(p_spans)
        d = _sqdist(q.reshape(B, m, 3), p.reshape(B, n, 3))
        return [(slice(qs, qe), ps, d[b]) for b, ((qs, qe), (ps, _)) in
                enumerate(zip(q_spans, p_spans))]
    return [(slice(qs, qe), ps, _sqdist(q[qs:qe], p[ps:pe]))
            for (qs, qe), (ps, pe) in zip(q_spans, p_spans)]


def knn_query_packed(nsample: int, points: torch.Tensor, offsets: Offsets,
                     queries: torch.Tensor, query_offsets: Offsets
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN within each cloud (``pointops.knnquery``): (idx ``[Q, nsample]``
    int32 into the packed array, nearest first, ties to the lower index;
    squared distances clamped at 0). A cloud of fewer than ``nsample``
    points is padded as the reference's masked top-k pads it: the lowest
    indices outside the cloud, at distance +inf."""
    total, Q = points.shape[0], queries.shape[0]
    idx = torch.empty(Q, nsample, dtype=torch.long, device=points.device)
    dist = torch.empty(Q, nsample, dtype=torch.float32, device=points.device)
    for rows, start, d in _blocks(points, offsets, queries, query_offsets):
        k = min(nsample, d.shape[1])
        vals, order = nearest_first(d, k)
        idx[rows, :k], dist[rows, :k] = order + start, vals
        if k < nsample:  # the masked matrix's +inf columns, lowest index first
            outside = torch.cat([torch.arange(0, start), torch.arange(start + d.shape[1], total)])
            idx[rows, k:] = outside[:nsample - k].to(points.device)
            dist[rows, k:] = float("inf")
    return idx.to(torch.int32), torch.clamp_min(dist, 0.0)


def farthest_point_sample_packed(points: torch.Tensor, offsets: Offsets,
                                 npoint_per_cloud: int) -> torch.Tensor:
    """FPS per cloud (``pointops.furthestsampling``): ``[B, npoint_per_cloud]``
    int32 indices into the packed array, each cloud starting at its first
    point; through ``fps_batched`` (the kernel on the card)."""
    spans = bounds(offsets)
    starts = torch.tensor([s for s, _ in spans], dtype=torch.int32, device=points.device)
    n = _equal(spans)
    if n:
        local = kgroup.fps_batched(points.reshape(len(spans), n, -1), npoint_per_cloud)
    else:
        local = torch.cat([kgroup.fps_batched(points[s:e][None], npoint_per_cloud)
                           for s, e in spans])
    return local + starts[:, None]


def ball_query_packed(radius: float, nsample: int, points: torch.Tensor, offsets: Offsets,
                      queries: torch.Tensor, query_offsets: Offsets) -> torch.Tensor:
    """Radius query within each cloud: the first ``nsample`` in-radius
    indices in increasing order, padded with the first hit; a query with no
    hit gives its own cloud's last index (``ppt_tpu/ops/ragged.py:121-154``).
    The radius is squared in f32, as the reference squares its traced
    radius."""
    total, Q = points.shape[0], queries.shape[0]
    r = torch.tensor(radius, dtype=torch.float32)
    r2 = (r * r).to(points.device)
    idx = torch.full((Q, nsample), total, dtype=torch.long, device=points.device)
    for rows, start, d in _blocks(points, offsets, queries, query_offsets):
        n = d.shape[1]
        cols = torch.arange(start, start + n, device=points.device)
        masked = torch.where(d <= r2, cols, total)
        k = min(nsample, n)
        picked = torch.sort(masked, dim=-1).values[:, :k]
        picked = torch.where(picked == total, picked[:, :1], picked)
        idx[rows, :k] = picked
        idx[rows, k:] = picked[:, :1]
        idx[rows] = torch.clamp_max(idx[rows], start + n - 1)
    return idx.to(torch.int32)


def grouping_packed(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather packed features by neighbour index (``pointops.grouping``);
    its gradient is autograd's scatter-add."""
    return features[idx.long()]


def interpolation_packed(src_xyz: torch.Tensor, src_offsets: Offsets, dst_xyz: torch.Tensor,
                         dst_offsets: Offsets, src_feats: torch.Tensor) -> torch.Tensor:
    """3-NN inverse-distance interpolation over packed clouds
    (``pointops.interpolation``), in ``src_feats``' dtype: the weights are
    ``1 / (sqrt(d) + 1e-8)`` over EUCLIDEAN distances (the squared ones
    clamped at 0), normalised over the three, unlike
    ``ops/geometry.py:three_interpolate``'s ``1 / d^2``."""
    idx, d = knn_query_packed(3, src_xyz, src_offsets, dst_xyz, dst_offsets)
    recip = 1.0 / (torch.sqrt(d) + 1e-8)
    w = recip / recip.sum(-1, keepdim=True)
    return (src_feats[idx.long()] * w[..., None]).sum(1).to(src_feats.dtype)


def subtraction_packed(feats_q: torch.Tensor, feats_k: torch.Tensor,
                       idx: torch.Tensor) -> torch.Tensor:
    """``out[q, j] = feats_q[q] - feats_k[idx[q, j]]`` (``pointops.subtraction``)."""
    return feats_q[:, None, :] - feats_k[idx.long()]


def aggregation_packed(values: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted neighbour sum ``[Q, C]`` (``pointops.aggregation``)."""
    return (values * weights).sum(1)
