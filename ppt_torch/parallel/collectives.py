"""Collectives that autograd sees, the data-parallel context, and the
gradient bucket.

What GSPMD inserts by itself in the reference (``ppt_tpu/parallel/mesh.py``:
the psum of the gradients, the all-gather of the contrastive loss, the
global BatchNorm statistics) is written out here over ``torch.distributed``.

Gradient convention. Every rank holds its own copy of every tensor and
runs its own loss; each collective is differentiable with its true adjoint
(the adjoint of an all-reduce sum is an all-reduce sum, of an all-gather a
reduce-scatter, of a broadcast a reduce to its source: the pairs of
``torch.distributed.nn.functional``, written here as autograd functions
that stage gloo's host copies inside themselves). Autograd on one
rank then gives the derivative of the SUM of all ranks' losses with respect
to that rank's copies. A tensor that several ranks hold (replicated, or one
tensor-parallel shard held by every data or pipe rank) gets the sum of
those ranks' partial gradients, divided by the world size: the ranks that
share a batch shard (tensor- and pipe-parallel ranks) all run the same
loss, and the data ranks' losses are means over equal shards, so that is
the gradient of the global mean loss. ``reduce_gradients`` does it in one
flat f32 bucket per group: SUM, then divide (gloo has no ``AVG``).

The data-parallel context (``data_parallel``) tells the modules the step's
data group while they run: a BatchNorm in training then all-reduces its
sums over it (sync-BN, as flax's BatchNorm under ``jit`` takes global
statistics), and every draw of a step (DropPath scales, dropout masks,
Gumbel noise, group masks) is taken at the GLOBAL batch from the replicated
generator, each rank keeping its own rows, so that dp = W draws what one
process draws. Outside the context every module runs as in one process.

Transport. gloo carries host tensors; a CUDA tensor given to a gloo group
(ranks that share one card) is copied through host memory, differentiably.
NCCL groups take device tensors as they are.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist


def backend_of(group) -> str:
    return str(dist.get_backend(group)).lower()


def via_host(t: torch.Tensor, group) -> bool:
    """True when ``t`` must go through host memory to reach ``group``: a
    CUDA tensor on a gloo group."""
    return t.is_cuda and backend_of(group) == "gloo"


class _AllReduceSum(torch.autograd.Function):
    """All-reduce SUM whose adjoint is the all-reduce SUM of the gradients
    (``torch.distributed.nn.functional.all_reduce``'s pair). The host copy
    for gloo happens inside, so the node stays on the tensor's device: every
    rank's autograd engine then meets the collectives of a backward in one
    order, on one device queue."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _AllGather(torch.autograd.Function):
    """All-gather concatenated along ``dim``; its adjoint keeps this rank's
    slice of the gradients summed over the group (a reduce-scatter, as
    ``torch.distributed.nn.functional.all_gather``'s, written as an
    all-reduce, which gloo also carries)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        ctx.rank, ctx.n = dist.get_rank(group), x.shape[dim]
        src = x.detach().contiguous()
        host = via_host(src, group)
        if host:
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, src, group=group)
        return torch.cat(parts, dim=dim).to(x.device)

    @staticmethod
    def backward(ctx, g):
        total = all_reduce_(g.contiguous().clone(), ctx.group)
        return total.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-reduce SUM over ``group``."""
    return _AllReduceSum.apply(t, group)


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Differentiable all-gather over ``group``, concatenated along ``dim``
    in group-rank order."""
    return _AllGather.apply(t, group, dim)


@torch.no_grad()
def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place all-reduce SUM of ``t`` over ``group``, outside autograd."""
    if via_host(t, group):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


@torch.no_grad()
def broadcast_(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """In-place broadcast of ``t`` from global rank ``src``, outside autograd."""
    if via_host(t, group):
        host = t.cpu()
        dist.broadcast(host, src, group=group)
        t.copy_(host)
    else:
        dist.broadcast(t, src, group=group)
    return t


# ---------------------------------------------------------------------------
# The data-parallel context
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """The data axis of a step: its process group, this rank's index on it
    and its size."""

    group: object
    rank: int
    size: int


_ACTIVE: Optional[DataGroup] = None


def active() -> Optional[DataGroup]:
    """The data group of the step that is running, or None outside one."""
    return _ACTIVE


@contextlib.contextmanager
def data_parallel(group) -> Iterator[Optional[DataGroup]]:
    """Run the block with ``group`` (a process group, or None for none) as
    the data axis; contexts do not nest."""
    global _ACTIVE
    if group is None:
        yield None
        return
    if _ACTIVE is not None:
        raise RuntimeError("data_parallel: a data-parallel context is already active")
    _ACTIVE = DataGroup(group, dist.get_rank(group), dist.get_world_size(group))
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = None


def sync_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the active data group (differentiably); ``t``
    itself outside a data-parallel step."""
    dp = _ACTIVE
    return t if dp is None else all_reduce_sum(t, dp.group)


def sync_count(n: int) -> int:
    """The global count of ``n`` local rows."""
    dp = _ACTIVE
    return n if dp is None else n * dp.size


def global_draw(draw, shape: Sequence[int], dim: int = 0, **kw) -> torch.Tensor:
    """``draw(shape, **kw)`` (``torch.rand``, ``torch.randn``, ...) as one
    process draws it: inside a data-parallel step at the global batch
    (``shape[dim]`` times the data size) and narrowed to this rank's rows,
    so the generator advances as in one process and each rank keeps its own
    slice of the same numbers."""
    dp = _ACTIVE
    if dp is None:
        return draw(tuple(shape), **kw)
    full = list(shape)
    n = full[dim]
    full[dim] = n * dp.size
    return draw(tuple(full), **kw).narrow(dim, dp.rank * n, n)


def global_mean(t: torch.Tensor, group) -> torch.Tensor:
    """The mean over ``group`` of a 0-dim metric (each rank's mean over an
    equal shard), outside autograd; ``t`` itself without a group."""
    if group is None:
        return t
    out = t.detach().clone().float()
    all_reduce_(out, group)
    return out / dist.get_world_size(group)


# ---------------------------------------------------------------------------
# The gradient bucket
# ---------------------------------------------------------------------------


ALONE = "alone"  # a tensor no other rank holds: nothing to sum


@torch.no_grad()
def reduce_gradients(grads: Dict[str, torch.Tensor], world: int,
                     groups: Dict[str, object]) -> Dict[str, torch.Tensor]:
    """Each gradient summed over the ranks that hold its tensor and divided
    by the world size, in one flat f32 bucket per group: ``groups`` names
    the group of a gradient whose tensor not every rank holds (a
    tensor-parallel shard: its data group, or ``ALONE``); the others sum
    over the whole world."""
    by_group: Dict[object, List[str]] = {}
    for name in grads:
        by_group.setdefault(groups.get(name), []).append(name)
    out = dict(grads)
    divisor = None
    for group, names in by_group.items():
        flat = torch.cat([grads[k].reshape(-1).float() for k in names])
        if group is not ALONE:
            all_reduce_(flat, group if group is not None else dist.group.WORLD)
        if divisor is None:
            divisor = torch.full((), float(world), dtype=torch.float32, device=flat.device)
        flat = flat / divisor
        offset = 0
        for k in names:
            n = grads[k].numel()
            out[k] = flat[offset:offset + n].reshape(grads[k].shape).to(grads[k].dtype)
            offset += n
    return out
