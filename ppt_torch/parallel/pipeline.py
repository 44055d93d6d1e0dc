"""GPipe-style pipeline parallelism for the PointBERT ViT trunk.

Counterpart of ``ppt_tpu/parallel/pipeline.py``. The reference runs the
schedule as one ``lax.scan`` inside ``shard_map``, moving activations with
``ppermute`` and broadcasting the last stage's buffer with a masked
``psum``; ``jax.grad`` differentiates the whole of it. Here each stage is a
process of the mesh's ``pipe`` axis and the schedule is written by hand:

  - ``n_micro + pp - 1`` ticks (fill, steady state, drain): at tick ``t``
    stage ``s`` runs microbatch ``t - s`` through its ``depth / pp`` blocks
    (``VitBlock`` on its trunk route: ``fused_vit_block`` on the card, the
    unfused block with ``flash_mha`` from ``FLASH_MIN_SEQ`` tokens), then
    sends the activations, with the position embedding they carry (PointBERT
    adds it at every block), one stage forward;
  - the partseg taps (blocks 3, 7 and 11) are kept by the stage that owns
    them;
  - the last stage's output, and each tap, reach every stage of the pipe
    group through a differentiable broadcast (``_StageBroadcast``).

Differentiate through it with ``pipeline.grad`` (or ``loss.backward()``):
``torch.autograd.grad`` alone prunes the sends and receives whose backward
leads to none of the tensors it was asked for, and a stage would then wait
for a gradient that never comes.

Point-to-point is a pair of autograd functions: ``_Send`` sends forward and
receives the gradient back, ``_Recv`` receives forward and sends the
gradient back; tags tell microbatches apart. A stage's sends join its
graph through the broadcasts, so ``backward`` on every rank of the pipe
group drives the whole backward chain. The schedule is hand-written, not
``torch.distributed.pipelining``: the reference's is one differentiable
function, and gloo's point-to-point does not take CUDA tensors.

Transport: on a gloo group (the CPU, or stages sharing a card) a CUDA
tensor is copied through host memory, chosen by the group's backend; an
NCCL group sends device tensors.

Gradients follow ``parallel/collectives.py``'s convention: a replicated
parameter's gradient is the SUM of its partial gradients over the pipe
group (then over the data axis), divided by the world size. The embedding
runs on every stage (as the reference's runs outside ``shard_map``) and
collects its gradient on stage 0, which feeds it in; the riding position
embedding's gradient comes back stage by stage to it.

Scope, as the reference's: the deterministic trunk (eval-mode BatchNorm in
the group encoder, no DropPath).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ppt_torch.kernels.attention import FLASH_MIN_SEQ
from ppt_torch.parallel import collectives as C

__all__ = [
    "stack_vit_blocks",
    "pipeline_blocks",
    "pipelined_trunk_features",
    "pipelined_partseg_features",
]

_BWD = 1 << 20  # tag offset of the gradients coming back


def stack_vit_blocks(encoder, depth: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """``block_0 .. block_{depth-1}``'s parameters stacked along a new
    leading axis, by their name within a block (``attn.qkv.kernel`` ->
    [depth, C, 3C]): the per-stage slice is ``[s * depth / pp, ...]``."""
    blocks = encoder.blocks()[:depth or encoder.config.depth]
    names = [n for n, _ in blocks[0].named_parameters()]
    return {n: torch.stack([dict(b.named_parameters())[n].detach() for b in blocks])
            for n in names}


def _send(t: torch.Tensor, peer: int, group, tag: int) -> None:
    src = t.detach().contiguous()
    if C.via_host(src, group):
        src = src.cpu()
    dist.send(src, dist.get_global_rank(group, peer), group=group, tag=tag)


def _recv(shape, dtype, device, peer: int, group, tag: int) -> torch.Tensor:
    host = C.backend_of(group) == "gloo" and torch.device(device).type == "cuda"
    buf = torch.empty(shape, dtype=dtype, device="cpu" if host else device)
    dist.recv(buf, dist.get_global_rank(group, peer), group=group, tag=tag)
    return buf.to(device)


class _Send(torch.autograd.Function):
    """Send ``x`` to ``peer``; returns a 0-dim token that keeps the send in
    this stage's graph, whose backward receives ``x``'s gradient (also
    when ``x`` needs none: every send pairs with a receive)."""

    @staticmethod
    def forward(ctx, x, anchor, peer, group, tag):
        ctx.meta = (x.shape, x.dtype, x.device, peer, group, tag + _BWD)
        _send(x, peer, group, tag)
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, _token):
        g = _recv(*ctx.meta)
        return g, torch.zeros((), device=g.device), None, None, None


class _Recv(torch.autograd.Function):
    """Receive a tensor from ``peer``; its backward sends the gradient back.
    ``anchor`` (a 0-dim tensor that requires a gradient) puts the received
    tensor into the graph."""

    @staticmethod
    def forward(ctx, anchor, shape, dtype, device, peer, group, tag):
        ctx.meta = (peer, group, tag + _BWD)
        return _recv(shape, dtype, device, peer, group, tag)

    @staticmethod
    def backward(ctx, g):
        peer, group, tag = ctx.meta
        _send(g, peer, group, tag)
        return torch.zeros((), device=g.device), None, None, None, None, None, None


class _StageBroadcast(torch.autograd.Function):
    """``x`` broadcast from pipe rank ``src`` to the group. Elsewhere ``x``
    is a placeholder of the shape and ``tokens`` are that stage's send
    tokens, through which its backward reaches the stage. The adjoint is the
    SUM of the group's gradients at ``src``."""

    @staticmethod
    def forward(ctx, src, group, x, anchor, *tokens):
        ctx.src, ctx.group, ctx.n_tokens = src, group, len(tokens)
        ctx.is_src = dist.get_rank(group) == src
        return C.broadcast_(x.detach().clone(), dist.get_global_rank(group, src), group)

    @staticmethod
    def backward(ctx, g):
        total = C.all_reduce_(g.contiguous().clone(), ctx.group)
        zeros = [torch.zeros((), device=g.device)] * ctx.n_tokens
        return (None, None, total if ctx.is_src else None, torch.zeros((), device=g.device),
                *zeros)


def _broadcast(x: Optional[torch.Tensor], like: torch.Tensor, src: int, group,
               tokens: Sequence[torch.Tensor], anchor: Optional[torch.Tensor]) -> torch.Tensor:
    """``x`` from pipe rank ``src`` (None elsewhere); differentiable when the
    schedule is (``anchor`` given), on every rank alike."""
    if x is None:
        x = torch.zeros_like(like)
    if anchor is None:
        return C.broadcast_(x.detach().clone(), dist.get_global_rank(group, src), group)
    return _StageBroadcast.apply(src, group, x, anchor, *tokens)


_ANCHORS: List[torch.Tensor] = []


def grad(outputs, inputs: Sequence[torch.Tensor], **kw):
    """``torch.autograd.grad`` through pipelined stages: it also asks for
    the gradient of each schedule's anchor, a 0-dim leaf that every send,
    receive and broadcast of the schedule takes as an input, so that each
    of them runs its backward on every rank (``autograd.grad`` prunes the
    nodes that lead to no input it was asked for, and a receive left out
    leaves its peer waiting). Returns the gradients of ``inputs``, zeros for
    a tensor this stage does not use (another stage's blocks); the anchors
    are forgotten."""
    inputs = list(inputs)
    anchors = list(_ANCHORS)
    _ANCHORS.clear()
    grads = torch.autograd.grad(outputs, inputs + anchors, allow_unused=True, **kw)
    return [torch.zeros_like(t) if g is None else g for t, g in zip(inputs, grads)]


def pipeline_blocks(encoder, x: torch.Tensor, pos: torch.Tensor, group, *, n_micro: int,
                    tap_layers: Optional[Sequence[int]] = None):
    """The GPipe schedule over ``encoder``'s blocks on the pipe ``group``:
    ``x`` / ``pos`` are this data shard's tokens [B_loc, T, C] (every stage
    passes its own; only stage 0's are read), microbatched here. Stage ``s``
    runs blocks ``[s L / pp, (s + 1) L / pp)``. Returns [B_loc, T, C] on every
    stage; with ``tap_layers`` (global block indices) also the post-block
    activations of those blocks, ``(out, taps)``, each [B_loc, T, C]."""
    pp, stage = dist.get_world_size(group), dist.get_rank(group)
    blocks = encoder.blocks()
    L_loc = len(blocks) // pp
    mine = blocks[stage * L_loc:(stage + 1) * L_loc]
    B_loc = x.shape[0]
    mb = B_loc // n_micro
    taps = tuple(tap_layers or ())
    route = encoder.route if x.shape[1] < FLASH_MIN_SEQ else "unfused"
    route = "block" if route == "tower" else route
    ones = torch.ones(mb, 2, dtype=torch.float32, device=x.device)
    # one decision on every stage: the replicated flags and inputs agree
    needs_grad = torch.is_grad_enabled() and (x.requires_grad or pos.requires_grad or any(
        p.requires_grad for p in encoder.parameters()))
    anchor = torch.zeros((), device=x.device, requires_grad=True) if needs_grad else None
    if needs_grad:
        _ANCHORS.append(anchor)
    carry_shape = (mb, x.shape[1], 2 * x.shape[2])
    outs: List[Optional[torch.Tensor]] = [None] * n_micro
    tap_parts: Dict[int, List[Optional[torch.Tensor]]] = {g: [None] * n_micro for g in taps}
    tokens: List[torch.Tensor] = []
    for t in range(n_micro + pp - 1):
        m = t - stage
        if not 0 <= m < n_micro:
            continue  # a bubble: this stage has no microbatch at this tick
        if stage == 0:
            h, p = x[m * mb:(m + 1) * mb], pos[m * mb:(m + 1) * mb]
        else:
            if needs_grad:
                carry = _Recv.apply(anchor, carry_shape, x.dtype, x.device, stage - 1, group, m)
            else:
                carry = _recv(carry_shape, x.dtype, x.device, stage - 1, group, m)
            h, p = carry.split(x.shape[2], dim=-1)
        for j, blk in enumerate(mine):
            h = blk(h, p, ones, route=route)
            if stage * L_loc + j in taps:
                tap_parts[stage * L_loc + j][m] = h
        if stage < pp - 1:
            carry = torch.cat([h, p.to(h.dtype)], dim=-1)
            if needs_grad:
                tokens.append(_Send.apply(carry, anchor, stage + 1, group, m))
            else:
                _send(carry, stage + 1, group, m)
        else:
            outs[m] = h
    last = pp - 1
    out = _broadcast(torch.cat(outs) if stage == last else None, x, last, group, tokens,
                     anchor)
    if not taps:
        return out
    tap_out = tuple(
        _broadcast(torch.cat(tap_parts[g]) if stage == g // L_loc else None, x, g // L_loc,
                   group, tokens, anchor)
        for g in taps)
    return out, tap_out


def _run_pipelined(encoder, x, pos, mesh, *, n_micro, dp_axis, pp_axis, tap_layers=None):
    """Validate, then run the schedule on ``mesh``'s pipe group (the
    reference's four refusals, by the same words)."""
    names = tuple(mesh.mesh_dim_names or ())
    if pp_axis not in names:
        raise ValueError(f"mesh has no '{pp_axis}' axis (axes: {names})")
    if dp_axis and dp_axis not in names:
        raise ValueError(f"mesh has no '{dp_axis}' axis (axes: {names}); "
                         "pass dp_axis=None for a pp-only mesh")
    pp_size = mesh.size(names.index(pp_axis))
    depth = encoder.config.depth
    if depth % pp_size:
        raise ValueError(f"depth {depth} not divisible by pp={pp_size}")
    if n_micro is None:
        n_micro = pp_size
    dp_size = mesh.size(names.index(dp_axis)) if dp_axis else 1
    B = x.shape[0] * dp_size
    if B % (dp_size * n_micro):
        raise ValueError(f"batch {B} not divisible by n_micro={n_micro} per dp shard "
                         f"(dp={dp_size})")
    return pipeline_blocks(encoder, x, pos, mesh.get_group(pp_axis), n_micro=n_micro,
                           tap_layers=tap_layers)


def _embed_tokens(encoder, pts: torch.Tensor):
    """The trunk's preamble by the module's own code (``PointBert.embed``:
    grouping, the group encoder with running statistics, ``reduce_dim``,
    the position MLP, the cls token): (x, pos, center)."""
    x, pos, center, _, _, _ = encoder.embed(pts, False, None)
    return x, pos, center


def pipelined_trunk_features(encoder, pts: torch.Tensor, mesh, *,
                             n_micro: Optional[int] = None, dp_axis: Optional[str] = "data",
                             pp_axis: str = "pipe") -> torch.Tensor:
    """The deterministic PointBERT trunk (``encoder``: a ``PointBert``) with
    its blocks pipelined over ``mesh``'s ``pp_axis``: the pp twin of
    ``encoder(pts, train=False)``, [B_loc, 2C] f32. ``pts`` are this rank's
    rows (``shard_batch`` over ``dp_axis``; the whole batch with
    ``dp_axis=None``). The embedding and the readout (f32 LayerNorm,
    ``[cls, max-pool]``) run on every stage, by the module's own code."""
    x, pos, _ = _embed_tokens(encoder, pts)
    x = _run_pipelined(encoder, x, pos, mesh, n_micro=n_micro, dp_axis=dp_axis,
                       pp_axis=pp_axis)
    xn = encoder.norm(x.float())
    return torch.cat([xn[:, 0], xn[:, 1:].amax(1)], dim=-1)


def pipelined_partseg_features(encoder, pts: torch.Tensor, cls_onehot: torch.Tensor, mesh, *,
                               n_micro: Optional[int] = None,
                               dp_axis: Optional[str] = "data",
                               pp_axis: str = "pipe") -> torch.Tensor:
    """The deterministic partseg trunk (``encoder``: a ``PointBertPartSeg``)
    with its ViT stack pipelined: the pp twin of ``encoder(pts, cls_onehot,
    train=False)``, [B_loc, N, 128] per-point features. The taps of blocks
    3, 7 and 11 are captured by their stages and broadcast; the propagation
    head runs on every stage (``PointBertPartSeg.head``)."""
    from ppt_torch.nn.pointbert import PARTSEG_TAPS

    x, pos, center = _embed_tokens(encoder, pts)
    _, taps = _run_pipelined(encoder, x, pos, mesh, n_micro=n_micro, dp_axis=dp_axis,
                             pp_axis=pp_axis, tap_layers=PARTSEG_TAPS)
    feats = [encoder.norm(t.float())[:, 1:] for t in taps]
    return encoder.head(pts, cls_onehot, center, feats, train=False, generator=None)
