"""The whole CLIP text tower, and its input-cotangent backward, on
hand-written kernels.

Replaces ``ppt_tpu/kernels/texttower.py:fused_text_tower`` (both forward
variants, ``_tower_kernel``) and ``_tower_bwd_pallas``
(``_tower_bwd_kernel``); the CUDA side is ``csrc/text.cu`` (entry points
``ppt_text_tower`` and ``ppt_text_tower_bwd``), whose header says what
bounds it on the H100 and how its design answers that.

Semantics (``texttower.py:68-154``): every block of the tower over
``x0 [C, L, D]`` (positional embedding already added), pooling at the EOT
position as the f32 sum over the one-hot rows ``eot_onehot [C, L]``, f32
``ln_final`` on the pooled rows, f32 ``text_projection``: ``[C, E]`` f32,
unnormalised. Rounding differs from the block kernel's: a product is cast
to the compute dtype first and the cast bias added in that dtype; the
softmax is normalised in f32 and then cast; ``c_fc`` adds its f32 bias
before QuickGELU in f32.

The weights arrive stacked on a leading depth axis, the four matrices in
the compute dtype, LN parameters and biases f32, in the reference's
argument order (``WEIGHT_NAMES``).

Backward (``texttower.py:166-326``, ``:630-672``): ``d_x0`` comes from the
hand-written backward kernel, which takes the tower input and every
block's output saved by the residual-saving forward and recomputes each
block's LayerNorm statistics, attention probabilities and GELU
pre-activations. The kernel yields no weight cotangent: a weight that
asks for a gradient gets the plain tower's, recomputed under autograd.

The three entry points are registered operators (``_ops.py``):
``torch.ops.ppt.fused_text_tower``, ``fused_text_tower_res`` (with the
block outputs) and ``fused_text_tower_bwd``, each with its plain version
on the CPU key and its launch on the CUDA key.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from ppt_torch.kernels import _build, _ops
from ppt_torch.kernels._autograd import refuse_second_order
from ppt_torch.kernels.textblock import (LN_EPS, MATRICES, MATRIX_NAMES, call_entry,
                                         block_flops, causal_scores, check_text_shapes,
                                         forward_scratch, prepare_weights, quick_gelu_f32,
                                         split_heads)
from ppt_torch.kernels.vitblock import _mm, check_tma, ln_f32

WEIGHT_NAMES = ("ln1s", "ln1b", "win", "bin", "wout", "bout", "ln2s", "ln2b", "wfc", "bfc",
                "wproj", "bproj", "lnfs", "lnfb", "tproj")


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    """``[C, H, L, d]`` -> ``[C, L, H*d]``."""
    C, H, L, d = t.shape
    return t.transpose(1, 2).reshape(C, L, H * d)


def text_tower_plain(x0, eot_onehot, ln1s, ln1b, win, bin_, wout, bout, ln2s, ln2b, wfc, bfc,
                     wproj, bproj, lnfs, lnfb, tproj, heads, return_blocks: bool = False):
    """Plain PyTorch version of the tower (``_tower_twin``). With
    ``return_blocks`` also every block's output, ``[depth, C*L, D]``."""
    C, L, D = x0.shape
    dt = x0.dtype
    x = x0
    blocks = []
    for i in range(win.shape[0]):
        y1 = ln_f32(x.float(), ln1s[i], ln1b[i], LN_EPS).to(dt)
        qkv = _mm(y1, win[i]).to(dt) + bin_[i].to(dt)
        q, k, v = split_heads(qkv, heads)
        p = torch.softmax(causal_scores(q, k), dim=-1)
        acc = _merge_heads(_mm(p.to(dt), v).to(dt))
        x = x + (_mm(acc, wout[i]).to(dt) + bout[i].to(dt))
        y2 = ln_f32(x.float(), ln2s[i], ln2b[i], LN_EPS).to(dt)
        h1 = quick_gelu_f32(_mm(y2, wfc[i]) + bfc[i]).to(dt)
        x = x + (_mm(h1, wproj[i]).to(dt) + bproj[i].to(dt))
        if return_blocks:
            blocks.append(x.reshape(C * L, D))
    pooled = torch.einsum("cl,cld->cd", eot_onehot.float(), x.float())
    out = ln_f32(pooled, lnfs, lnfb, LN_EPS) @ tproj.float()
    return (out, torch.stack(blocks)) if return_blocks else out


def _ln_stats(x32: torch.Tensor):
    """(xhat, rstd) of the f32 LayerNorm, fast variance."""
    mu = x32.mean(-1, keepdim=True)
    var = (x32 * x32).mean(-1, keepdim=True) - mu * mu
    r = torch.rsqrt(var + LN_EPS)
    return (x32 - mu) * r, r


def ln_vjp(dy32, xhat, r, gamma):
    """LayerNorm's input cotangent (``_ln_vjp``, ``texttower.py:157-163``):
    ``r * (t - mean(t) - xhat * mean(t * xhat))`` with ``t = dy * gamma``."""
    t = dy32 * gamma
    mt = t.mean(-1, keepdim=True)
    mtx = (t * xhat).mean(-1, keepdim=True)
    return r * (t - mt - xhat * mtx)


def text_tower_bwd_plain(g, x0, xs, eot_onehot, ln1s, ln1b, win, bin_, wout, bout, ln2s, ln2b,
                         wfc, bfc, wproj, bproj, lnfs, lnfb, tproj, heads) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel, formula by formula
    (``_tower_bwd_kernel``), with no autograd inside. ``g [C, E]``; ``x0
    [C, L, D]``; ``xs [depth, C*L, D]`` the block outputs. Returns ``d_x0``
    in x0's dtype."""
    C, L, D = x0.shape
    dt = x0.dtype
    depth = win.shape[0]
    d = D // heads
    scale = 1.0 / math.sqrt(d)
    xs = xs.reshape(depth, C, L, D)
    eot = eot_onehot.float()

    # epilogue backward
    d_xn = g.float() @ tproj.float().t()
    pooled = torch.einsum("cl,cld->cd", eot, xs[depth - 1].float())
    xh, r = _ln_stats(pooled)
    d_pooled = ln_vjp(d_xn, xh, r, lnfs)
    d2 = eot[:, :, None] * d_pooled[:, None, :]  # eot^T @ d_pooled, per class

    for i in range(depth - 1, -1, -1):
        x_in = x0 if i == 0 else xs[i - 1]
        # recompute the forward's internals from the saved block input
        xh1, r1 = _ln_stats(x_in.float())
        y1 = (xh1 * ln1s[i] + ln1b[i]).to(dt)
        qkv = _mm(y1, win[i]).to(dt) + bin_[i].to(dt)
        q, k, v = split_heads(qkv, heads)
        pn = torch.softmax(causal_scores(q, k), dim=-1)
        attn = _merge_heads(_mm(pn.to(dt), v).to(dt))
        x1 = x_in + (_mm(attn, wout[i]).to(dt) + bout[i].to(dt))
        xh2, r2 = _ln_stats(x1.float())
        y2 = (xh2 * ln2s[i] + ln2b[i]).to(dt)
        h1f = _mm(y2, wfc[i]) + bfc[i]
        sig = torch.sigmoid(1.702 * h1f)

        # MLP backward
        d_h1 = _mm(d2.to(dt), wproj[i].t())
        d_h1f = d_h1 * (sig + 1.702 * h1f * sig * (1.0 - sig))
        d_y2 = _mm(d_h1f.to(dt), wfc[i].t())
        d_x1 = d2 + ln_vjp(d_y2, xh2, r2, ln2s[i])

        # attention backward
        d_attn = _mm(d_x1.to(dt), wout[i].t())
        d_o = d_attn.reshape(C, L, heads, d).transpose(1, 2).to(dt)
        d_p = _mm(d_o, v.transpose(-1, -2))
        rowdot = (d_p * pn).sum(-1, keepdim=True)
        d_s = (pn * (d_p - rowdot)).to(dt)
        d_q = _mm(d_s, k) * scale
        d_k = _mm(d_s.transpose(-1, -2), q) * scale
        d_v = _mm(pn.to(dt).transpose(-1, -2), d_o)
        d_qkv = torch.cat([_merge_heads(d_q), _merge_heads(d_k), _merge_heads(d_v)], dim=-1)
        d_y1 = _mm(d_qkv.to(dt), win[i].t())
        d2 = d_x1 + ln_vjp(d_y1, xh1, r1, ln1s[i])
    return d2.to(dt)


def _dims(name: str, x0: torch.Tensor, weights: Sequence[torch.Tensor], heads: int,
          backward: bool):
    C, L, D = x0.shape
    depth, _, hid = weights[8].shape
    E = weights[14].shape[1]
    _build.dtype_code(name, x0.dtype)
    check_text_shapes(name, L, D, heads, hid, x0.dtype, backward=backward)
    return (C, L, D, heads, hid, depth, E)


def _prepare(name: str, dt: torch.dtype, weights: Sequence[torch.Tensor], **acts):
    """The 15 weights as the kernels take them; refuses by name a bf16
    matrix or activation that TMA cannot load (``acts``: the tower input
    and the saved block outputs, which the residual epilogues read)."""
    out = prepare_weights(dt, weights[:12]) + [w.float().contiguous() for w in weights[12:]]
    check_tma(name, **acts, **{n: out[i] for i, n in zip(MATRICES, MATRIX_NAMES)})
    return out


def _check_ln_rows(name: str, **tensors: torch.Tensor) -> None:
    """The LayerNorm backward reads x, gamma and its cotangents in 16-byte
    chunks, in either dtype: refuse by name a base it could not load so
    (the cotangents are buffers this module allocates)."""
    for key, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the LayerNorm backward loads 16-byte chunks; {key} is "
                             f"not 16-byte aligned")


def _launch_forward(x0, eot_onehot, weights, heads, want_blocks: bool):
    name = "fused_text_tower_res" if want_blocks else "fused_text_tower"
    dims = _dims(name, x0, weights, heads, backward=False)
    C, L, D, _, hid, depth, E = dims
    dt, dev = x0.dtype, x0.device
    x0 = x0.contiguous()
    eot = eot_onehot.float().contiguous()
    R = C * L
    out = torch.empty(C, E, dtype=torch.float32, device=dev)
    if want_blocks:
        xs, pingpong = torch.empty(depth, R, D, dtype=dt, device=dev), [None, None]
    else:
        xs, pingpong = None, [torch.empty(R, D, dtype=dt, device=dev) for _ in range(2)]
    weights = _prepare(name, dt, weights, x0=x0)
    call_entry("ppt_text_tower", name, dt, dims,
               [x0, eot, *weights, *forward_scratch(R, D, hid, dt, dev),
                *pingpong, xs, out])
    return (out, xs) if want_blocks else out


def _launch_backward(g, x0, xs, eot_onehot, weights, heads):
    name = "fused_text_tower_bwd"
    dims = _dims(name, x0, weights, heads, backward=True)
    C, L, D, _, hid, depth, E = dims
    dt, dev = x0.dtype, x0.device
    R = C * L
    if tuple(xs.shape) != (depth, R, D) or xs.dtype != dt:
        raise ValueError(f"{name}: block outputs {tuple(xs.shape)} {xs.dtype}, "
                         f"want {(depth, R, D)} {dt}")

    def buf(n, dtype=dt):
        return torch.empty(R, n, dtype=dtype, device=dev)

    f32 = torch.float32
    x0, xs = x0.contiguous(), xs.contiguous()
    weights = _prepare(name, dt, weights, x0=x0, xs=xs)
    _check_ln_rows(name, x0=x0, xs=xs, ln1s=weights[0], ln2s=weights[6])
    dx0 = torch.empty(C, L, D, dtype=dt, device=dev)
    call_entry("ppt_text_tower_bwd", name, dt, dims,
               [g.float().contiguous(), x0, xs, eot_onehot.float().contiguous(), *weights,
                buf(D), buf(3 * D), buf(D), buf(D), buf(hid, f32) if dt == f32 else None,
                buf(hid), buf(D),
                buf(D, f32), buf(D, f32), buf(D, f32), buf(D), buf(3 * D), dx0])
    return dx0


def _tower_cuda(x0, eot_onehot, *rest) -> torch.Tensor:
    """``ppt::fused_text_tower`` on the card: the forward kernel."""
    return _launch_forward(x0, eot_onehot, rest[:-1], rest[-1], False)


def _tower_res_cuda(x0, eot_onehot, *rest):
    """``ppt::fused_text_tower_res`` on the card: the forward kernel with
    every block's output written."""
    return _launch_forward(x0, eot_onehot, rest[:-1], rest[-1], True)


def _tower_bwd_cuda(g, x0, xs, eot_onehot, *rest) -> torch.Tensor:
    """``ppt::fused_text_tower_bwd`` on the card: the backward kernel."""
    return _launch_backward(g, x0, xs, eot_onehot, rest[:-1], rest[-1])


def _tower_fake(x0, eot_onehot, *rest) -> torch.Tensor:
    return x0.new_empty(x0.shape[0], rest[14].shape[1], dtype=torch.float32)


def _tower_res_fake(x0, eot_onehot, *rest):
    C, L, D = x0.shape
    return _tower_fake(x0, eot_onehot, *rest), x0.new_empty(rest[8].shape[0], C * L, D)


def _tower_bwd_fake(g, x0, *rest) -> torch.Tensor:
    return x0.new_empty(x0.shape)


def _tower_flops(x0, eot_onehot, *rest) -> int:
    """``text_tower_plain``'s products as ``FlopCounterMode`` counts them:
    ``depth`` blocks', the EOT pooling as a product with the one-hot rows
    and the text projection."""
    C, L, D = x0
    depth, _, hid = rest[8]
    return depth * block_flops(C, L, D, hid) + 2 * C * L * D + 2 * C * D * rest[14][1]


def _tower_bwd_flops(g, x0, xs, eot_onehot, *rest) -> int:
    """``text_tower_bwd_plain``'s products as ``FlopCounterMode`` counts
    them: a block's qkv, attention and out_proj recomputed with c_fc, then
    the input cotangents of c_proj, c_fc, out_proj, the attention's four
    products and qkv; the projection's cotangent and the EOT pooling."""
    C, L, D = x0
    depth, _, hid = rest[8]
    R = C * L
    per_block = 2 * R * (8 * D * D + 3 * D * hid) + 12 * C * L * L * D
    return depth * per_block + 2 * C * D * rest[14][1] + 2 * C * L * D


_WEIGHTS = ", ".join(f"Tensor {n}" for n in WEIGHT_NAMES)
_tower_op = _ops.register(
    f"fused_text_tower(Tensor x0, Tensor eot_onehot, {_WEIGHTS}, int heads) -> Tensor",
    lambda x0, eot, *rest: text_tower_plain(x0, eot, *rest),
    _tower_cuda, _tower_fake, _tower_flops)
_tower_res_op = _ops.register(
    f"fused_text_tower_res(Tensor x0, Tensor eot_onehot, {_WEIGHTS}, int heads) "
    "-> (Tensor, Tensor)",
    lambda x0, eot, *rest: text_tower_plain(x0, eot, *rest, return_blocks=True),
    _tower_res_cuda, _tower_res_fake, _tower_flops)
_tower_bwd_op = _ops.register(
    f"fused_text_tower_bwd(Tensor g, Tensor x0, Tensor xs, Tensor eot_onehot, {_WEIGHTS}, "
    "int heads) -> Tensor", text_tower_bwd_plain, _tower_bwd_cuda, _tower_bwd_fake,
    _tower_bwd_flops)


def tower_forward(x0, eot_onehot, weights, heads, want_blocks: bool = False):
    """``torch.ops.ppt.fused_text_tower``, or with ``want_blocks``
    ``fused_text_tower_res`` (also every block's output)."""
    op = _tower_res_op if want_blocks else _tower_op
    return op(x0, eot_onehot, *weights, heads)


def tower_backward(g, x0, xs, eot_onehot, weights, heads) -> torch.Tensor:
    """``torch.ops.ppt.fused_text_tower_bwd``: ``d_x0``."""
    return _tower_bwd_op(g, x0, xs, eot_onehot, *weights, heads)


class _FusedTextTower(torch.autograd.Function):
    @staticmethod
    def forward(ctx, heads, x0, eot_onehot, *weights):
        ctx.heads = heads
        ctx.need_x = ctx.needs_input_grad[1]
        ctx.need_w = any(ctx.needs_input_grad[3:])
        if ctx.need_x:  # the residual-saving variant
            out, xs = tower_forward(x0, eot_onehot, weights, heads, want_blocks=True)
            ctx.save_for_backward(x0, eot_onehot, xs, *weights)
            return out
        if ctx.need_w:
            ctx.save_for_backward(x0, eot_onehot, *weights)
        return tower_forward(x0, eot_onehot, weights, heads)

    @staticmethod
    def backward(ctx, g):
        refuse_second_order("fused_text_tower_bwd")
        saved = list(ctx.saved_tensors)
        x0, eot = saved[0], saved[1]
        weights = saved[3:] if ctx.need_x else saved[2:]
        dx = tower_backward(g, x0, saved[2], eot, weights, ctx.heads) if ctx.need_x else None
        d_ws = [None] * len(weights)
        if ctx.need_w:
            # the kernel has no weight cotangent: the plain tower's, recomputed
            needs = ctx.needs_input_grad[3:]
            ws = [w.detach().requires_grad_(need) for w, need in zip(weights, needs)]
            with torch.enable_grad():
                out = text_tower_plain(x0.detach(), eot, *ws, ctx.heads)
            grads = iter(torch.autograd.grad(out, [w for w, n in zip(ws, needs) if n],
                                             g.to(out.dtype)))
            d_ws = [next(grads) if n else None for n in needs]
        return (None, dx, None, *d_ws)


def fused_text_tower(x0, eot_onehot, ln1s, ln1b, win, bin_, wout, bout, ln2s, ln2b, wfc, bfc,
                     wproj, bproj, lnfs, lnfb, tproj, heads) -> torch.Tensor:
    """The whole text tower in one call: ``[C, L, D]`` -> ``[C, E]`` f32,
    unnormalised. Under ``no_grad``, or when nothing asks for a gradient,
    the forward kernel runs and nothing is saved; when ``x0`` needs a
    gradient the residual-saving variant runs and the backward is the
    backward kernel."""
    weights = (ln1s, ln1b, win, bin_, wout, bout, ln2s, ln2b, wfc, bfc, wproj, bproj, lnfs,
               lnfb, tproj)
    if not torch.is_grad_enabled():  # a Function still sees needs_input_grad here
        return tower_forward(x0, eot_onehot, weights, heads)
    return _FusedTextTower.apply(heads, x0, eot_onehot, *weights)
