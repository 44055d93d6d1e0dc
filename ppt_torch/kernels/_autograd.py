"""Gradients through the hand-written kernels, by recomputation.

The reference package gives none of its point-tower kernels a backward
kernel: each ``jax.custom_vjp`` differentiates the plain XLA twin
(``kernels/mini.py:329-337``, ``:357-367``, ``kernels/vitblock.py:398-400``,
``:551-553``). ``recompute_grad`` is the port's counterpart: the forward
runs the wrapper (the kernel on the card, its plain version on the CPU)
outside the autograd graph, and the backward re-runs the plain version
under ``torch.enable_grad()`` on the saved inputs and returns its
gradients. When no input requires a gradient (the frozen point tower of
prompt tuning) autograd records nothing and nothing is saved.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


class _Recompute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run: Callable, plain: Callable, *args):
        ctx.plain = plain
        ctx.is_tensor = [isinstance(a, torch.Tensor) for a in args]
        ctx.static = [None if t else a for a, t in zip(args, ctx.is_tensor)]
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(*[a for a in args if isinstance(a, torch.Tensor)])
        return run(*args)

    @staticmethod
    def backward(ctx, *grad_outputs):
        saved = iter(ctx.saved_tensors)
        needs = ctx.needs_input_grad[2:]
        args, wanted = [], []
        for static, is_tensor, need in zip(ctx.static, ctx.is_tensor, needs):
            if not is_tensor:
                args.append(static)
                continue
            t = next(saved).detach()
            if need:
                t = t.requires_grad_(True)
                wanted.append(t)
            args.append(t)
        with torch.enable_grad():
            outs = ctx.plain(*args)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grad_outputs) if g is not None and o.requires_grad]
        grads = iter(torch.autograd.grad(
            [o for o, _ in pairs], wanted, [g.to(o.dtype) for o, g in pairs], allow_unused=True,
        ) if pairs and wanted else [None] * len(wanted))
        result: Tuple = (None, None) + tuple(
            next(grads) if (is_tensor and need) else None
            for is_tensor, need in zip(ctx.is_tensor, needs)
        )
        return result


def recompute_grad(run: Callable, plain: Callable, *args):
    """``run(*args)`` with the gradient of ``plain(*args)``."""
    return _Recompute.apply(run, plain, *args)
