"""Gradients through the hand-written kernels, by recomputation.

The reference package gives none of its point-tower kernels a backward
kernel: each ``jax.custom_vjp`` differentiates the plain XLA twin
(``kernels/mini.py:329-337``, ``:357-367``, ``kernels/vitblock.py:398-400``,
``:551-553``). ``recompute_grad`` is the port's counterpart: the forward
runs the wrapper (the kernel on the card, its plain version on the CPU)
outside the autograd graph, and the backward re-runs the plain version
under ``torch.enable_grad()`` on the saved inputs and returns its
gradients. When no input requires a gradient (the frozen point tower of
prompt tuning), or grad mode is off (evaluation, ``torch.export``), the
wrapper is called directly and autograd records nothing.

No kernel has a second derivative: a backward asked to build a graph
(``create_graph=True``, as ``adahessian``'s Hessian-vector product asks)
raises by the kernel's name, where the reference's ``hutchinson_diag``
raises too (``jax.jvp`` cannot go through a ``custom_vjp``).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def refuse_second_order(name: str) -> None:
    """Raise by ``name`` when a backward runs with grad mode on, that is
    under ``create_graph=True``: a kernel's gradient is not differentiable."""
    if torch.is_grad_enabled():
        raise NotImplementedError(
            f"{name}: no second derivative through this kernel (adahessian's Hessian-vector "
            "product needs one); the reference's hutchinson_diag cannot take jax.jvp through "
            "its custom_vjp kernel either. Train these leaves with a first-order optimizer, "
            "or on a route that does not run the kernel")


class _Recompute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, name: str, run: Callable, plain: Callable, *args):
        ctx.name = name
        ctx.plain = plain
        ctx.is_tensor = [isinstance(a, torch.Tensor) for a in args]
        ctx.static = [None if t else a for a, t in zip(args, ctx.is_tensor)]
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(*[a for a in args if isinstance(a, torch.Tensor)])
        return run(*args)

    @staticmethod
    def backward(ctx, *grad_outputs):
        refuse_second_order(ctx.name)
        saved = iter(ctx.saved_tensors)
        needs = ctx.needs_input_grad[3:]
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
        result: Tuple = (None, None, None) + tuple(
            next(grads) if (is_tensor and need) else None
            for is_tensor, need in zip(ctx.is_tensor, needs)
        )
        return result


def recompute_grad(name: str, run: Callable, plain: Callable, *args):
    """``run(*args)`` with the gradient of ``plain(*args)``; ``name`` is the
    kernel's, for the refusal of a second derivative. With grad mode off,
    or no tensor argument that requires a gradient, ``run`` is called
    directly: the eval and export paths hold no ``autograd.Function``."""
    if not (torch.is_grad_enabled()
            and any(isinstance(a, torch.Tensor) and a.requires_grad for a in args)):
        return run(*args)
    return _Recompute.apply(name, run, plain, *args)
