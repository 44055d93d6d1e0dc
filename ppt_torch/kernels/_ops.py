"""The recognition path's kernels as registered operators, ``torch.ops.ppt.*``.

``torch.export`` cannot trace a ctypes call, and ``FlopCounterMode`` cannot
see one. Registered through one ``torch.library.Library("ppt", "DEF")``, an
entry point becomes an operator with a written schema that both see whole:

- the CPU key runs its plain PyTorch version, the CUDA key its launch (the
  hand-written kernel, or an exception): the key registration is the port's
  dispatch rule, so no wrapper branches on the device and nothing falls
  back;
- a fake implementation gives the outputs' shapes and dtypes from the
  inputs' (a symbolic batch included), for ``torch.export`` and meta
  tensors; the checks only a real launch needs stay in the launch;
- a FLOP formula counts 2 per multiply-add over the work that ``PERF.md``
  §6 bounds each kernel by (the grouping kernels by their distance work).

The operators have no Autograd key: ``_autograd.recompute_grad`` calls them
from its forward and differentiates the plain versions. Importing
``ppt_torch.kernels`` registers them, which is all a process that loads an
exported program needs.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.flop_counter import register_flop_formula

LIB = torch.library.Library("ppt", "DEF")


def register(schema: str, plain: Callable, launch: Callable, fake: Callable,
             flops: Callable):
    """Define ``ppt::<schema>`` with ``plain`` on the CPU, ``launch`` on the
    card, ``fake`` for shapes and ``flops`` (called with the tensors' shapes
    in their places) for ``FlopCounterMode``; returns ``torch.ops.ppt.<name>``."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, plain, "CPU")
    LIB.impl(name, launch, "CUDA")
    torch.library.register_fake(f"ppt::{name}", fake, lib=LIB)
    op = getattr(torch.ops.ppt, name)
    register_flop_formula(op)(lambda *args, out_shape=None, **kw: flops(*args, **kw))
    return op
