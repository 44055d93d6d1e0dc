"""The recognition path's kernels as registered operators, ``torch.ops.ppt.*``.

``torch.export`` cannot trace a ctypes call, and ``FlopCounterMode`` cannot
see one. Registered through one ``torch.library.Library("ppt", "DEF")``, an
entry point becomes an operator with a written schema that both see whole:

- the CPU key runs its plain PyTorch version (its outputs made contiguous,
  as the launch writes them), the CUDA key its launch (the hand-written
  kernel, or an exception): the key registration is the port's dispatch
  rule, so no wrapper branches on the device and nothing falls back;
- a fake implementation gives the outputs' shapes and dtypes from the
  inputs' (a symbolic batch included), for ``torch.export`` and meta
  tensors; the checks only a real launch needs stay in the launch;
- a FLOP formula counts 2 per multiply-add: for the kernels made of
  products, the count ``FlopCounterMode`` gives their plain versions; for
  the geometry and loss kernels, the work that ``PERF.md`` §6 bounds them
  by. A meta tensor thus traces the card's program whole, launches counted
  by operator and FLOPs by formula, with no card, no build and no launch.

The operators have no Autograd key: ``_autograd.recompute_grad`` and the
``autograd.Function``s of the flash kernel, the text tower and the EMD
call them from their forwards (and backwards). Importing
``ppt_torch.kernels`` registers every operator of the modules it imports
(``kernels/__init__.py``), which is all a process that loads an exported
program needs.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import register_flop_formula

LIB = torch.library.Library("ppt", "DEF")
# operator name -> the function its CUDA key runs (the launch)
CUDA_IMPL: Dict[str, Callable] = {}


def _contiguous(plain: Callable) -> Callable:
    def cpu(*args):
        out = plain(*args)
        return tuple(t.contiguous() for t in out) if isinstance(out, tuple) else out.contiguous()
    return cpu


def register(schema: str, plain: Callable, launch: Callable, fake: Callable,
             flops: Callable):
    """Define ``ppt::<schema>`` with ``plain`` on the CPU, ``launch`` on the
    card, ``fake`` for shapes and ``flops`` (called with the tensors' shapes
    in their places) for ``FlopCounterMode``; returns ``torch.ops.ppt.<name>``."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, _contiguous(plain), "CPU")
    LIB.impl(name, launch, "CUDA")
    CUDA_IMPL[name] = launch
    torch.library.register_fake(f"ppt::{name}", fake, lib=LIB)
    op = getattr(torch.ops.ppt, name)
    register_flop_formula(op)(lambda *args, out_shape=None, **kw: flops(*args, **kw))
    return op


class OpCounter(TorchDispatchMode):
    """Counts the ``ppt`` operators called under it, by name, in
    ``counts``: on the card the launches ``_build.LAUNCHES`` counts, on
    meta tensors the card's launches without a card."""

    def __init__(self):
        super().__init__()
        self.counts: collections.Counter = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "ppt":
            self.counts[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))
