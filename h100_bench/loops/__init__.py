"""The loops a mix names under ``loop``: each a ``Loop(ctx)`` whose
construction is the set-up (build, data, warm-up, the checked first
steps), with ``window(seconds)``, ``end_to_end(window)``, ``profile()``
and ``check()``."""

from __future__ import annotations

import time
from typing import Callable, Dict

import torch

from h100_bench import trace as tr


def profiled(ctx, model, units: int, run: Callable[[], None], backward_text: bool):
    """Trace ``run()`` (``units`` steps or batches) with the arch's ranges
    installed; the ``Trace`` of it."""
    ranges = tr.Ranges()
    for name, module, backward in ctx.arch.ranges(model, backward_text):
        ranges.add(name, module, backward)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if ctx.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            with tr.span("slice"):
                run()
                if ctx.device.type == "cuda":
                    torch.cuda.synchronize(ctx.device)
            wall = time.perf_counter() - t0
    finally:
        ranges.remove()
    return tr.read(prof, units, wall, on_cpu=ctx.device.type == "cpu")


def relative_gap(a: float, b: float) -> float:
    """|a - b| / |b|."""
    return abs(a - b) / abs(b)


def check(name: str, value: float, limits: Dict) -> Dict:
    return {name: {"value": float(value), "limit": float(limits[name])}}
