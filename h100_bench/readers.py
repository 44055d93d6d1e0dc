"""The arithmetic behind the per-layer metrics; each file of
``h100_bench/metrics/`` applies one of these to a run. Each returns None
where the run has nothing for it to read."""

from __future__ import annotations

from typing import Optional

from h100_bench.arch import PEAK_BF16


def host_gap_ms(run) -> Optional[float]:
    """Mean host time a unit outside the model's call (window, host clock)."""
    gaps = run.window.gap_s
    return 1e3 * sum(gaps) / len(gaps) if gaps else None


def launches(run) -> Optional[float]:
    """Device kernels a unit over the profiled slice."""
    t = run.trace
    return t.launches() / t.units if t is not None else None


def range_ms(run, *names: str) -> Optional[float]:
    """Device ms a unit of the kernels launched inside the named ranges."""
    t = run.trace
    if t is None:
        return None
    us = sum(t.range_us(n) for n in names)
    return us / 1e3 / t.units if us > 0 else None


def _piece_us(trace, piece) -> float:
    total = 0.0
    for kind, what in piece.select:
        if kind == "kernels":
            total += trace.kernels_us(what)
        else:
            total += trace.range_us(what, exclude_children=kind == "range_only")
    return total


def roofline_pct(run, kind: str) -> Optional[float]:
    """The pieces' least time at the roofline over their kernels' device
    time, in percent; pieces with no kernel in the trace are left out."""
    t = run.trace
    if t is None:
        return None
    bound = spent = 0.0
    for piece in run.ctx.arch.pieces(run.ctx.cfg, kind):
        us = _piece_us(t, piece)
        if us > 0:
            bound += piece.bound_s * t.units
            spent += us / 1e6
    return 100.0 * bound / spent if spent > 0 else None


def idle_pct(run) -> Optional[float]:
    """100 x (1 - device busy a unit / wall a unit): the busy time from the
    profiled slice, the wall from the window, where no profiler slows the
    host's launches."""
    t, w = run.trace, run.window
    if t is None or not w.units:
        return None
    return 100.0 * (1.0 - (t.busy_s / t.units) / (w.elapsed_s / w.units))


def mfu_pct(run) -> Optional[float]:
    """Model FLOPs of the window over the window's seconds at the bf16 peak."""
    w = run.window
    if not w.units:
        return None
    loop = run.ctx.loop
    return 100.0 * loop.model_flops(run.ctx, w) / (w.elapsed_s * PEAK_BF16)
