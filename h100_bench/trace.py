"""Reading a ``torch.profiler`` trace of the card into per-layer numbers.

``busy_us``, ``exclusive_us``, ``PARTS`` and ``part_of`` are copies of
``ppt_torch/tools/profile.py``'s arithmetic. What is new here is where a
kernel belongs: the harness opens ``record_function`` ranges from module
hooks (``Ranges``) and around its own calls (``span``), and a kernel
belongs to every range whose host interval, on the thread that launched
it, holds its launch (the runtime call with the kernel's correlation id).
So a range's device time is that of the kernels it launched, and not the
interval between two marks with the gaps in which the card waits.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple

import torch

PREFIX = "bench::"

# substring of the CUDA kernel's name -> the part of the step it belongs to
PARTS = (
    ("text::gemm_", "text: GEMMs"),
    ("text::ln_vjp_kernel", "text: LayerNorm backward"),
    ("text::ln_kernel", "text: LayerNorm"),
    ("text::attn_fwd_", "text: attention"),
    ("text::attn_bwd_", "text: attention backward"),
    ("text::pool_ln_proj_kernel", "text: pooling + ln_final + projection"),
    ("text::epilogue_bwd_kernel", "text: pooling + ln_final + projection"),
    ("text::proj_bwd_kernel", "text: pooling + ln_final + projection"),
    ("fps_batched_kernel", "fps_batched"),
    ("knn_gather_kernel", "knn_gather"),
    ("knn_single_kernel", "knn_single"),
    ("ball_query_feats_kernel", "ball_query_gather_feats"),
    ("ball_query_kernel", "ball_query_gather"),
    ("mini_forward", "mini_forward"),
    ("mini_stats", "mini_stats"),
    ("m2_reduce_kernel", "mini_stats"),
    ("add_ln_kernel", "vit block: add + LayerNorm"),
    ("add_ln_rows_kernel", "vit block: add + LayerNorm"),
    ("gemm_wgmma_kernel", "vit block: GEMMs"),
    ("gemm_f32_kernel", "vit block: GEMMs"),
    ("attention_wgmma_kernel", "vit block: attention"),
    ("attention_bf16_kernel", "vit block: attention"),
    ("attention_f32_kernel", "vit block: attention"),
    ("flash_fwd_wgmma_kernel", "flash_mha"),
    ("flash_f32_kernel", "flash_mha"),
    ("flash_bwd_", "flash_mha_bwd"),
    ("readout_kernel", "vit block: readout"),
    ("nn_dists_kernel", "chamfer_nn_dists"),
    ("approx_match_warp_kernel", "approx_match"),
    ("approx_match_kernel", "approx_match"),
)
OTHER = "other (library kernels)"


def part_of(kernel_name: str) -> str:
    for key, part in PARTS:
        if key in kernel_name:
            return part
    return OTHER


def exclusive_us(intervals: Sequence[Tuple[float, float]]) -> List[float]:
    """Each [start, end) interval's share of their union, in the given
    order: the time it ran while no interval that started earlier was
    still running. The shares sum to ``busy_us`` of the same intervals."""
    order = sorted(range(len(intervals)), key=lambda i: intervals[i][0])
    share, covered = [0.0] * len(intervals), float("-inf")
    for i in order:
        s, e = intervals[i]
        share[i] = max(0.0, e - max(s, covered))
        covered = max(covered, e)
    return share


def busy_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def idle_gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float
              ) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi) that no interval covers."""
    gaps, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            gaps.append((at, min(s, hi)))
        at = max(at, e)
    if at < hi:
        gaps.append((at, hi))
    return [(a, b) for a, b in gaps if b > a]


@contextlib.contextmanager
def span(name: str, enabled: bool = True):
    """A ``record_function`` range named ``bench::<name>`` (nothing when off)."""
    if not enabled:
        yield
        return
    with torch.profiler.record_function(PREFIX + name):
        yield


class Ranges:
    """``record_function`` ranges around modules' forwards (and, with
    ``backward``, their backwards) while installed."""

    def __init__(self):
        self._handles, self._open = [], {}

    def add(self, name: str, module: torch.nn.Module, backward: bool = False) -> None:
        def enter(key):
            rf = torch.profiler.record_function(PREFIX + key)
            rf.__enter__()
            self._open.setdefault(key, []).append(rf)

        def leave(key):
            stack = self._open.get(key)
            if stack:
                stack.pop().__exit__(None, None, None)

        h = self._handles
        h.append(module.register_forward_pre_hook(lambda m, a: enter(name)))
        h.append(module.register_forward_hook(lambda m, a, o: leave(name)))
        if backward:
            h.append(module.register_full_backward_pre_hook(
                lambda m, g: enter(name + ".backward")))
            h.append(module.register_full_backward_hook(
                lambda m, gi, go: leave(name + ".backward")))

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []


def _is_sync(name: str) -> bool:
    return name.endswith(" Sync") or name == "Device Synchronize"


@dataclasses.dataclass
class Kernel:
    name: str
    start: float  # device us, the profiler's clock
    end: float
    ranges: Tuple[str, ...]  # every bench range that holds its launch
    share: float = 0.0  # exclusive us


@dataclasses.dataclass
class Trace:
    """The device's work over a profiled slice of ``units`` steps or batches."""

    units: int
    wall_s: float
    kernels: List[Kernel]  # device activity: kernels, copies, fills
    annotations: List[Tuple[str, float, float]]  # main-thread bench ranges (name, start, end)
    slice_range: Tuple[float, float]

    @property
    def busy_s(self) -> float:
        return busy_us((k.start, k.end) for k in self.kernels) / 1e6

    def launches(self) -> int:
        return sum(1 for k in self.kernels if not k.name.startswith(("Memcpy", "Memset")))

    def range_us(self, name: str, exclude_children: bool = False) -> float:
        """Exclusive device us of the kernels launched inside range ``name``;
        with ``exclude_children`` only those inside no other range nested in it."""
        total = 0.0
        for k in self.kernels:
            if name in k.ranges:
                inner = k.ranges[k.ranges.index(name) + 1:]
                if not (exclude_children and inner):
                    total += k.share
        return total

    def kernels_us(self, substrings: Sequence[str]) -> float:
        return sum(k.share for k in self.kernels if any(s in k.name for s in substrings))

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        parts = collections.Counter()
        for k in self.kernels:
            parts[part_of(k.name)] += k.share
        lo, hi = self.slice_range
        gaps = sorted(idle_gaps([(k.start, k.end) for k in self.kernels], lo, hi),
                      key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, us / 1e6] for n, us in parts.most_common(top)],
                "idle_gaps": [[self.host_span_at(a, b), (b - a) / 1e6] for a, b in gaps]}

    def by_range(self) -> Dict[str, float]:
        """Device ms a unit under each range (a kernel counts in each range
        that holds it)."""
        out = collections.Counter()
        for k in self.kernels:
            for n in k.ranges:
                out[n] += k.share
        return {n: us / 1e3 / self.units for n, us in sorted(out.items())}

    def host_span_at(self, a: float, b: float) -> str:
        """The innermost harness range that overlaps [a, b) most."""
        best, key = "no bench range", (0.0, 0.0)
        for name, s, e in self.annotations:
            overlap = min(b, e) - max(a, s)
            if overlap > 0 and (overlap, -(e - s)) > key:
                best, key = name, (overlap, -(e - s))
        return best


def read(prof, units: int, wall_s: float, on_cpu: bool = False) -> Trace:
    """The ``Trace`` of a finished ``torch.profiler.profile`` whose slice
    ran inside a ``span("slice")``. ``on_cpu`` (the tests' tiny runs) takes
    the leaf ATen operators as the device's work, each its own launch."""
    events = list(prof.events())
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    if on_cpu:
        device = [e for e in cpu if e.name.startswith("aten::") and not e.cpu_children]
        launch = {e.id: e for e in device}
    else:
        device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.name.startswith(PREFIX) and not _is_sync(e.name)]
        # the launch calls: cudaLaunchKernel, cuLaunchKernel, ...
        launch = {e.id: e for e in cpu if e.name.startswith("cu")}
    if not device:
        raise RuntimeError("the profiler recorded no device activity")
    by_id = {e.id: e for e in cpu if not e.name.startswith("cu")}
    ranges = collections.defaultdict(list)  # thread -> [(start, end, name)]
    for e in cpu:
        if e.name.startswith(PREFIX):
            ranges[e.thread].append((e.time_range.start, e.time_range.end, e.name[len(PREFIX):]))
    slice_iv = next(((s, t) for th in ranges.values() for s, t, n in th if n == "slice"), None)
    if slice_iv is None:
        raise RuntimeError("the profiled slice has no bench::slice range")
    kernels = []
    for e in device:
        host = launch.get(e.id) or by_id.get(getattr(e, "linked_correlation_id", 0))
        held: Tuple[str, ...] = ()
        if host is not None:
            t = host.time_range.start
            held = tuple(n for s, f, n in sorted(ranges.get(host.thread, ()))
                         if s <= t <= f and n != "slice")
        kernels.append(Kernel(e.name, e.time_range.start, e.time_range.end, held))
    for k, us in zip(kernels, exclusive_us([(k.start, k.end) for k in kernels])):
        k.share = us
    main = max(ranges, key=lambda th: any(n == "slice" for _, _, n in ranges[th]))
    notes = [(n, s, e) for s, e, n in ranges[main] if n != "slice"]
    return Trace(units, wall_s, kernels, notes, slice_iv)
