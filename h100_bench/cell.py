"""One cell of ``BENCHMARK.json``, found by name, and one run of it.

Everything that belongs to one configuration, mix or metric is a file of
its own, found by the name the cell gives:

- the configuration: the JSON file its entry in ``configs`` names; its
  ``arch`` names the module of ``h100_bench/arch/`` with the family's
  weights, reference and work counts;
- the mix: ``h100_bench/traffic/<traffic>.json``, whose ``loop`` names the
  loop in ``h100_bench/loops/`` that reads its parameters;
- a per-layer metric: ``h100_bench/metrics/<metric>.py``, whose
  ``read(run)`` returns a number or None (nothing to read);
- the limits of the comparison that decides ``correct``:
  ``h100_bench/limits/<cell>.json``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

import torch

BENCH_DIR = "h100_bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "ppt_tpu")


@dataclasses.dataclass
class Window:
    """What the measured window did: ``units`` steps or batches over
    ``elapsed_s`` seconds, ``clouds`` of them valid, each unit's time and
    the host's time outside the model's call."""

    elapsed_s: float
    clouds: int
    units: int
    unit_s: List[float]
    gap_s: List[float]
    failed: int = 0
    passes: int = 0


@dataclasses.dataclass
class Context:
    root: Path
    name: str
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    entry: Dict
    cfg: Dict
    traffic: Dict
    limits: Dict
    bench: Dict
    fault: Optional[str] = None  # tests only: break the timed path underneath

    @property
    def arch(self) -> ModuleType:
        return importlib.import_module(f"{BENCH_DIR}.arch.{self.cfg['arch']}")

    @property
    def loop(self) -> ModuleType:
        return importlib.import_module(f"{BENCH_DIR}.loops.{self.traffic['loop']}")

    def end_to_end(self) -> List[Dict]:
        return [m for m in self.bench["end_to_end"] if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> List[Dict]:
        moved = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if self.name in m.get("workloads", [self.name] if m["moves"] in moved else [])]


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load(root: Path, name: str, seed: int, seconds: float, trace: bool, device,
         bench: Optional[Dict] = None) -> Context:
    """The cell ``name`` of ``root/BENCHMARK.json`` (or of ``bench``)."""
    root = Path(root)
    bench = bench if bench is not None else _json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r}; have {[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Context(root, name, seed, seconds, trace, torch.device(device), entry,
                   _json(root / conf["file"]),
                   _json(root / BENCH_DIR / "traffic" / f"{entry['traffic']}.json"),
                   _json(root / BENCH_DIR / "limits" / f"{name}.json"), bench)


def reader(root: Path, metric: str) -> ModuleType:
    path = Path(root) / BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"{BENCH_DIR}_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def p95(values: List[float]) -> float:
    """The 95th percentile (``statistics.quantiles``, exclusive method)."""
    return statistics.quantiles(values, n=100)[94]


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that this harness may not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclasses.dataclass
class Run:
    """What a metric reader sees."""

    ctx: Context
    window: Window
    trace: Optional[object]  # h100_bench.trace.Trace


@contextlib.contextmanager
def gc_time():
    """Host ms the interpreter's garbage collector took, by generation."""
    spent, started = [0.0, 0.0, 0.0], {}

    def note(phase, info):
        if phase == "start":
            started["t"] = time.perf_counter()
        elif "t" in started:
            spent[info["generation"]] += 1e3 * (time.perf_counter() - started.pop("t"))

    gc.callbacks.append(note)
    try:
        yield spent
    finally:
        gc.callbacks.remove(note)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def execute(ctx: Context, started: float) -> Dict:
    """Set up, measure, trace, check; the result line as a dict."""
    loop = ctx.loop.Loop(ctx)
    _sync(ctx.device)
    setup_s = time.perf_counter() - started
    with gc_time() as collected:
        window = loop.window(ctx.seconds)
    trace = loop.profile() if ctx.trace else None
    cuda = ctx.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    checks = loop.check()
    if ctx.trace:
        run = Run(ctx, window, trace)
        metrics = {}
        for m in ctx.per_layer():
            value = reader(ctx.root, m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(loop.end_to_end(window), setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in ctx.end_to_end()}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(ctx.device) if cuda else "cpu",
              "count": ctx.entry["chips"], "memory_peak_bytes": peak}
    ok = window.failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": ok,
           "attempted": window.units, "failed": window.failed, "metrics": metrics,
           "device": device}
    if trace is not None:
        device.update(busy_s=trace.busy_s, window_s=trace.wall_s)
        out["breakdown"] = trace.breakdown()
        print(json.dumps({"device_ms_a_unit_by_range": trace.by_range(),
                          "units": trace.units}), file=sys.stderr)
    q = statistics.quantiles(window.unit_s, n=4) if window.units > 1 else [0.0] * 3
    print(json.dumps({"unit_ms_quartiles": [1e3 * v for v in q],
                      "unit_ms_max": 1e3 * max(window.unit_s, default=0.0),
                      "gc_ms_in_window_by_generation": collected}), file=sys.stderr)
    out["checks"] = checks
    return out
