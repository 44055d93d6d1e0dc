"""One run of one cell of ``BENCHMARK.json`` on the card.

    python3 -m h100_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, seeded weights and clouds, the build of the port's CUDA
libraries into ``build/kernels/`` on a first run, warm-up, the checked
first steps) is ``setup_s``; then the window runs for ``--seconds``; with
``--trace 1`` a profiled slice follows. Then the reference judges what the
window produced. The last line of standard output is the result, the
numbers compared and their limits last; the same numbers end standard
error. Without a card, or with fewer than the cell asks for, it prints no
result and exits 2; with ``jax``, ``jaxlib``, ``flax`` or ``ppt_tpu``
loaded once the window has closed, it exits 3.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _cache_dirs() -> None:
    """Every build cache of the program at a fixed path inside the checkout."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    _cache_dirs()
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    entry = next((w for w in bench["workloads"] if w["name"] == a.workload), None)
    if entry is None:
        print(f"no workload {a.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"{a.workload} needs {entry['chips']} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    from h100_bench import cell

    ctx = cell.load(ROOT, a.workload, a.seed, a.seconds, bool(a.trace), "cuda:0", bench)
    result = cell.execute(ctx, STARTED)
    bad = cell.forbidden_modules()
    if bad:
        print(f"loaded after the window: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
