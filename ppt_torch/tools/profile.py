"""Where the recognition step's device time goes, from a torch.profiler trace.

Counterpart of ``ppt_tpu/tools/profile.py`` for the card. Builds
full-width ULIP-PointBERT (weights from ``--seed``), caches the text
embedding, warms up, then profiles ``--batches`` eval steps on synthetic
clouds, each ending in ``torch.cuda.synchronize()``. Prints one JSON
object: wall time per batch on the host clock, the device's busy and idle
share of that window (union of kernel intervals), device time per batch
for each part of the point tower (the port's kernels by CUDA kernel name)
and for everything else, and the largest other kernels.

    python -m ppt_torch.tools.profile [--batch 32] [--npoints 1024] \
        [--batches 5] [--compute_dtype bfloat16]
"""

from __future__ import annotations

import argparse
import collections
import json
import time

import torch
from torch.autograd import DeviceType

from ppt_torch.data.datasets import make_synthetic
from ppt_torch.models.ulip import PromptArrays, build_model
from ppt_torch.prompt.learner import build_prompt_spec
from ppt_torch.tasks.args import TaskArgs
from ppt_torch.train.eval import make_cached_text_eval
from ppt_torch.utils.device import resolve_device

# substring of the CUDA kernel's name -> the part of the step it belongs to
PARTS = (
    ("fps_kernel", "fps_batched"),
    ("knn_kernel", "knn_gather"),
    ("mini_forward", "mini_forward"),
    ("add_ln_kernel", "vit block: add + LayerNorm"),
    ("gemm_bf16_kernel", "vit block: GEMMs"),
    ("gemm_f32_kernel", "vit block: GEMMs"),
    ("attention_bf16_kernel", "vit block: attention"),
    ("attention_f32_kernel", "vit block: attention"),
    ("readout_kernel", "vit block: readout"),
)


def part_of(kernel_name: str) -> str:
    for key, part in PARTS:
        if key in kernel_name:
            return part
    return "other (library kernels)"


def busy_us(intervals) -> float:
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


def profile_step(batch: int = 32, npoints: int = 1024, batches: int = 5,
                 compute_dtype: str = "bfloat16", seed: int = 0) -> dict:
    dev = resolve_device(None)  # the card; no CPU fallback
    args = TaskArgs(npoints=npoints, batch_size=batch, num_learnable_prompt_tokens=32,
                    class_name_position="middle", compute_dtype=compute_dtype, seed=seed)
    classnames = args.load_classnames()
    prompts = PromptArrays.from_spec(
        build_prompt_spec(classnames, n_ctx=32, class_name_position="middle"), device=dev)
    model = build_model("ULIP_PointBERT", args, device=dev).model
    embed_fn, step_fn = make_cached_text_eval(model)
    ds = make_synthetic(num_classes=len(classnames), samples_per_class=-(-batch // len(classnames)),
                        npoints=npoints, seed=seed + 1, classnames=classnames)
    pc = torch.from_numpy(ds.points[:batch]).to(dev)
    text_embed = embed_fn(model, prompts)
    for _ in range(2):
        step_fn(model, {"pc": pc}, text_embed)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(batches):
            step_fn(model, {"pc": pc}, text_embed)
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    by_part, by_name = collections.Counter(), collections.Counter()
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_part[part_of(e.name)] += us
        if part_of(e.name).startswith("other"):
            by_name[e.name[:80]] += us
    busy = busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    return {
        "device": torch.cuda.get_device_name(0),
        "compute_dtype": compute_dtype, "batch": batch, "npoints": npoints, "batches": batches,
        "wall_ms_per_batch": wall_us / batches / 1e3,
        "device_busy_ms_per_batch": busy / batches / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
        "device_ms_per_batch": {k: v / batches / 1e3 for k, v in by_part.most_common()},
        "top_other_kernels_ms_per_batch": {k: v / batches / 1e3
                                           for k, v in by_name.most_common(8)},
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--npoints", type=int, default=1024)
    p.add_argument("--batches", type=int, default=5)
    p.add_argument("--compute_dtype", default="bfloat16", choices=("float32", "bfloat16"))
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    print(json.dumps(profile_step(a.batch, a.npoints, a.batches, a.compute_dtype, a.seed)))


if __name__ == "__main__":
    main()
