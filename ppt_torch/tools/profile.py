"""Where a step's device time goes, from a torch.profiler trace.

Counterpart of ``ppt_tpu/tools/profile.py`` for the card. Builds
full-width ULIP-PointBERT (weights from ``--seed``), warms up, then
profiles ``--batches`` steps on synthetic clouds, each ending in
``torch.cuda.synchronize()``: recognition steps with the text embedding
cached, or with ``--train`` prompt-tuning train steps (augmentation,
training-mode point tower, text tower forward and backward, AdamW on the
trainable partition). Prints one JSON object: wall time per batch on the
host clock, the device's busy and idle share of that window (union of
kernel intervals), device time per batch for each part of the point tower
(the port's kernels by CUDA kernel name) and for everything else, and the
largest other kernels. ``--train`` adds the step's sections (CUDA events
around augmentation, point tower, text tower forward + loss, backward,
optimizer; each includes the gaps in which the device waits for the host).

    python -m ppt_torch.tools.profile [--batch 32] [--npoints 1024] \
        [--batches 5] [--compute_dtype bfloat16]
    python -m ppt_torch.tools.profile --train [--batch 30] [--head_type 0]
"""

from __future__ import annotations

import argparse
import collections
import json
import time

import torch
from torch.autograd import DeviceType

from ppt_torch.data.augment import train_augment
from ppt_torch.data.datasets import make_synthetic
from ppt_torch.models.losses import smoothed_cross_entropy
from ppt_torch.models.ulip import PromptArrays, build_model, trainable_mask
from ppt_torch.prompt.learner import build_prompt_spec
from ppt_torch.tasks.args import TaskArgs
from ppt_torch.train.eval import make_cached_text_eval
from ppt_torch.train.optim import build_optimizer, build_schedule
from ppt_torch.train.trainer import create_train_state, make_train_step
from ppt_torch.utils.device import resolve_device

# substring of the CUDA kernel's name -> the part of the step it belongs to
PARTS = (
    ("fps_kernel", "fps_batched"),
    ("knn_kernel", "knn_gather"),
    ("mini_forward", "mini_forward"),
    ("mini_stats", "mini_stats"),
    ("m2_reduce_kernel", "mini_stats"),
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


def _setup(batch, npoints, compute_dtype, seed):
    dev = resolve_device(None)  # the card; no CPU fallback
    args = TaskArgs(npoints=npoints, batch_size=batch, num_learnable_prompt_tokens=32,
                    class_name_position="middle", compute_dtype=compute_dtype, seed=seed)
    classnames = args.load_classnames()
    prompts = PromptArrays.from_spec(
        build_prompt_spec(classnames, n_ctx=32, class_name_position="middle"), device=dev)
    model = build_model("ULIP_PointBERT", args, device=dev).model
    ds = make_synthetic(num_classes=len(classnames), samples_per_class=-(-batch // len(classnames)),
                        npoints=npoints, seed=seed + 1, classnames=classnames)
    pc = torch.from_numpy(ds.points[:batch]).to(dev)
    label = torch.from_numpy(ds.labels[:batch]).long().to(dev)
    return dev, model, prompts, pc, label


def _profile(step, batches: int) -> dict:
    """Profile ``batches`` calls of ``step()``, each followed by a
    synchronize; wall, busy and idle of that window and device time by part."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(batches):
            step()
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
        "batches": batches,
        "wall_ms_per_batch": wall_us / batches / 1e3,
        "device_busy_ms_per_batch": busy / batches / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
        "device_kernels_per_batch": len(kernels) / batches,
        "device_ms_per_batch": {k: v / batches / 1e3 for k, v in by_part.most_common()},
        "top_other_kernels_ms_per_batch": {k: v / batches / 1e3
                                           for k, v in by_name.most_common(8)},
    }


def profile_step(batch: int = 32, npoints: int = 1024, batches: int = 5,
                 compute_dtype: str = "bfloat16", seed: int = 0) -> dict:
    _, model, prompts, pc, _ = _setup(batch, npoints, compute_dtype, seed)
    embed_fn, step_fn = make_cached_text_eval(model)
    text_embed = embed_fn(model, prompts)
    for _ in range(2):
        step_fn(model, {"pc": pc}, text_embed)
    torch.cuda.synchronize()
    out = _profile(lambda: step_fn(model, {"pc": pc}, text_embed), batches)
    return {"step": "eval", "compute_dtype": compute_dtype, "batch": batch, "npoints": npoints,
            **out}


def profile_train_step(batch: int = 30, npoints: int = 1024, batches: int = 5,
                       compute_dtype: str = "bfloat16", seed: int = 0,
                       head_type: int = 0, smoothing: float = 0.2) -> dict:
    """The published PPT-Base recipe's step (AdamW, cosine schedule over 250
    epochs of ModelNet40's 9843 // batch steps) on one synthetic batch."""
    _, model, prompts, pc, label = _setup(batch, npoints, compute_dtype, seed)
    sched = build_schedule("cosine", 3e-3, 250, 9843 // batch, final_lr=1e-5, warmup_epochs=1,
                           warmup_start_lr=1e-6)
    state = create_train_state(
        model, trainable_mask(model, head_type=head_type),
        lambda tr: build_optimizer("adamw", tr.items(), sched), seed=seed + 1)
    step_fn = make_train_step(smoothing=smoothing)

    def step():
        b = {"pc": train_augment(state.generator, pc), "label": label}
        return float(step_fn(state, b, prompts)[1]["loss"])  # train_loop reads the loss every step too

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    out = _profile(step, batches)

    # the same step cut into sections, CUDA events between them
    names = ("augmentation", "point tower (train mode)", "text tower forward + loss",
             "backward", "optimizer")
    sums = collections.Counter()
    for _ in range(batches):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        ev[0].record()
        aug = train_augment(state.generator, pc)
        ev[1].record()
        pc_embed = model.encode_pc(aug, train=True, generator=state.generator)
        ev[2].record()
        logits = torch.exp(model.logit_scale) * pc_embed @ model.encode_text(prompts).t()
        loss = smoothed_cross_entropy(logits, label, smoothing)
        ev[3].record()
        keys = list(state.trainable)
        grads = torch.autograd.grad(loss, [state.trainable[k] for k in keys])
        ev[4].record()
        state.optimizer.step(dict(zip(keys, grads)))
        ev[5].record()
        torch.cuda.synchronize()
        for i, name in enumerate(names):
            sums[name] += ev[i].elapsed_time(ev[i + 1])
    return {"step": "train", "compute_dtype": compute_dtype, "batch": batch, "npoints": npoints,
            "head_type": head_type, **out,
            "clouds_per_sec": batch / out["wall_ms_per_batch"] * 1e3,
            "section_ms_per_batch": {k: sums[k] / batches for k in names}}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--train", action="store_true", help="profile the train step")
    p.add_argument("--head_type", type=int, default=0)
    p.add_argument("--batch", type=int, default=None, help="default 32 (eval), 30 (--train)")
    p.add_argument("--npoints", type=int, default=1024)
    p.add_argument("--batches", type=int, default=5)
    p.add_argument("--compute_dtype", default="bfloat16", choices=("float32", "bfloat16"))
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    if a.train:
        out = profile_train_step(a.batch or 30, a.npoints, a.batches, a.compute_dtype, a.seed,
                                 a.head_type)
    else:
        out = profile_step(a.batch or 32, a.npoints, a.batches, a.compute_dtype, a.seed)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
