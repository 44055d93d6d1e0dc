"""Where a step's device time goes, from a torch.profiler trace.

Counterpart of ``ppt_tpu/tools/profile.py`` for the card. Builds
``--model`` at full width (ULIP-PointBERT unless told otherwise; the
height channel is on for ULIP_PN_NEXT; weights from ``--seed``), warms up, then
profiles ``--batches`` steps on synthetic clouds, each ending in
``torch.cuda.synchronize()``: recognition steps with the text embedding
cached, or with ``--train`` prompt-tuning train steps (augmentation,
training-mode point tower, text tower forward and backward, AdamW on the
trainable partition; ``--text_route`` puts the text tower on the plain
modules, the block kernel or the tower kernels). Prints one JSON object:
wall time per batch on the host clock, the device's busy and idle share of that window (union of
kernel intervals), device time per batch for each part of the point tower
(the port's kernels by CUDA kernel name) and for everything else, the
largest other kernels, and the text kernels by template instantiation
(launches and ms; a GEMM's arguments are its tile rows, whether W is read
transposed, and its epilogue), and the point tower's time by module (CUDA
events around each of its children: stem, SA stages, head; the library
kernels of an SA layer's MLP cannot be told from the head's by name).
``--point_route`` puts PointBERT's trunk on one of its routes and
``--num_group`` sets its group count (1024 with ``--npoints 8192`` is the
long-sequence trunk: 1025 tokens, every route on ``flash_mha``).
``--train`` adds the step's sections (CUDA events
around augmentation, point tower, text tower forward + loss, backward,
optimizer; each includes the gaps in which the device waits for the host).
``--train pretrain`` profiles ULIP pretraining's step instead (the whole
point tower trains against captions through the frozen text tower; 1024
groups over 8192 points by default, the long trunk, where every block runs
``flash_mha``'s backward kernels); ``--train --num_group 1024 --npoints
8192 --head_type 3`` is the long trunk's prompt-tuning step, one backward
in ``block_11``. ``--train dvae`` profiles PointBERT's dVAE pretraining
step (``DvaeConfig()``, B=64 x N=1024; ``--recon emd`` for the auction-EMD
loss) and ``--train mpm`` its masked-point-modeling step
(``PointBertConfig()`` against a frozen dVAE, B=32 x N=1024), with their
own sections. ``--flops`` prints ``step_profile``'s table instead, for the
recognition batch or (``--train``) the prompt-tuning step: each section's
FLOPs as ``FlopCounterMode`` counts them (the ``ppt`` operators by their
registered formulas), its device ms, TFLOP/s and share of the H100's dense
bf16 peak, and the same for the whole step.

    python -m ppt_torch.tools.profile [--batch 32] [--npoints 1024] \
        [--batches 5] [--compute_dtype bfloat16]
    python -m ppt_torch.tools.profile --train [--batch 30] [--head_type 0] \
        [--text_route off|block|tower]
    python -m ppt_torch.tools.profile --model ULIP_PN_NEXT --batch 128 [--train]
    python -m ppt_torch.tools.profile --point_route tower|unfused|plain
    python -m ppt_torch.tools.profile --num_group 1024 --npoints 8192   # the long trunk
    python -m ppt_torch.tools.profile --train --num_group 1024 --npoints 8192 --head_type 3
    python -m ppt_torch.tools.profile --train pretrain [--num_group 512 --npoints 1024]
    python -m ppt_torch.tools.profile --train dvae [--recon emd]
    python -m ppt_torch.tools.profile --train mpm
    python -m ppt_torch.tools.profile --flops [--train]
"""

from __future__ import annotations

import argparse
import collections
import json
import time

import torch
from torch.autograd import DeviceType
from torch.utils.flop_counter import FlopCounterMode

from ppt_torch.data.augment import append_height, train_augment
from ppt_torch.data.datasets import make_synthetic
from ppt_torch.models.losses import smoothed_cross_entropy, ulip_contrastive_loss
from ppt_torch.models.ulip import MODEL_REGISTRY, PromptArrays, build_model, trainable_mask
from ppt_torch.nn.dvae import DiscreteVAE, DvaeConfig, dvae_loss, init_dvae
from ppt_torch.nn.mpm import PointBertMPM, dvae_tokenize, init_mpm, mpm_loss, sample_group_mask
from ppt_torch.nn.pointbert import POINT_ROUTES, PointBertConfig, group_points
from ppt_torch.nn.text import TEXT_ROUTES
from ppt_torch.prompt.learner import build_prompt_spec
from ppt_torch.tasks.args import TaskArgs
from ppt_torch.train.eval import make_cached_text_eval
from ppt_torch.train.optim import build_optimizer, build_schedule
from ppt_torch.tasks.dvae_pretrain import make_dvae_step
from ppt_torch.tasks.mpm_pretrain import make_mpm_step
from ppt_torch.tasks.pretrain import build_caption_bank, make_pretrain_step
from ppt_torch.train.trainer import create_train_state, make_train_step
from ppt_torch.utils.device import resolve_device, resolve_dtype

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
    # fps_single and ball_query_gather_v2 launch fps_batched_kernel and
    # ball_query_kernel: a trace counts them in those two parts
    ("fps_batched_kernel", "fps_batched"),
    ("knn_gather_kernel", "knn_gather"),
    ("knn_single_kernel", "knn_single"),
    ("ball_query_feats_kernel", "ball_query_gather_feats"),
    ("ball_query_kernel", "ball_query_gather"),
    ("ball_floor_kernel", "ball query: launch floor"),  # chip_smoke.py's measurement alone
    ("mini_forward", "mini_forward"),
    ("mini_stats", "mini_stats"),
    ("m2_reduce_kernel", "mini_stats"),
    ("add_ln_kernel", "vit block: add + LayerNorm"),
    ("add_ln_rows_kernel", "vit block: add + LayerNorm"),
    ("gemm_wgmma_kernel", "vit block: GEMMs"),
    ("gemm_f32_kernel", "vit block: GEMMs"),
    # the whole-row kernels serve the block and, on the "unfused" route, fused_mha
    # (bf16: attention_wgmma_kernel; attention_bf16_kernel is the probe's)
    ("attention_wgmma_kernel", "vit block: attention"),
    ("attention_bf16_kernel", "vit block: attention"),
    ("attention_f32_kernel", "vit block: attention"),
    ("flash_fwd_wgmma_kernel", "flash_mha"),
    ("flash_f32_kernel", "flash_mha"),
    ("flash_bwd_", "flash_mha_bwd"),
    ("readout_kernel", "vit block: readout"),
    ("nn_dists_kernel", "chamfer_nn_dists"),
    ("nn_floor_kernel", "chamfer_nn_dists: launch floor"),  # chip_smoke.py's measurement alone
    ("approx_match_warp_kernel", "approx_match"),
    ("approx_match_kernel", "approx_match"),
    ("approx_match_floor_kernel", "approx_match: launch floor"),  # chip_smoke.py's alone
)


def part_of(kernel_name: str) -> str:
    for key, part in PARTS:
        if key in kernel_name:
            return part
    return "other (library kernels)"


def exclusive_us(intervals) -> list:
    """Each [start, end) interval's share of their union, in the given
    order: the time it ran while no interval that started earlier was
    still running. A kernel launched with programmatic dependent launch
    (the text kernels) starts while the kernel before it drains and waits;
    this charges that overlap to the kernel that was running. The shares
    sum to busy_us of the same intervals."""
    order = sorted(range(len(intervals)), key=lambda i: intervals[i][0])
    share, covered = [0.0] * len(intervals), float("-inf")
    for i in order:
        s, e = intervals[i]
        share[i] = max(0.0, e - max(s, covered))
        covered = max(covered, e)
    return share


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


def takes_height(model_name: str) -> bool:
    """PointNeXt-S is published with the height as a 4th input channel."""
    return model_name == "ULIP_PN_NEXT"


def _setup(batch, npoints, compute_dtype, seed, text_route="off", model_name="ULIP_PointBERT",
           point_route="block", num_group=512, device=None, shrink=None):
    """``device``: the card unless given; ``shrink``: (PointBertConfig,
    TextConfig, prompt tokens) in place of the full widths (the tests')."""
    dev = resolve_device(device)  # the card unless told otherwise; no CPU fallback
    n_ctx = shrink[2] if shrink else 32
    args = TaskArgs(npoints=npoints, batch_size=batch, num_learnable_prompt_tokens=n_ctx,
                    class_name_position="middle", compute_dtype=compute_dtype, seed=seed,
                    model=model_name, use_height=takes_height(model_name))
    args.pointbert_config = shrink[0] if shrink else PointBertConfig(num_group=num_group)
    args.text_config = shrink[1] if shrink else None
    args.point_route = point_route
    classnames = args.load_classnames()
    prompts = PromptArrays.from_spec(
        build_prompt_spec(classnames, n_ctx=n_ctx, class_name_position="middle"), device=dev)
    model = build_model(model_name, args, device=dev, text_fused=text_route).model
    ds = make_synthetic(num_classes=len(classnames), samples_per_class=-(-batch // len(classnames)),
                        npoints=npoints, seed=seed + 1, classnames=classnames)
    pc = torch.from_numpy(ds.points[:batch]).to(dev)
    label = torch.from_numpy(ds.labels[:batch]).long().to(dev)
    return dev, model, prompts, pc, label


def tower_section(child_name: str) -> str:
    """The point tower's child module -> the section its time is summed
    under: the head's layers together, everything else by its own name."""
    return "head" if child_name.startswith("head") else child_name


def tower_sections_ms(tower: torch.nn.Module, step, batches: int) -> dict:
    """ms per batch under each child of ``tower``: CUDA events at its
    forward's start and end (the gaps in which the device waits for the
    host are inside), summed by :func:`tower_section`."""
    spans, handles = [], []
    for name, child in tower.named_children():
        def before(mod, args, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            spans.append([tower_section(name), ev, None])

        def after(mod, args, out):
            spans[-1][2] = torch.cuda.Event(enable_timing=True)
            spans[-1][2].record()

        handles += [child.register_forward_pre_hook(before), child.register_forward_hook(after)]
    try:
        for _ in range(batches):
            step()
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    sums = collections.Counter()
    for section, start, end in spans:
        sums[section] += start.elapsed_time(end)
    return {k: v / batches for k, v in sums.items()}


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
    text_us, text_n = collections.Counter(), collections.Counter()
    shares = exclusive_us([(e.time_range.start, e.time_range.end) for e in kernels])
    for e, us in zip(kernels, shares):
        by_part[part_of(e.name)] += us
        if part_of(e.name).startswith("other"):
            by_name[e.name[:80]] += us
        elif "text::" in e.name:  # per template instantiation: tile rows, W^T, epilogue
            inst = e.name.split("text::", 1)[1].split("(", 1)[0]
            text_us[inst] += us
            text_n[inst] += 1
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
        "text_kernels_per_batch": {k: {"launches": text_n[k] / batches,
                                       "ms": v / batches / 1e3}
                                   for k, v in text_us.most_common()},
    }


def profile_calls(fn, calls: int = 5) -> dict:
    """The profile of ``calls`` calls of ``fn``, each followed by a
    synchronize: device ms a call by part of :data:`PARTS` and the text
    kernels' launches and ms a call, as :func:`profile_step` reports a
    batch."""
    return _profile(fn, calls)


def _sections(names, run, batches: int) -> dict:
    """ms per batch of the sections of ``run(mark)``, which calls
    ``mark()`` at the end of each section named in ``names``: CUDA events
    between them (each includes the gaps in which the device waits)."""
    sums = collections.Counter()
    for _ in range(batches):
        ev = [torch.cuda.Event(enable_timing=True)]
        ev[0].record()

        def mark():
            ev.append(torch.cuda.Event(enable_timing=True))
            ev[-1].record()

        run(mark)
        torch.cuda.synchronize()
        for i, name in enumerate(names):
            sums[name] += ev[i].elapsed_time(ev[i + 1])
    return {k: sums[k] / batches for k in names}


def _grads(state, loss):
    keys = list(state.trainable)
    return keys, torch.autograd.grad(loss, [state.trainable[k] for k in keys])


def _train_run(state, augment, loss_of, text_section: str):
    """(names, run(mark)) of a train step's sections: ``augment()``, the
    point tower in training mode, ``text_section`` (the text tower and
    ``loss_of(pc_embed)``), backward, AdamW."""
    model = state.model

    def run(mark):
        pc = augment()
        mark()
        pc_embed = model.encode_pc(pc, train=True, generator=state.generator)
        mark()
        loss = loss_of(pc_embed)
        mark()
        keys, grads = _grads(state, loss)
        mark()
        state.optimizer.step(dict(zip(keys, grads)))
        mark()

    return ("augmentation", "point tower (train mode)", text_section, "backward",
            "optimizer"), run


def _train_sections(state, augment, loss_of, text_section: str, batches: int) -> dict:
    """ms per batch of a train step's sections (``_train_run``)."""
    names, run = _train_run(state, augment, loss_of, text_section)
    return _sections(names, run, batches)


def profile_step(batch: int = 32, npoints: int = 1024, batches: int = 5,
                 compute_dtype: str = "bfloat16", seed: int = 0,
                 model_name: str = "ULIP_PointBERT", point_route: str = "block",
                 num_group: int = 512) -> dict:
    _, model, prompts, pc, _ = _setup(batch, npoints, compute_dtype, seed, model_name=model_name,
                                      point_route=point_route, num_group=num_group)
    embed_fn, step_fn = make_cached_text_eval(model)
    text_embed = embed_fn(model, prompts)

    def step():  # as `validate` takes a batch: the height is appended on the card
        x = append_height(pc) if takes_height(model_name) else pc
        return step_fn(model, {"pc": x}, text_embed)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    out = _profile(step, batches)
    return {"step": "eval", "model": model_name, "compute_dtype": compute_dtype, "batch": batch,
            "npoints": npoints, "point_route": point_route, "num_group": num_group, **out,
            "clouds_per_sec": batch / out["wall_ms_per_batch"] * 1e3,
            "tower_section_ms_per_batch": tower_sections_ms(model.point_encoder, step, batches)}


def profile_train_step(batch: int = 30, npoints: int = 1024, batches: int = 5,
                       compute_dtype: str = "bfloat16", seed: int = 0,
                       head_type: int = 0, smoothing: float = 0.2,
                       text_route: str = "off", model_name: str = "ULIP_PointBERT",
                       point_route: str = "block", num_group: int = 512) -> dict:
    """The published PPT-Base recipe's step (AdamW, cosine schedule over 250
    epochs of ModelNet40's 9843 // batch steps) on one synthetic batch, with
    the text tower on ``text_route`` ("off", "block" or "tower")."""
    _, model, prompts, pc, label = _setup(batch, npoints, compute_dtype, seed, text_route,
                                          model_name, point_route, num_group)
    height = takes_height(model_name)
    sched = build_schedule("cosine", 3e-3, 250, 9843 // batch, final_lr=1e-5, warmup_epochs=1,
                           warmup_start_lr=1e-6)
    state = create_train_state(
        model, trainable_mask(model, head_type=head_type),
        lambda tr: build_optimizer("adamw", tr.items(), sched), seed=seed + 1)
    step_fn = make_train_step(smoothing=smoothing)

    def step():
        b = {"pc": train_augment(state.generator, pc, use_height=height), "label": label}
        return float(step_fn(state, b, prompts)[1]["loss"])  # train_loop reads the loss every step too

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    out = _profile(step, batches)

    # the same step cut into sections, CUDA events between them
    sections = _train_sections(
        state, lambda: train_augment(state.generator, pc, use_height=height),
        lambda pc_embed: smoothed_cross_entropy(
            torch.exp(model.logit_scale) * pc_embed @ model.encode_text(prompts).t(), label,
            smoothing),
        "text tower forward + loss", batches)
    return {"step": "train", "model": model_name, "compute_dtype": compute_dtype, "batch": batch,
            "npoints": npoints, "head_type": head_type, "text_route": text_route,
            "point_route": point_route, "num_group": num_group, **out,
            "clouds_per_sec": batch / out["wall_ms_per_batch"] * 1e3,
            "section_ms_per_batch": sections}


def profile_pretrain_step(batch: int = 32, npoints: int = 8192, batches: int = 3,
                          compute_dtype: str = "bfloat16", seed: int = 0,
                          text_route: str = "off", point_route: str = "block",
                          num_group: int = 1024) -> dict:
    """ULIP pretraining's step (``tasks/pretrain.py:make_pretrain_step``:
    AdamW on the point tower, ``pc_projection`` and ``logit_scale``) on one
    synthetic batch with a ``shapenet_64`` caption per cloud."""
    dev, model, _, pc, label = _setup(batch, npoints, compute_dtype, seed, text_route,
                                      "ULIP_PointBERT", point_route, num_group)
    names = TaskArgs(dataset_name="modelnet40").load_classnames()
    tokens = torch.from_numpy(build_caption_bank(names)[label.cpu().numpy(), 0]).to(dev)
    state = create_train_state(  # a constant rate: the step's cost does not depend on it
        model, trainable_mask(model, task="pretrain"),
        lambda tr: build_optimizer("adamw", tr.items(), lambda step: 3e-3), seed=seed + 1)
    step_fn = make_pretrain_step(model, state.optimizer)

    def step():
        b = {"pc": train_augment(state.generator, pc)}
        return float(step_fn(state, b, tokens)[1]["loss"])

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    out = _profile(step, batches)

    sections = _train_sections(
        state, lambda: train_augment(state.generator, pc),
        lambda pc_embed: ulip_contrastive_loss(pc_embed, model.encode_captions(tokens), None,
                                               torch.exp(model.logit_scale))["loss"],
        "text tower (captions) + loss", batches)
    return {"step": "pretrain", "model": "ULIP_PointBERT", "compute_dtype": compute_dtype,
            "batch": batch, "npoints": npoints, "text_route": text_route,
            "point_route": point_route, "num_group": num_group, **out,
            "clouds_per_sec": batch / out["wall_ms_per_batch"] * 1e3,
            "section_ms_per_batch": sections}


def _all_trainable(model, seed):
    """AdamW at a constant rate on every parameter: the step's cost does not
    depend on the rate."""
    return create_train_state(model, {k: True for k, _ in model.named_parameters()},
                              lambda tr: build_optimizer("adamw", tr.items(), lambda s: 1e-4),
                              seed=seed + 1)


def _clouds(batch, npoints, seed, dev):
    ds = make_synthetic(num_classes=40, samples_per_class=-(-batch // 40), npoints=npoints,
                        seed=seed + 1)
    return torch.from_numpy(ds.points[:batch]).to(dev)


def profile_dvae_step(batch: int = 64, npoints: int = 1024, batches: int = 5,
                      compute_dtype: str = "bfloat16", seed: int = 0,
                      recon: str = "chamfer") -> dict:
    """The dVAE pretraining step (``tasks/dvae_pretrain.py:make_dvae_step``:
    the whole dVAE trains; ``recon`` "emd" runs the auction kernel twice a
    step) on one synthetic batch at temperature 1."""
    dev = resolve_device(None)
    model = init_dvae(DiscreteVAE(DvaeConfig(), dtype=resolve_dtype(compute_dtype)), seed).to(dev)
    state = _all_trainable(model, seed)
    step_fn = make_dvae_step(model, state.optimizer, recon=recon)
    pc = _clouds(batch, npoints, seed, dev)

    def step():
        return float(step_fn(state, {"pc": train_augment(state.generator, pc)}, 1.0)[1]["loss"])

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    out = _profile(step, batches)

    def run(mark):
        x = train_augment(state.generator, pc)
        mark()
        ret = model(x, temperature=1.0, train=True, generator=state.generator)
        mark()
        loss_recon, klv = dvae_loss(ret, model.config.num_tokens, recon=recon)
        loss = loss_recon + 0.1 * klv
        mark()
        keys, grads = _grads(state, loss)
        mark()
        state.optimizer.step(dict(zip(keys, grads)))
        mark()

    sections = _sections(("augmentation", "dVAE forward (train mode)", f"loss ({recon})",
                          "backward", "optimizer"), run, batches)
    return {"step": "dvae", "recon": recon, "compute_dtype": compute_dtype, "batch": batch,
            "npoints": npoints, **out, "clouds_per_sec": batch / out["wall_ms_per_batch"] * 1e3,
            "section_ms_per_batch": sections}


def profile_mpm_step(batch: int = 32, npoints: int = 1024, batches: int = 5,
                     compute_dtype: str = "bfloat16", seed: int = 0,
                     point_route: str = "block") -> dict:
    """The masked-point-modeling step (``tasks/mpm_pretrain.py:make_mpm_step``)
    of a PointBERT student at ``PointBertConfig()`` against a frozen dVAE
    (weights from ``seed``) on one synthetic batch."""
    dev = resolve_device(None)
    dt = resolve_dtype(compute_dtype)
    cfg = PointBertConfig()
    dvae = init_dvae(DiscreteVAE(DvaeConfig(group_size=cfg.group_size, num_group=cfg.num_group),
                                 dtype=dt), seed + 10).to(dev).requires_grad_(False)
    student = init_mpm(PointBertMPM(cfg, dtype=dt, route=point_route), seed).to(dev)
    state = _all_trainable(student, seed)
    step_fn = make_mpm_step(student, dvae, state.optimizer, 0.4, cfg.num_group, cfg.group_size)
    pc = _clouds(batch, npoints, seed, dev)

    def step():
        return float(step_fn(state, {"pc": train_augment(state.generator, pc)})[1]["loss"])

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    out = _profile(step, batches)

    def run(mark):
        x = train_augment(state.generator, pc)
        mark()
        nb, ct = group_points(x, cfg.num_group, cfg.group_size)
        mark()
        targets = dvae_tokenize(dvae, nb, ct)
        mask = sample_group_mask(state.generator, batch, cfg.num_group, 0.4, device=dev)
        mark()
        loss, _ = mpm_loss(student(nb, ct, mask, train=True, generator=state.generator),
                           targets, mask)
        mark()
        keys, grads = _grads(state, loss)
        mark()
        state.optimizer.step(dict(zip(keys, grads)))
        mark()

    sections = _sections(("augmentation", "grouping", "dVAE tokenizer (frozen)",
                          "student forward (train mode) + loss", "backward", "optimizer"),
                         run, batches)
    return {"step": "mpm", "compute_dtype": compute_dtype, "batch": batch, "npoints": npoints,
            "point_route": point_route, **out,
            "clouds_per_sec": batch / out["wall_ms_per_batch"] * 1e3,
            "section_ms_per_batch": sections}


PEAK_BF16_TFLOPS = 989.0  # one H100 SXM, dense bf16 tensor cores (PERF.md §6's figure)


def section_flops(names, run) -> dict:
    """The FLOPs of each section of ``run(mark)`` (``mark()`` ends one), as
    ``FlopCounterMode`` counts them: the library's formulas and the ``ppt``
    operators' (``kernels/_ops.py``); elementwise work counts nothing."""
    at = []
    with FlopCounterMode(display=False) as counter:
        run(lambda: at.append(counter.get_total_flops()))
    return {name: end - start for name, start, end in zip(names, [0] + at, at)}


def flop_table(names, run, batches: int, on_card: bool) -> dict:
    """Each section's FLOPs, and on the card its device ms a step (CUDA events,
    ``_sections``), TFLOP/s and share of the H100's dense bf16 peak; the
    same for the whole step, whose FLOPs are counted over one step of its
    own (the sections must add up to it). Off the card every time is None:
    not measured."""
    flops = section_flops(names, run)
    with FlopCounterMode(display=False) as counter:
        run(lambda: None)
    total = counter.get_total_flops()
    ms = _sections(names, run, batches) if on_card else {}

    def row(gflop, t):
        rate = gflop / t if t else None  # GFLOP / ms = TFLOP/s
        return {"gflop": gflop, "ms": t, "tflops": rate,
                "peak_share": rate / PEAK_BF16_TFLOPS if rate is not None else None}

    table = {name: row(flops[name] / 1e9, ms.get(name)) for name in names}
    return {"sections": table,
            "total": row(total / 1e9, sum(ms.values()) if ms else None),
            "sections_gflop_sum": sum(flops.values()) / 1e9,
            "peak_tflops": PEAK_BF16_TFLOPS}


def profile_flops(train: bool = False, batch: int = None, npoints: int = 1024, batches: int = 5,
                  compute_dtype: str = "bfloat16", seed: int = 0, head_type: int = 0,
                  device=None, shrink=None) -> dict:
    """``step_profile``'s table for PPT-Base: the recognition batch (the
    eval step on a cached text embedding), or with ``train`` the
    prompt-tuning step's sections (augmentation, point tower, text forward
    and loss, backward, optimizer). On the card unless ``device`` says
    otherwise (then FLOPs only); ``shrink`` as in ``_setup``."""
    batch = batch or (30 if train else 32)
    dev, model, prompts, pc, label = _setup(batch, npoints, compute_dtype, seed, device=device,
                                            shrink=shrink)
    on_card = dev.type == "cuda"
    if train:
        sched = build_schedule("cosine", 3e-3, 250, 9843 // batch, final_lr=1e-5,
                               warmup_epochs=1, warmup_start_lr=1e-6)
        state = create_train_state(
            model, trainable_mask(model, head_type=head_type),
            lambda tr: build_optimizer("adamw", tr.items(), sched), seed=seed + 1)
        names, run = _train_run(
            state, lambda: train_augment(state.generator, pc),
            lambda pc_embed: smoothed_cross_entropy(
                torch.exp(model.logit_scale) * pc_embed @ model.encode_text(prompts).t(), label,
                0.2),
            "text tower forward + loss")
    else:
        embed_fn, step_fn = make_cached_text_eval(model)
        text_embed = embed_fn(model, prompts)
        names = ("recognition batch",)

        def run(mark):
            step_fn(model, {"pc": pc}, text_embed)
            mark()

    run(lambda: None)  # warm: kernels, caches, the allocator
    out = flop_table(names, run, batches, on_card)
    return {"step": "train" if train else "eval", "model": "ULIP_PointBERT",
            "compute_dtype": compute_dtype, "batch": batch, "npoints": npoints,
            "device": torch.cuda.get_device_name(dev) if on_card else str(dev), **out}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--train", nargs="?", const="cls", choices=("cls", "pretrain", "dvae", "mpm"),
                   help="profile the prompt-tuning train step, or with 'pretrain' ULIP "
                        "pretraining's step, 'dvae' / 'mpm' PointBERT's two pretraining steps")
    p.add_argument("--recon", default="chamfer", choices=("chamfer", "emd"),
                   help="the dVAE's reconstruction loss for --train dvae")
    p.add_argument("--model", default="ULIP_PointBERT", choices=sorted(MODEL_REGISTRY))
    p.add_argument("--head_type", type=int, default=0)
    p.add_argument("--batch", type=int, default=None,
                   help="default 32 (eval, --train pretrain|mpm), 30 (--train), 64 (--train dvae)")
    p.add_argument("--npoints", type=int, default=None,
                   help="default 1024, 8192 with --train pretrain")
    p.add_argument("--batches", type=int, default=5)
    p.add_argument("--compute_dtype", default="bfloat16", choices=("float32", "bfloat16"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--text_route", default="off", choices=TEXT_ROUTES,
                   help="the text tower's route for --train")
    p.add_argument("--point_route", default="block", choices=POINT_ROUTES,
                   help="PointBERT's trunk route")
    p.add_argument("--num_group", type=int, default=None,
                   help="PointBERT's group count: default 512, 1024 with --train pretrain")
    p.add_argument("--flops", action="store_true",
                   help="the FLOP table instead: FLOPs, device ms, TFLOP/s and share of the "
                        "bf16 peak per section, of the recognition batch or (--train) the "
                        "prompt-tuning step")
    a = p.parse_args(argv)
    if a.flops:
        if a.train not in (None, "cls"):
            p.error("--flops covers the recognition batch and the prompt-tuning step (--train)")
        out = profile_flops(a.train == "cls", a.batch, a.npoints or 1024, a.batches,
                            a.compute_dtype, a.seed, a.head_type)
    elif a.train == "dvae":
        out = profile_dvae_step(a.batch or 64, a.npoints or 1024, a.batches, a.compute_dtype,
                                a.seed, recon=a.recon)
    elif a.train == "mpm":
        out = profile_mpm_step(a.batch or 32, a.npoints or 1024, a.batches, a.compute_dtype,
                               a.seed, point_route="block" if a.point_route == "tower"
                               else a.point_route)
    elif a.train == "pretrain":
        out = profile_pretrain_step(a.batch or 32, a.npoints or 8192, a.batches, a.compute_dtype,
                                    a.seed, text_route=a.text_route, point_route=a.point_route,
                                    num_group=a.num_group or 1024)
    elif a.train:
        out = profile_train_step(a.batch or 30, a.npoints or 1024, a.batches, a.compute_dtype,
                                 a.seed, a.head_type, text_route=a.text_route,
                                 model_name=a.model, point_route=a.point_route,
                                 num_group=a.num_group or 512)
    else:
        out = profile_step(a.batch or 32, a.npoints or 1024, a.batches, a.compute_dtype, a.seed,
                           model_name=a.model, point_route=a.point_route,
                           num_group=a.num_group or 512)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
