"""Part segmentation task (ShapeNetPart): prompt tuning and evaluation.

Counterpart of ``ppt_tpu/tasks/partseg.py`` (``setup``, ``validate``,
``train_loop``, ``main``): dense per-point classification over the 50 part
names of ``assets/labels.json["shapenetpart"]`` with
``ULIP_PointBERT_partseg``, whose PointBERT trunk is tapped at blocks 3, 7
and 11 and propagated back to every point. Evaluation refines each
sample's predictions to its object category's part range before the argmax
and reports accuracy, instance mIoU and category mIoU; the best epoch is
the one with the highest instance mIoU, and its trainable partition is
checkpointed. Training augments each batch with ``translate_pointcloud``
from its own generator (``args.seed + 2``) and never shuffles points (the
labels are per point). ShapeNetPart is evaluated on its ``val`` split,
other datasets on ``test``; without the dataset's files the clouds are
synthetic with part labels.

    python -m ppt_torch.tasks.partseg \\
        --config configs/experiments/partseg_shapenetpart.yaml [--set epochs=1 ...] \\
        [--device cpu]
    # evaluate a checkpoint
    python -m ppt_torch.tasks.partseg --config ... --evaluate_3d --test_ckpt_addr outputs/partseg
"""

from __future__ import annotations

import json
import logging
import math
import os
import sys
import time
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from ppt_torch.data.augment import translate_pointcloud
from ppt_torch.data.datasets import SHAPENETPART_PART_RANGES, build_dataset
from ppt_torch.data.loader import Loader
from ppt_torch.models.ulip import trainable_mask
from ppt_torch.tasks.args import TaskArgs, parse_args
from ppt_torch.tasks.cls import prompts_and_model
from ppt_torch.train.checkpoint import load_checkpoint, save_checkpoint
from ppt_torch.train.optim import build_optimizer
from ppt_torch.train.schedules import cosine_with_warmup
from ppt_torch.train.trainer import create_train_state, make_eval_step, make_train_step
from ppt_torch.utils.device import resolve_device
from ppt_torch.utils.logging_utils import ExperimentLogger
from ppt_torch.utils.metrics import Meter, partseg_ious, refine_partseg_logits

log = logging.getLogger(__name__)

LABELS_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "assets", "labels.json")


def part_names():
    with open(LABELS_PATH) as f:
        return json.load(f)["shapenetpart"]


def setup(args: TaskArgs) -> Dict:
    """Datasets, the 50 part prompts, model, trainable partition (prompt,
    head type's ``block_11`` leaves, the segmentation heads), cosine
    schedule with warmup, optimizer and train state on ``args.device`` (the
    card if empty)."""
    args.task = "partseg"
    device = resolve_device(args.device or None)
    train_ds = build_dataset(args.dataset_name, args, "train")
    eval_split = "val" if args.dataset_name == "shapenetpart" else "test"
    test_ds = build_dataset(args.dataset_name, args, eval_split)
    prompts, model = prompts_and_model(args, part_names(), device)

    mask = trainable_mask(model, head_type=args.head_type, task="partseg")
    log.info("trainable params: %d",
             sum(p.numel() for name, p in model.named_parameters() if mask[name]))
    steps_per_epoch = max(len(train_ds) // args.batch_size, 1)
    sched = cosine_with_warmup(args.lr, args.lr_end, args.epochs, steps_per_epoch,
                               warmup_epochs=args.warmup_epochs, warmup_start_lr=args.lr_start)
    state = create_train_state(
        model, mask,
        lambda trainable: build_optimizer(
            args.optim, trainable.items(), sched, weight_decay=args.wd, betas=args.betas,
            eps=args.eps, grad_norm_clip=args.grad_norm_clip),
        seed=args.seed + 1,
    )
    return {"train_ds": train_ds, "test_ds": test_ds, "prompts": prompts, "model": model,
            "state": state, "device": device, "steps_per_epoch": steps_per_epoch,
            "sched": sched}


def device_batch(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {"pc": torch.from_numpy(batch["pc"].astype(np.float32)).to(device),
            "label": torch.from_numpy(batch["label"].astype(np.int64)).to(device),
            "cls_onehot": torch.from_numpy(batch["cls_onehot"]).to(device)}


def validate(state, eval_fn, test_ds, prompts, args: TaskArgs, device) -> Dict:
    """Refined predictions over ``test_ds`` and their ``partseg_ious``
    (floats, and ``category_ious`` as a numpy array)."""
    part_ranges = torch.from_numpy(SHAPENETPART_PART_RANGES).to(device)
    preds, labels, cats = [], [], []
    for batch in Loader(test_ds, batch_size=args.batch_size):
        valid = torch.from_numpy(batch["valid"]).to(device)
        b = device_batch(batch, device)
        category = torch.from_numpy(batch["category"].astype(np.int64)).to(device)
        logits = eval_fn(state, b, prompts)
        preds.append(refine_partseg_logits(logits, category, part_ranges)[valid])
        labels.append(b["label"][valid])
        cats.append(category[valid])
    ious = partseg_ious(torch.cat(preds), torch.cat(labels), torch.cat(cats), part_ranges, 16)
    return {k: (v.cpu().numpy() if v.dim() else float(v)) for k, v in ious.items()}


def train_loop(args: TaskArgs, ctx: Dict) -> Dict:
    state, prompts, device = ctx["state"], ctx["prompts"], ctx["device"]
    train_ds, test_ds = ctx["train_ds"], ctx["test_ds"]
    step_fn = make_train_step(smoothing=args.label_smoothing, partseg=True,
                              second_order=args.optim.lower() == "adahessian")
    eval_fn = make_eval_step(partseg=True)
    loader = Loader(train_ds, batch_size=args.batch_size, shuffle=True, drop_last=True,
                    seed=args.seed)
    aug_gen = torch.Generator(device=device).manual_seed(args.seed + 2)
    exp_log = ExperimentLogger(args, task_name="partseg")

    best = {"instance_miou": 0.0}
    best_epoch = -1
    history = []
    for epoch in range(args.start_epoch, args.epochs):
        loader.set_epoch(epoch)
        loss_meter, acc_meter = Meter("loss"), Meter("acc")
        t0 = time.time()
        for batch in loader:
            b = device_batch(batch, device)
            b["pc"] = translate_pointcloud(aug_gen, b["pc"])  # no point shuffle: labels per point
            state, metrics = step_fn(state, b, prompts)
            loss_meter.update(float(metrics["loss"]), len(batch["label"]))
            acc_meter.update(float(metrics["acc"]), len(batch["label"]))
            if not math.isfinite(loss_meter.avg):
                raise FloatingPointError(f"non-finite loss at epoch {epoch}")
        entry = {"epoch": epoch, "loss": loss_meter.avg, "train_acc": acc_meter.avg,
                 "epoch_time": time.time() - t0}
        if (epoch % args.eval_freq) == 0 or epoch == args.epochs - 1:
            val = validate(state, eval_fn, test_ds, prompts, args, device)
            scalars = {k: v for k, v in val.items() if isinstance(v, float)}
            entry.update(scalars)
            if val["instance_miou"] > best["instance_miou"]:
                best, best_epoch = scalars, epoch
                if args.output_dir:
                    save_checkpoint(os.path.join(args.output_dir, args.exp_name or "partseg"),
                                    state, meta={"epoch": epoch, **best})
        history.append(entry)
        exp_log.log(entry, step=epoch)
        log.info("epoch %d: %s", epoch, entry)

    exp_log.close()
    ctx["state"] = state
    return {"best": best, "best_epoch": best_epoch, "history": history}


def main(args: Optional[Union[TaskArgs, Sequence[str]]] = None) -> Dict:
    if not isinstance(args, TaskArgs):
        args = parse_args(args)
    logging.basicConfig(level=logging.INFO)
    args.model = args.model if "partseg" in args.model else "ULIP_PointBERT_partseg"
    ctx = setup(args)
    if args.evaluate_3d:
        if args.test_ckpt_addr:
            ctx["state"] = load_checkpoint(args.test_ckpt_addr, ctx["state"])
        val = validate(ctx["state"], make_eval_step(partseg=True), ctx["test_ds"],
                       ctx["prompts"], args, ctx["device"])
        log.info("eval instance_miou=%.2f category_miou=%.2f accuracy=%.2f",
                 val["instance_miou"], val["category_miou"], val["accuracy"])
        return {"best": {k: v for k, v in val.items() if isinstance(v, float)},
                "best_epoch": -1, "history": []}
    return train_loop(args, ctx)


if __name__ == "__main__":
    main(sys.argv[1:])
