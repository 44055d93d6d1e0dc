"""Recognition task: prompt tuning and evaluation.

Counterpart of ``ppt_tpu/tasks/cls.py`` (``setup``, ``validate``,
``train_loop``, ``main``). Loop structure as the reference's:
per-iteration cosine learning rate with linear warmup, label-smoothed
cross entropy, the logit-scale clamp inside the step, the ``data_ratio``
early break, evaluation every ``eval_freq`` epochs with the text tower
run once per pass, and a best-only checkpoint of the trainable partition.
Without pretrained weights or a checkpoint the weights are random from
``--seed``; without the dataset's files the data is synthetic.

    # train PPT-Base as published (configs/experiments/ppt_base_mn40.yaml)
    python -m ppt_torch.tasks.cls --dataset_name modelnet40 --npoints 1024 \
        --batch_size 30 --class_name_position middle --label_smoothing 0.2 \
        --compute_dtype bfloat16 [--head_type 0..3] [--device cpu]
    # evaluate a checkpoint
    python -m ppt_torch.tasks.cls --evaluate_3d --test_ckpt_addr outputs/cls ...
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

from ppt_torch.data.augment import train_augment
from ppt_torch.data.datasets import build_dataset
from ppt_torch.data.loader import Loader
from ppt_torch.models.ulip import PromptArrays, build_model, trainable_mask
from ppt_torch.prompt.learner import build_prompt_spec
from ppt_torch.tasks.args import TaskArgs, parse_args
from ppt_torch.train.checkpoint import load_checkpoint, save_checkpoint
from ppt_torch.train.eval import make_cached_text_eval
from ppt_torch.train.optim import build_optimizer, build_schedule
from ppt_torch.train.trainer import create_train_state, make_train_multi_step, make_train_step
from ppt_torch.utils.device import resolve_device
from ppt_torch.utils.logging_utils import ExperimentLogger
from ppt_torch.utils.metrics import Meter, per_class_accuracy

log = logging.getLogger(__name__)


def setup(args: TaskArgs) -> Dict:
    """Datasets, prompts, model, trainable partition, schedule, optimizer
    and train state on ``args.device`` (the card if empty), shared by
    training and evaluation."""
    device = resolve_device(args.device or None)
    if args.use_height:
        raise NotImplementedError(
            "--use_height appends a 4th channel, and no ported model takes one yet")
    train_ds = build_dataset(args.dataset_name, args, "train")
    test_ds = build_dataset(args.dataset_name, args, "test")
    if train_ds.name.startswith("synthetic"):
        classnames = train_ds.classnames  # synthetic (incl. fallback) data names its own
    else:
        classnames = args.load_classnames()
    spec = build_prompt_spec(
        classnames,
        n_ctx=args.num_learnable_prompt_tokens,
        class_name_position=args.class_name_position,
        template_init=args.template_init,
    )
    prompts = PromptArrays.from_spec(spec, device=device)
    model = build_model(args.model, args, device=device).model
    if not args.evaluate_3d and args.pretrained_dir and os.path.isdir(args.pretrained_dir):
        raise NotImplementedError(
            f"{args.pretrained_dir} exists, but loading converted pretrained backbones is "
            "not ported yet; pass --pretrained_dir '' to train from seed-initialised weights")

    mask = trainable_mask(model, head_type=args.head_type, task=args.task)
    n_train = sum(p.numel() for name, p in model.named_parameters() if mask[name])
    log.info("trainable params: %d", n_train)

    steps_per_epoch = max(len(train_ds) // args.batch_size, 1)
    sched = build_schedule(
        args.sched, args.lr, args.epochs, steps_per_epoch,
        final_lr=args.lr_end, warmup_epochs=args.warmup_epochs, warmup_start_lr=args.lr_start,
    )
    state = create_train_state(
        model, mask,
        lambda trainable: build_optimizer(
            args.optim, trainable.items(), sched, weight_decay=args.wd, betas=args.betas,
            eps=args.eps),
        seed=args.seed + 1,
    )
    if args.resume:
        state = load_checkpoint(args.resume, state)
        meta_path = os.path.join(args.resume, "checkpoint_best.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                args.start_epoch = json.load(f).get("epoch", -1) + 1
        log.info("resumed from %s at epoch %d", args.resume, args.start_epoch)
    return {
        "classnames": classnames,
        "train_ds": train_ds,
        "test_ds": test_ds,
        "prompts": prompts,
        "model": model,
        "optimizer": state.optimizer,
        "state": state,
        "device": device,
        "steps_per_epoch": steps_per_epoch,
        "sched": sched,
    }


def validate(state, eval_fn, test_ds, prompts, args: TaskArgs, device) -> Dict[str, float]:
    """Eval loop over ``test_ds``; ``state`` is the model and ``eval_fn``
    the (embed, step) pair of ``make_cached_text_eval``."""
    embed_fn, step_fn = eval_fn
    text_embed = embed_fn(state, prompts)
    preds, labels = [], []
    for batch in Loader(test_ds, batch_size=args.batch_size):
        valid = batch["valid"]
        pc = torch.from_numpy(batch["pc"].astype(np.float32)).to(device)
        logits = step_fn(state, {"pc": pc}, text_embed)
        preds.append(logits.argmax(-1).cpu().numpy()[valid])
        labels.append(batch["label"][valid])
    preds = np.concatenate(preds)
    labels = np.concatenate(labels)
    acc = 100.0 * float(np.mean(preds == labels))
    return {"acc1": acc, "per_class": per_class_accuracy(preds, labels, test_ds.num_classes)}


def device_batch(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {"pc": torch.from_numpy(batch["pc"].astype(np.float32)).to(device),
            "label": torch.from_numpy(batch["label"].astype(np.int64)).to(device)}


def train_loop(args: TaskArgs, ctx: Dict) -> Dict[str, float]:
    model, state = ctx["model"], ctx["state"]
    prompts, device = ctx["prompts"], ctx["device"]
    train_ds, test_ds = ctx["train_ds"], ctx["test_ds"]

    if max(args.steps_per_dispatch, 1) > 1:
        make_train_multi_step()
    step_fn = make_train_step(smoothing=args.label_smoothing)
    eval_fn = make_cached_text_eval(model)
    loader = Loader(train_ds, batch_size=args.batch_size, shuffle=True, drop_last=True,
                    seed=args.seed)
    exp_log = ExperimentLogger(args, task_name=args.task)

    best_acc = 0.0
    best_epoch = -1
    history = []
    for epoch in range(args.start_epoch, args.epochs):
        loader.set_epoch(epoch)
        loss_meter, acc_meter = Meter("loss"), Meter("acc")
        t0 = time.time()
        n_batches = len(loader)
        for it, batch in enumerate(loader):
            # data-efficiency early break (main_cls.py:173-174)
            if it / max(n_batches, 1) > args.data_ratio:
                break
            dbatch = device_batch(batch, device)
            dbatch["pc"] = train_augment(state.generator, dbatch["pc"])
            state, metrics = step_fn(state, dbatch, prompts)
            loss_meter.update(float(metrics["loss"]), len(batch["label"]))
            acc_meter.update(float(metrics["acc"]), len(batch["label"]))
            if not math.isfinite(loss_meter.avg):
                raise FloatingPointError(f"non-finite loss at epoch {epoch}")

        entry = {
            "epoch": epoch,
            "loss": loss_meter.avg,
            "train_acc": acc_meter.avg,
            "lr": float(ctx["sched"]((epoch + 1) * ctx["steps_per_epoch"] - 1)),
            "epoch_time": time.time() - t0,
        }
        if (epoch % args.eval_freq) == 0 or epoch == args.epochs - 1:
            val = validate(model, eval_fn, test_ds, prompts, args, device)
            entry["val_acc1"] = val["acc1"]
            if val["acc1"] > best_acc:
                best_acc = val["acc1"]
                best_epoch = epoch
                if args.output_dir:
                    save_checkpoint(
                        os.path.join(args.output_dir, args.exp_name or "cls"),
                        state,
                        meta={
                            "epoch": epoch,
                            "best_acc": best_acc,
                            "args": {k: v for k, v in vars(args).items()
                                     if isinstance(v, (int, float, str, bool))},
                        },
                    )
        history.append(entry)
        exp_log.log(entry, step=epoch)
        log.info("epoch %d: %s", epoch, entry)

    exp_log.close()
    ctx["state"] = state
    return {"best_acc": best_acc, "best_epoch": best_epoch, "history": history}


def main(args: Optional[Union[TaskArgs, Sequence[str]]] = None) -> Dict[str, float]:
    if not isinstance(args, TaskArgs):
        args = parse_args(args)
    logging.basicConfig(level=logging.INFO)
    ctx = setup(args)
    if args.evaluate_3d:
        if args.test_ckpt_addr:
            ctx["state"] = load_checkpoint(args.test_ckpt_addr, ctx["state"])
        model = ctx["model"]
        val = validate(model, make_cached_text_eval(model), ctx["test_ds"], ctx["prompts"],
                       args, ctx["device"])
        log.info("eval acc1=%.2f", val["acc1"])
        return {"best_acc": val["acc1"], "best_epoch": -1, "history": []}
    return train_loop(args, ctx)


if __name__ == "__main__":
    main(sys.argv[1:])
