"""Recognition task: prompt tuning and evaluation.

Counterpart of ``ppt_tpu/tasks/cls.py`` (``setup``, ``validate``,
``train_loop``, ``main``). Loop structure as the reference's:
per-iteration learning rate with linear warmup, label-smoothed cross
entropy, the logit-scale clamp inside the step, the ``data_ratio`` early
break, ``steps_per_dispatch`` steps launched before the host reads their
metrics, evaluation every ``eval_freq`` epochs with the text tower run
once per pass and ``votes`` votes, and a best-only checkpoint of the
trainable partition. ``--pretrained_dir`` holding the converted
``<backbone>.msgpack`` / ``slip_text.msgpack`` files loads them, in
training and in evaluation; without them (or a checkpoint) the weights are
random from ``--seed``; without the dataset's files the data is synthetic.

    # train PPT-Base as published
    python -m ppt_torch.tasks.cls --config configs/experiments/ppt_base_mn40.yaml \
        [--set epochs=1 ...] [--votes 3] [--steps_per_dispatch 2] [--device cpu]
    # the other towers: --model ULIP_PN_NEXT --use_height (PointNeXt-S takes the
    # height as a 4th channel), --model ULIP_PN_SSG, --model ULIP_PN_MSG,
    # --model ULIP_PN_MLP
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

from ppt_torch.data.augment import append_height, train_augment, translate_pointcloud
from ppt_torch.data.datasets import build_dataset
from ppt_torch.data.loader import Loader
from ppt_torch.models.ulip import PromptArrays, build_model, trainable_mask
from ppt_torch.prompt.learner import build_prompt_spec
from ppt_torch.tasks.args import TaskArgs, parse_args
from ppt_torch.train.checkpoint import (load_checkpoint, load_pretrained_backbones,
                                        save_checkpoint)
from ppt_torch.train.eval import make_cached_text_eval
from ppt_torch.train.optim import build_optimizer, build_schedule
from ppt_torch.train.trainer import create_train_state, make_train_multi_step, make_train_step
from ppt_torch.utils.device import resolve_device
from ppt_torch.utils.logging_utils import ExperimentLogger
from ppt_torch.utils.metrics import Meter, per_class_accuracy

log = logging.getLogger(__name__)


def text_route_from_env() -> str:
    """The text tower's route from the reference's own switches
    (``ppt_tpu/nn/text.py:95``, ``:214``): ``PPT_FUSED_TEXT_TOWER=1`` gives
    "tower", else ``PPT_FUSED_TEXT=1`` gives "block", else "off". The one
    place the port reads them: ``setup`` passes the result down."""
    if os.environ.get("PPT_FUSED_TEXT_TOWER", "0") == "1":
        return "tower"
    if os.environ.get("PPT_FUSED_TEXT", "0") == "1":
        return "block"
    return "off"


def point_route_from_env() -> str:
    """PointBERT's trunk route from the reference's own switches, with
    their precedence (``ppt_tpu/nn/pointbert.py:259-263``, ``:325-332``,
    ``:446-453``): ``PPT_FORCE_XLA_ATTN`` set to anything gives "plain" (no
    trunk kernel), else ``PPT_FUSED_BLOCK`` other than "1" gives "unfused"
    (modules with ``fused_mha``), else ``PPT_FUSED_VIT_TOWER=1`` gives
    "tower", else "block" (the default, as on the TPU). A trunk of 1024
    tokens or more takes ``flash_mha`` whatever this says."""
    if os.environ.get("PPT_FORCE_XLA_ATTN"):
        return "plain"
    if os.environ.get("PPT_FUSED_BLOCK", "1") != "1":
        return "unfused"
    if os.environ.get("PPT_FUSED_VIT_TOWER", "0") == "1":
        return "tower"
    return "block"


def setup(args: TaskArgs) -> Dict:
    """Datasets, prompts, model, trainable partition, schedule, optimizer
    and train state on ``args.device`` (the card if empty), shared by
    training and evaluation."""
    if args.task == "partseg":
        raise ValueError("task 'partseg' has a driver of its own: python -m "
                         "ppt_torch.tasks.partseg")
    device = resolve_device(args.device or None)
    train_ds = build_dataset(args.dataset_name, args, "train")
    test_ds = build_dataset(args.dataset_name, args, "test")
    if train_ds.name.startswith("synthetic"):
        classnames = train_ds.classnames  # synthetic (incl. fallback) data names its own
    else:
        classnames = args.load_classnames()
    prompts, model = prompts_and_model(args, classnames, device)
    steps_per_epoch = max(len(train_ds) // args.batch_size, 1)
    state, sched = train_state(args, model, steps_per_epoch)
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


def prompts_and_model(args: TaskArgs, classnames, device):
    """The prompts of ``classnames`` and the model on ``device``, its routes
    from the reference's switches, the converted backbones from
    ``--pretrained_dir`` loaded where they exist."""
    spec = build_prompt_spec(
        classnames,
        n_ctx=args.num_learnable_prompt_tokens,
        class_name_position=args.class_name_position,
        template_init=args.template_init,
    )
    prompts = PromptArrays.from_spec(spec, device=device)
    text_route = text_route_from_env()
    args.point_route = point_route_from_env()  # read by ulip_pointbert(_partseg)
    log.info("text route: %s; point route: %s", text_route, args.point_route)
    model = build_model(args.model, args, device=device, text_fused=text_route).model
    if args.pretrained_dir and os.path.isdir(args.pretrained_dir):
        _maybe_load_pretrained(args, model)
    return prompts, model


def train_state(args: TaskArgs, model, steps_per_epoch: int):
    """(state, schedule): ``args.head_type``'s trainable partition of
    ``model`` with its optimizer, the schedule the optimizer reads."""
    mask = trainable_mask(model, head_type=args.head_type, task=args.task)
    n_train = sum(p.numel() for name, p in model.named_parameters() if mask[name])
    log.info("trainable params: %d", n_train)
    sched = build_schedule(
        args.sched, args.lr, args.epochs, steps_per_epoch,
        final_lr=args.lr_end, warmup_epochs=args.warmup_epochs, warmup_start_lr=args.lr_start,
    )
    state = create_train_state(
        model, mask,
        lambda trainable: build_optimizer(
            args.optim, trainable.items(), sched, weight_decay=args.wd, betas=args.betas,
            eps=args.eps, grad_norm_clip=args.grad_norm_clip,
            plateau_patience=args.plateau_patience if args.sched.lower() == "plateau" else 0,
            steps_per_epoch=steps_per_epoch, plateau_factor=args.plateau_factor),
        seed=args.seed + 1,
    )
    return state, sched


def _maybe_load_pretrained(args: TaskArgs, model) -> None:
    """Converted ULIP/SLIP weights from ``args.pretrained_dir`` into
    ``model`` in place (``tools/ckpt_convert.py`` writes them); without
    them the seeded init stays, with a warning (``ppt_tpu/tasks/cls.py:
    136-145``)."""
    try:
        load_pretrained_backbones(args, model)
    except FileNotFoundError:
        log.warning("pretrained checkpoints not found under %s; random init",
                    args.pretrained_dir)


def validate(state, eval_fn, test_ds, prompts, args: TaskArgs, device,
             votes: int = 1) -> Dict[str, float]:
    """Eval loop over ``test_ds``; ``state`` is the model and ``eval_fn``
    the (embed, step) pair of ``make_cached_text_eval``. With ``votes > 1``
    each batch also runs ``votes - 1`` copies scaled and shifted by
    ``translate_pointcloud`` (the openpoints voting protocol,
    ``ppt_tpu/tasks/cls.py:149-193``): vote 0 is the untouched batch, the
    draws come from a generator seeded with ``args.seed + 7``, the height
    channel is appended after the translation, and the summed logits give
    the prediction."""
    embed_fn, step_fn = eval_fn
    text_embed = embed_fn(state, prompts)
    gen = torch.Generator(device=device).manual_seed(args.seed + 7)
    preds, labels = [], []
    for batch in Loader(test_ds, batch_size=args.batch_size):
        valid = batch["valid"]
        pc0 = torch.from_numpy(batch["pc"].astype(np.float32)).to(device)
        logits_sum = None
        for v in range(max(votes, 1)):
            pc = translate_pointcloud(gen, pc0) if v > 0 else pc0
            if args.use_height:
                pc = append_height(pc)
            logits = step_fn(state, {"pc": pc}, text_embed)
            logits_sum = logits if logits_sum is None else logits_sum + logits
        preds.append(logits_sum.argmax(-1).cpu().numpy()[valid])
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

    K = max(args.steps_per_dispatch, 1)
    # adahessian takes the Hutchinson diagonal threaded into the step
    second_order = args.optim.lower() == "adahessian"
    multi_fn = make_train_multi_step(args.label_smoothing, second_order) if K > 1 else None
    step_fn = make_train_step(smoothing=args.label_smoothing, second_order=second_order)
    eval_fn = make_cached_text_eval(model)
    loader = Loader(train_ds, batch_size=args.batch_size, shuffle=True, drop_last=True,
                    seed=args.seed)
    # augmentation draws from its own stream, as the reference's aug_key
    # (seed + 2): K-step dispatch then takes the same draws as single steps
    aug_gen = torch.Generator(device=device).manual_seed(args.seed + 2)
    exp_log = ExperimentLogger(args, task_name=args.task)

    best_acc = 0.0
    best_epoch = -1
    history = []
    for epoch in range(args.start_epoch, args.epochs):
        loader.set_epoch(epoch)
        loss_meter, acc_meter = Meter("loss"), Meter("acc")
        t0 = time.time()
        n_batches = len(loader)
        pending = []  # augmented batches awaiting a K-step dispatch
        for it, batch in enumerate(loader):
            # data-efficiency early break (main_cls.py:173-174)
            if it / max(n_batches, 1) > args.data_ratio:
                break
            dbatch = device_batch(batch, device)
            dbatch["pc"] = train_augment(aug_gen, dbatch["pc"], use_height=args.use_height)
            if K > 1:
                pending.append(dbatch)
                if len(pending) < K:
                    continue
                stacked = {k: torch.stack([b[k] for b in pending]) for k in dbatch}
                pending = []
                state, metrics = multi_fn(state, stacked, prompts)
                loss_meter.update(float(metrics["loss"].mean()), K * len(batch["label"]))
                acc_meter.update(float(metrics["acc"].mean()), K * len(batch["label"]))
            else:
                state, metrics = step_fn(state, dbatch, prompts)
                loss_meter.update(float(metrics["loss"]), len(batch["label"]))
                acc_meter.update(float(metrics["acc"]), len(batch["label"]))
            if not math.isfinite(loss_meter.avg):
                raise FloatingPointError(f"non-finite loss at epoch {epoch}")
        # leftover batches (fewer than K) run through the single step
        for dbatch in pending:
            state, metrics = step_fn(state, dbatch, prompts)
            loss_meter.update(float(metrics["loss"]), args.batch_size)
            acc_meter.update(float(metrics["acc"]), args.batch_size)

        entry = {
            "epoch": epoch,
            "loss": loss_meter.avg,
            "train_acc": acc_meter.avg,
            "lr": float(ctx["sched"]((epoch + 1) * ctx["steps_per_epoch"] - 1)),
            "epoch_time": time.time() - t0,
        }
        if (epoch % args.eval_freq) == 0 or epoch == args.epochs - 1:
            val = validate(model, eval_fn, test_ds, prompts, args, device, votes=args.votes)
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
