"""ULIP contrastive pretraining on ShapeNet-55 triplets.

Counterpart of ``ppt_tpu/tasks/pretrain.py`` (whose ``main_pretrain.py``
driver stays the reference's entry point). Each cloud is paired with a
caption from one of the 64 ``shapenet_64`` templates of its class, and the
point encoder learns to align with the frozen CLIP text tower through the
symmetric InfoNCE loss (``models.losses.ulip_contrastive_loss``).

Trainable partition: the point encoder, ``pc_projection`` and
``logit_scale`` (``trainable_mask(task="pretrain")``); the text tower is
frozen. Caption tokens for every (class, template) pair are built once on
the host; each step takes one per cloud under a template draw from
``RandomState(seed + 3)``, so tokenisation never runs in the loop.

Under a process group (``torchrun``; ``init_multihost``) every rank reads
the global batch of ``batch_size`` clouds, augments it and draws its
captions as one process would, and keeps its rows (``shard_batch``); the
step all-gathers both embeddings, so the InfoNCE is the global batch's.
PointBERT's trunk and the text
tower take the routes that the reference's switches name
(``tasks/cls.py:point_route_from_env``, ``text_route_from_env``); a trunk
of 1024 tokens or more trains through ``flash_mha``'s backward kernels.

    python -m ppt_torch.tasks.pretrain [--dataset_name shapenet|synthetic] \\
        [--batch_size 32] [--npoints 8192] [--epochs 250] [--grad_norm_clip 1.0] \\
        [--compute_dtype bfloat16] [--device cpu]
"""

from __future__ import annotations

import json
import logging
import math
import os
import sys
import time
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from ppt_torch.data.augment import train_augment
from ppt_torch.data.datasets import build_dataset
from ppt_torch.data.loader import Loader
from ppt_torch.models.losses import ulip_contrastive_loss
from ppt_torch.models.ulip import build_model, trainable_mask
from ppt_torch.parallel.mesh import init_multihost, is_main, replicate, shard_batch, task_mesh
from ppt_torch.prompt.tokenizer import ClipTokenizer
from ppt_torch.tasks.args import TaskArgs, parse_args
from ppt_torch.tasks.cls import device_batch, point_route_from_env, text_route_from_env
from ppt_torch.train.checkpoint import save_checkpoint
from ppt_torch.train.optim import AdamW, build_optimizer
from ppt_torch.train.schedules import cosine_with_warmup
from ppt_torch.train.trainer import TrainState, clamp_logit_scale, create_train_state
from ppt_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

TEMPLATES_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                              "assets", "templates.json")


def build_caption_bank(classnames: Sequence[str]) -> np.ndarray:
    """[C, T, 77] int32 token bank for every (class, ``shapenet_64``
    template) pair."""
    with open(TEMPLATES_PATH) as f:
        templates = json.load(f)["shapenet_64"]
    tokenizer = ClipTokenizer()
    bank = np.zeros((len(classnames), len(templates), 77), dtype=np.int32)
    for c, name in enumerate(classnames):
        bank[c] = tokenizer([t.format(name) for t in templates])
    return bank


def make_pretrain_step(model: torch.nn.Module, optimizer: AdamW) -> Callable:
    """``step(state, batch, tokens) -> (state, metrics)``: the point tower in
    training mode (batch statistics and their running update, DropPath from
    ``state.generator``), the captions through the frozen text tower, the
    contrastive loss at ``exp(logit_scale)``, AdamW on the trainable
    partition and the logit-scale clamp to [0, ln 100]. ``batch["pc"]`` is
    [B, N, 3] and ``tokens`` [B, 77] on the model's device; ``metrics``
    holds ``loss`` and ``pc_text_acc`` as 0-dim tensors.

    On the optimizer's mesh (``create_train_state(..., mesh=)``) the clouds
    and captions are this rank's shard: the point
    tower runs in the data axis's context (sync-BN, DropPath drawn at the
    global batch), and both embeddings are all-gathered over the data axis,
    differentiably (the reference's ``GatherLayer``, ``utils/utils.py:
    212-250``), so the InfoNCE normalises over the GLOBAL batch on every
    rank, as GSPMD's placement of the [B, B] product does; the optimizer
    then reduces the gradients over the ranks."""
    from ppt_torch.parallel.collectives import all_gather_cat, data_parallel
    from ppt_torch.parallel.mesh import axis_group

    data = axis_group(optimizer.mesh, "data")

    def step(state: TrainState, batch: Dict[str, torch.Tensor], tokens: torch.Tensor):
        with data_parallel(data):
            pc_embed = model.encode_pc(batch["pc"], train=True, generator=state.generator)
        text_embed = model.encode_captions(tokens)
        if data is not None:
            pc_embed, text_embed = (all_gather_cat(t, data) for t in (pc_embed, text_embed))
        out = ulip_contrastive_loss(pc_embed, text_embed, None, torch.exp(model.logit_scale))
        names = list(optimizer.params)
        grads = torch.autograd.grad(out["loss"], [optimizer.params[k] for k in names])
        optimizer.step(dict(zip(names, grads)))
        clamp_logit_scale(optimizer.params)
        state.step += 1
        return state, {"loss": out["loss"].detach(), "pc_text_acc": out["pc_text_acc"]}

    return step


def main(args: Optional[Union[TaskArgs, Sequence[str]]] = None) -> Dict:
    """Pretrain ``args.model`` for ``args.epochs`` epochs on ShapeNet-55 (or
    its synthetic fallback); a checkpoint of the trainable partition after
    each epoch when ``args.output_dir`` is set. Returns the per-epoch
    history and the final train state."""
    if not isinstance(args, TaskArgs):
        args = parse_args(args)
    logging.basicConfig(level=logging.INFO)
    init_multihost(args)  # the process group under torchrun / SLURM; one process otherwise
    args.task = "pretrain"
    if args.dataset_name not in ("shapenet", "synthetic"):
        args.dataset_name = "shapenet"
    if args.optim.lower() == "adahessian":
        raise ValueError("the ULIP contrastive pretrain step does not thread the Hessian "
                         "diagonal; use adamw")
    device = resolve_device(args.device or None)
    train_ds = build_dataset(args.dataset_name, args, "train")
    bank = build_caption_bank(train_ds.classnames)

    text_route = text_route_from_env()
    args.point_route = point_route_from_env()  # read by ulip_pointbert
    model = build_model(args.model, args, device=device, text_fused=text_route).model
    mesh = task_mesh(args)  # None for one process
    if mesh is not None:
        replicate(model)
    steps_per_epoch = max(len(train_ds) // args.batch_size, 1)
    sched = cosine_with_warmup(args.lr, args.lr_end, args.epochs, steps_per_epoch,
                               warmup_epochs=args.warmup_epochs,
                               warmup_start_lr=args.lr_start)
    state = create_train_state(
        model, trainable_mask(model, task="pretrain"),
        lambda trainable: build_optimizer(
            args.optim, trainable.items(), sched, weight_decay=args.wd, betas=args.betas,
            eps=args.eps, grad_norm_clip=args.grad_norm_clip),
        seed=args.seed + 1, mesh=mesh)
    log.info("pretraining %s on %s (%d clouds, %d classes x %d captions); trainable params: "
             "%d", args.model, train_ds.name, len(train_ds), bank.shape[0], bank.shape[1],
             sum(p.numel() for p in state.trainable.values()))

    step_fn = make_pretrain_step(model, state.optimizer)
    loader = Loader(train_ds, batch_size=args.batch_size, shuffle=True, drop_last=True,
                    seed=args.seed, num_processes=1, process_index=0)
    cap_rng = np.random.RandomState(args.seed + 3)
    history = []
    for epoch in range(args.epochs):
        loader.set_epoch(epoch)
        losses, accs = [], []
        t0 = time.time()
        for batch in loader:
            dbatch = device_batch(batch, device)
            pc = train_augment(state.generator, dbatch["pc"])
            t_idx = cap_rng.randint(0, bank.shape[1], size=len(batch["label"]))
            tokens = torch.from_numpy(bank[batch["label"], t_idx]).to(device)
            if mesh is not None:
                pc, tokens = shard_batch(pc, mesh), shard_batch(tokens, mesh)
            state, metrics = step_fn(state, {"pc": pc}, tokens)
            losses.append(float(metrics["loss"]))
            accs.append(float(metrics["pc_text_acc"]))
            if not math.isfinite(losses[-1]):
                raise FloatingPointError(f"non-finite loss at epoch {epoch}")
        entry = {"epoch": epoch, "loss": float(np.mean(losses)),
                 "pc_text_acc": float(np.mean(accs)), "epoch_time": time.time() - t0}
        history.append(entry)
        log.info("epoch %d: %s", epoch, entry)
        if args.output_dir and is_main():
            save_checkpoint(os.path.join(args.output_dir, args.exp_name or "pretrain"), state,
                            meta={"epoch": epoch, **entry})
    return {"history": history, "state": state}


if __name__ == "__main__":
    main(sys.argv[1:])
