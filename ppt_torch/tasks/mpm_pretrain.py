"""PointBERT masked-point-modeling pretraining: stage 2 of the recipe.

Counterpart of ``ppt_tpu/tasks/mpm_pretrain.py:37-185``. A frozen dVAE
(stage 1, ``tasks/dvae_pretrain.py``) tokenizes each FPS/kNN group into a
discrete id; the PointBERT student sees the group sequence with 40% of the
groups replaced by a learnable mask token and learns to predict the dVAE's
ids there. The dVAE takes the student's ``num_group`` / ``group_size`` and
is read from ``output_dir/dvae/checkpoint_best.pt`` when that file exists;
otherwise it is a random tokenizer from ``seed + 10``, with a warning, as
in the reference. The step reports the masked accuracy in percent.

The student's trunk route comes from the reference's switches
(``tasks/cls.py:point_route_from_env``); ``PPT_FUSED_VIT_TOWER`` names a
classification-readout kernel that MPM does not use, so it leaves the
default block route, as it leaves the reference's ``VitBlock``. One card
(or ``--device cpu``); under a process group (``torchrun``;
``init_multihost``) every rank reads the global batch, augments it as one
process would and keeps its rows, and the step is the mesh's.

    python -m ppt_torch.tasks.mpm_pretrain [--dataset_name synthetic] \\
        [--batch_size 32] [--npoints 1024] [--epochs 300] \\
        [--compute_dtype bfloat16] [--output_dir outputs] [--device cpu]
"""

from __future__ import annotations

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
from ppt_torch.nn.dvae import DiscreteVAE, DvaeConfig, init_dvae
from ppt_torch.nn.mpm import PointBertMPM, dvae_tokenize, init_mpm, mpm_loss, sample_group_mask
from ppt_torch.nn.pointbert import PointBertConfig, group_points
from ppt_torch.parallel.mesh import init_multihost, is_main, replicate, shard_batch, task_mesh
from ppt_torch.tasks.args import TaskArgs, parse_args
from ppt_torch.tasks.cls import device_batch, point_route_from_env
from ppt_torch.train import checkpoint
from ppt_torch.train.optim import Optimizer, build_optimizer
from ppt_torch.train.schedules import cosine_with_warmup
from ppt_torch.train.trainer import TrainState, apply_gradients, create_train_state
from ppt_torch.utils.device import resolve_device, resolve_dtype

log = logging.getLogger(__name__)


def make_mpm_step(student: PointBertMPM, dvae: DiscreteVAE, optimizer: Optimizer,
                  mask_ratio: float, num_group: int, group_size: int,
                  second_order: bool = False) -> Callable:
    """``step(state, batch, mask=None) -> (state, metrics)``: group the
    clouds, take the frozen dVAE's ids, mask ``mask_ratio`` of the groups
    (drawn from ``state.generator`` through ``sample_group_mask`` unless
    ``mask`` gives them), run the student in training mode (DropPath from
    the same generator), masked cross-entropy, the optimizer on the student
    (with the Hutchinson diagonal when ``second_order``, as the reference's
    step threads it, ``tasks/mpm_pretrain.py:39-62``: the student's kernels
    refuse it by name, as the reference's kernels do).
    ``metrics`` holds ``loss`` and ``masked_acc`` (percent) as 0-dim
    tensors. On the optimizer's mesh the batch is this rank's shard and the
    step is the mesh's, as ``trainer.make_train_step``'s (the masks and
    DropPath drawn at the global batch, sync-BN, the gradients reduced,
    global-mean metrics: every row masks the same number of groups, so the
    shards' means average to the global one)."""
    from ppt_torch.parallel.collectives import data_parallel, global_mean
    from ppt_torch.parallel.mesh import axis_group

    data = axis_group(optimizer.mesh, "data")

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             mask: Optional[torch.Tensor] = None):
        pc = batch["pc"]
        neighborhood, center = group_points(pc, num_group, group_size)
        targets = dvae_tokenize(dvae, neighborhood, center)
        with data_parallel(data):
            if mask is None:
                mask = sample_group_mask(state.generator, pc.shape[0], num_group, mask_ratio,
                                         device=pc.device)
            logits = student(neighborhood, center, mask, train=True,
                             generator=state.generator)
        loss, acc = mpm_loss(logits, targets, mask)
        apply_gradients(optimizer, loss, state.generator, second_order)
        state.step += 1
        return state, {"loss": global_mean(loss.detach(), data),
                       "masked_acc": global_mean(acc.detach() * 100.0, data)}

    return step


def load_dvae(dvae: DiscreteVAE, path: str) -> DiscreteVAE:
    """Weights and running statistics from a ``dvae_pretrain`` checkpoint."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    dvae.load_state_dict({**payload["trainable"], **payload["batch_stats"]})
    return dvae


def main(args: Optional[Union[TaskArgs, Sequence[str]]] = None,
         config: Optional[PointBertConfig] = None, dvae_config: Optional[DvaeConfig] = None,
         mask_ratio: float = 0.4) -> Dict:
    """Train a PointBERT student of ``config`` (default ``PointBertConfig()``)
    against the frozen dVAE for ``args.epochs`` epochs; a checkpoint after
    each epoch when ``args.output_dir`` is set. Returns the per-epoch
    history (loss, masked accuracy) and the final train state."""
    if not isinstance(args, TaskArgs):
        args = parse_args(args)
    logging.basicConfig(level=logging.INFO)
    init_multihost(args)  # the process group under torchrun / SLURM; one process otherwise
    args.task = "mpm"
    cfg = config or PointBertConfig()
    dcfg = dvae_config or DvaeConfig(group_size=cfg.group_size, num_group=cfg.num_group)
    device = resolve_device(args.device or None)
    dtype = resolve_dtype(args.compute_dtype)
    train_ds = build_dataset(args.dataset_name, args, "train")

    dvae = init_dvae(DiscreteVAE(dcfg, dtype=dtype), args.seed + 10)
    dvae_ckpt = os.path.join(args.output_dir, "dvae", checkpoint.FILE)
    if os.path.exists(dvae_ckpt):
        load_dvae(dvae, dvae_ckpt)
        log.info("loaded frozen dVAE from %s", dvae_ckpt)
    else:
        log.warning("no trained dVAE at %s; using random tokenizer", dvae_ckpt)
    dvae.to(device).requires_grad_(False)

    route = point_route_from_env()
    student = init_mpm(PointBertMPM(cfg, num_tokens=dcfg.num_tokens, dtype=dtype,
                                    route="block" if route == "tower" else route),
                       args.seed).to(device)
    mesh = task_mesh(args)  # None for one process
    if mesh is not None:
        replicate(student)
        replicate(dvae)
    steps_per_epoch = max(len(train_ds) // args.batch_size, 1)
    sched = cosine_with_warmup(args.lr, args.lr_end, args.epochs, steps_per_epoch,
                               warmup_epochs=args.warmup_epochs, warmup_start_lr=args.lr_start)
    state = create_train_state(
        student, {name: True for name, _ in student.named_parameters()},
        lambda trainable: build_optimizer(
            args.optim, trainable.items(), sched, weight_decay=args.wd, betas=args.betas,
            eps=args.eps, grad_norm_clip=args.grad_norm_clip),
        seed=args.seed + 1, mesh=mesh)
    step_fn = make_mpm_step(student, dvae, state.optimizer, mask_ratio, cfg.num_group,
                            cfg.group_size, second_order=args.optim.lower() == "adahessian")
    log.info("MPM pretraining on %s (%d clouds), route %s; student params: %d",
             train_ds.name, len(train_ds), student.route,
             sum(p.numel() for p in state.trainable.values()))

    # the global batch on every rank, its rows taken after the augmentation
    loader = Loader(train_ds, batch_size=args.batch_size, shuffle=True, drop_last=True,
                    seed=args.seed, num_processes=1, process_index=0)
    history = []
    for epoch in range(args.epochs):
        loader.set_epoch(epoch)
        losses, accs = [], []
        t0 = time.time()
        for batch in loader:
            pc = train_augment(state.generator, device_batch(batch, device)["pc"])
            if mesh is not None:
                pc = shard_batch(pc, mesh)
            state, metrics = step_fn(state, {"pc": pc})
            losses.append(float(metrics["loss"]))
            accs.append(float(metrics["masked_acc"]))
            if not math.isfinite(losses[-1]):
                raise FloatingPointError(f"non-finite MPM loss at epoch {epoch}")
        entry = {"epoch": epoch, "loss": float(np.mean(losses)),
                 "masked_acc": float(np.mean(accs)), "epoch_time": time.time() - t0}
        history.append(entry)
        log.info("epoch %d: %s", epoch, entry)
        if args.output_dir and is_main():
            checkpoint.save_checkpoint(os.path.join(args.output_dir, args.exp_name or "mpm"),
                                       state, meta={"epoch": epoch, **entry})
    return {"history": history, "state": state}


if __name__ == "__main__":
    main(sys.argv[1:])
