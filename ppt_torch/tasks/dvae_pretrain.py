"""dVAE tokenizer pretraining: stage 1 of PointBERT's recipe.

Counterpart of ``ppt_tpu/tasks/dvae_pretrain.py:38-161``. Trains the whole
discrete VAE (``nn/dvae.py``) with the reference's objective: coarse + fine
per-group Chamfer-L1 reconstruction plus 0.1 x the KL term pushing mean
codebook usage toward uniform, under a Gumbel-softmax temperature annealed
on the host from 1.0 to 0.0625 over all steps (the PointBERT recipe). The
dataset is ``args.dataset_name`` with the synthetic fallback; augmentation,
shuffling, the cosine schedule and the checkpoint of every epoch
(``output_dir/(exp_name or "dvae")``) are the other drivers'.

Under a process group (``torchrun``; ``init_multihost``) every rank reads
the global batch, augments it as one process would and keeps its rows
(``shard_batch``); the step is the mesh's (``make_dvae_step``). Stage 2
(``tasks/mpm_pretrain.py``) reads the checkpoint from ``output_dir/dvae``.

    python -m ppt_torch.tasks.dvae_pretrain [--dataset_name synthetic] \\
        [--batch_size 64] [--npoints 1024] [--epochs 250] \\
        [--compute_dtype bfloat16] [--device cpu]
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
from ppt_torch.nn.dvae import DiscreteVAE, DvaeConfig, dvae_loss, init_dvae
from ppt_torch.parallel.mesh import init_multihost, is_main, replicate, shard_batch, task_mesh
from ppt_torch.tasks.args import TaskArgs, parse_args
from ppt_torch.tasks.cls import device_batch
from ppt_torch.train.checkpoint import save_checkpoint
from ppt_torch.train.optim import Optimizer, build_optimizer
from ppt_torch.train.schedules import cosine_with_warmup
from ppt_torch.train.trainer import TrainState, apply_gradients, create_train_state
from ppt_torch.utils.device import resolve_device, resolve_dtype

log = logging.getLogger(__name__)

TEMP_START, TEMP_END = 1.0, 0.0625  # PointBERT's Gumbel-softmax anneal endpoints


def make_dvae_step(model: DiscreteVAE, optimizer: Optimizer, kl_weight: float = 0.1,
                   recon: str = "chamfer", second_order: bool = False) -> Callable:
    """``step(state, batch, temperature, uniforms=None) -> (state,
    metrics)``: the dVAE in training mode (batch statistics and their
    running update, Gumbel noise from ``state.generator`` unless
    ``uniforms`` gives it), ``recon + kl_weight * kl`` with ``recon`` the
    loss ``dvae_loss`` names, the optimizer on every parameter (with the
    Hutchinson diagonal when ``second_order``, as the reference's step
    threads it, ``tasks/dvae_pretrain.py:39-60``: the encoder's MiniPointNet
    kernels refuse it by name, as the reference's kernels do). ``metrics``
    holds ``loss``, ``recon`` and ``kl`` as 0-dim tensors. On the
    optimizer's mesh the batch is this rank's shard and the step is the
    mesh's, as ``trainer.make_train_step``'s (sync-BN, the Gumbel noise
    drawn at the global batch, the gradients reduced, global-mean
    metrics)."""
    from ppt_torch.parallel.collectives import data_parallel, global_mean
    from ppt_torch.parallel.mesh import axis_group

    data = axis_group(optimizer.mesh, "data")

    def step(state: TrainState, batch: Dict[str, torch.Tensor], temperature: float,
             uniforms: Optional[torch.Tensor] = None):
        with data_parallel(data):
            ret = model(batch["pc"], temperature=temperature, train=True,
                        generator=state.generator, uniforms=uniforms)
        loss_recon, klv = dvae_loss(ret, model.config.num_tokens, recon=recon)
        loss = loss_recon + kl_weight * klv
        apply_gradients(optimizer, loss, state.generator, second_order)
        state.step += 1
        return state, {k: global_mean(v.detach(), data) for k, v in
                       (("loss", loss), ("recon", loss_recon), ("kl", klv))}

    return step


def temperature_at(step: int, total_steps: int) -> float:
    """The host-side anneal: geometric from 1.0 to 0.0625 over all steps."""
    frac = min(step / total_steps, 1.0)
    return float(TEMP_START * (TEMP_END / TEMP_START) ** frac)


def main(args: Optional[Union[TaskArgs, Sequence[str]]] = None,
         config: Optional[DvaeConfig] = None) -> Dict:
    """Train a dVAE of ``config`` (default ``DvaeConfig()``) for
    ``args.epochs`` epochs; a checkpoint after each epoch when
    ``args.output_dir`` is set. Returns the per-epoch history (recon, kl,
    temperature) and the final train state."""
    if not isinstance(args, TaskArgs):
        args = parse_args(args)
    logging.basicConfig(level=logging.INFO)
    init_multihost(args)  # the process group under torchrun / SLURM; one process otherwise
    args.task = "dvae"
    device = resolve_device(args.device or None)
    train_ds = build_dataset(args.dataset_name, args, "train")
    model = init_dvae(DiscreteVAE(config or DvaeConfig(), dtype=resolve_dtype(args.compute_dtype)),
                      args.seed).to(device)
    mesh = task_mesh(args)  # None for one process
    if mesh is not None:
        replicate(model)

    steps_per_epoch = max(len(train_ds) // args.batch_size, 1)
    sched = cosine_with_warmup(args.lr, args.lr_end, args.epochs, steps_per_epoch,
                               warmup_epochs=args.warmup_epochs, warmup_start_lr=args.lr_start)
    state = create_train_state(
        model, {name: True for name, _ in model.named_parameters()},
        lambda trainable: build_optimizer(
            args.optim, trainable.items(), sched, weight_decay=args.wd, betas=args.betas,
            eps=args.eps, grad_norm_clip=args.grad_norm_clip),
        seed=args.seed + 1, mesh=mesh)
    log.info("dVAE pretraining on %s (%d clouds); params: %d", train_ds.name, len(train_ds),
             sum(p.numel() for p in state.trainable.values()))

    step_fn = make_dvae_step(model, state.optimizer,
                             second_order=args.optim.lower() == "adahessian")
    loader = Loader(train_ds, batch_size=args.batch_size, shuffle=True, drop_last=True,
                    seed=args.seed, num_processes=1, process_index=0)
    total_steps = max(args.epochs * steps_per_epoch, 1)
    history = []
    for epoch in range(args.epochs):
        loader.set_epoch(epoch)
        recons, kls = [], []
        t0 = time.time()
        for batch in loader:
            pc = train_augment(state.generator, device_batch(batch, device)["pc"])
            if mesh is not None:
                pc = shard_batch(pc, mesh)
            temp = temperature_at(state.step, total_steps)
            state, metrics = step_fn(state, {"pc": pc}, temp)
            recons.append(float(metrics["recon"]))
            kls.append(float(metrics["kl"]))
            if not math.isfinite(recons[-1] + kls[-1]):
                raise FloatingPointError(f"non-finite dVAE loss at epoch {epoch}")
        entry = {"epoch": epoch, "recon": float(np.mean(recons)), "kl": float(np.mean(kls)),
                 "temperature": temp, "epoch_time": time.time() - t0}
        history.append(entry)
        log.info("epoch %d: %s", epoch, entry)
        if args.output_dir and is_main():
            save_checkpoint(os.path.join(args.output_dir, args.exp_name or "dvae"), state,
                            meta={"epoch": epoch, **entry})
    return {"history": history, "state": state}


if __name__ == "__main__":
    main(sys.argv[1:])
