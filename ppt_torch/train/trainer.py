"""Trainer: the trainable partition, its optimizer, the train steps.

Counterpart of ``ppt_tpu/train/trainer.py``. The reference differentiates
its loss with respect to the trainable partition only; here the same
partition is ``requires_grad`` (``models.ulip.apply_trainable_mask``), so
autograd builds no gradient for a frozen leaf while gradients still flow
through the frozen towers to the prompt tokens. The point tower runs with
``train=True`` even when all of it is frozen: its BatchNorms use batch
statistics and move their running statistics every step, and DropPath is
live (``trainer.py:143-149``).

``make_cached_text_eval`` is in ``ppt_torch.train.eval``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

import torch
from torch import nn

from ppt_torch.models.losses import smoothed_cross_entropy
from ppt_torch.models.ulip import PromptArrays, apply_trainable_mask
from ppt_torch.train.optim import Optimizer

LOGIT_SCALE_MAX = 4.6052  # ln(100), main_cls.py:213


@dataclasses.dataclass
class TrainState:
    """The model (its parameters are the trainable and frozen partitions,
    its buffers the batch statistics), the optimizer with its moments, the
    step count, and the generator DropPath and augmentation draw from."""

    model: nn.Module
    optimizer: Optimizer
    generator: torch.Generator
    step: int = 0

    @property
    def trainable(self) -> Dict[str, torch.Tensor]:
        return self.optimizer.params

    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return {k: v for k, v in self.model.named_buffers()
                if k.endswith(("running_mean", "running_var"))}


def create_train_state(model: nn.Module, mask: Dict[str, bool],
                       make_optimizer: Callable[[Dict[str, torch.Tensor]], Optimizer],
                       seed: int, mesh=None) -> TrainState:
    """Apply ``mask`` to ``model`` and build the optimizer over what it
    leaves trainable; the generator lives on the model's device. With
    ``mesh`` (``parallel.create_mesh``) the steps are the mesh's: the
    optimizer reduces the gradients over its ranks (``Optimizer.
    reduce_over_mesh``), and the step factories, which read the mesh from
    the optimizer, run the forward in its data axis's context (sync-BN,
    draws at the global batch) and report global means."""
    trainable = apply_trainable_mask(model, mask)
    device = next(model.parameters()).device
    # meta tensors (a traced program) have no generator of their own; they take the CPU's
    generator = torch.Generator(device=device if device.type != "meta" else "cpu")
    generator.manual_seed(seed)
    optimizer = make_optimizer(trainable)
    optimizer.mesh = mesh
    if getattr(model, "tp", None) is not None:  # tensor-parallel shards (``shard_params``)
        from ppt_torch.parallel.sharding import shard_groups

        optimizer.shard_groups = {k: g for k, g in shard_groups(model).items()
                                  if k in trainable}
    return TrainState(model=model, optimizer=optimizer, generator=generator)


@torch.no_grad()
def clamp_logit_scale(trainable: Dict[str, torch.Tensor]) -> None:
    if "logit_scale" in trainable:
        trainable["logit_scale"].clamp_(0.0, LOGIT_SCALE_MAX)


def make_train_step(smoothing: float = 0.0, second_order: bool = False,
                    partseg: bool = False) -> Callable:
    """``train_step(state, batch, prompts) -> (state, metrics)``: one
    optimizer step on ``batch`` (``pc`` [B, N, 3], ``label`` [B], on the
    model's device). With ``partseg`` the batch also holds ``cls_onehot``
    [B, 16], ``label`` is [B, N] and the loss and accuracy are taken over
    the flattened [B * N, P] logits (``trainer.py:141-160``). ``metrics``
    holds ``loss`` and ``acc`` (percent) as
    0-dim tensors, so the caller decides when to wait for the device. The
    model and the optimizer come with ``state``; the optimizer gets the
    loss as ``value`` (the plateau stage reads it). With ``second_order``
    (``adahessian``) the gradients keep their graph and the Hutchinson
    diagonal, from one Rademacher probe drawn from the state's generator,
    goes to the optimizer as ``hess``, as the
    reference's ``_make_train_step_fn`` threads it (``trainer.py:110-190``);
    a kernel on the way from a trainable leaf to the loss refuses by name.

    On a mesh (``create_train_state(..., mesh=)``) the batch is this rank's
    shard (``parallel.shard_batch``): the forward runs in the data axis's
    context (sync-BN, draws at the global batch), the optimizer reduces the
    gradients over the ranks, and ``loss`` and ``acc`` are global means. A
    model put on the mesh's 'model' axis by ``parallel.sharding.
    shard_params`` runs tensor-parallel."""
    from ppt_torch.parallel.collectives import data_parallel, global_mean
    from ppt_torch.parallel.mesh import axis_group

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   prompts: PromptArrays) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        trainable = state.trainable
        data = axis_group(state.optimizer.mesh, "data")  # None for one process
        with data_parallel(data):
            logits = state.model(batch["pc"], prompts, train=True, generator=state.generator,
                                 cls_onehot=batch["cls_onehot"] if partseg else None)
        labels = batch["label"]
        if partseg:
            logits, labels = logits.reshape(-1, logits.shape[-1]), labels.reshape(-1)
        loss = smoothed_cross_entropy(logits, labels, smoothing)
        global_loss = global_mean(loss.detach(), data)
        apply_gradients(state.optimizer, loss, state.generator, second_order,
                        value=global_loss)
        clamp_logit_scale(trainable)
        state.step += 1
        with torch.no_grad():
            acc = (logits.argmax(-1) == labels).float().mean() * 100.0
        return state, {"loss": global_loss, "acc": global_mean(acc, data)}

    return train_step


def apply_gradients(optimizer: Optimizer, loss: torch.Tensor, generator: torch.Generator,
                    second_order: bool = False, value=None) -> None:
    """One optimizer step on the gradient of ``loss`` against the
    optimizer's tensors; with ``second_order`` the Hutchinson diagonal goes
    with it as ``hess``."""
    names = list(optimizer.params)
    leaves = [optimizer.params[k] for k in names]
    grads = torch.autograd.grad(loss, leaves, create_graph=second_order)
    extra = {}
    if second_order:
        hess = hutchinson_diag(grads, leaves, generator)
        extra["hess"] = {k: h.detach() for k, h in zip(names, hess)}
        grads = [g.detach() for g in grads]
    optimizer.step(dict(zip(names, grads)), value=value, **extra)


def make_train_multi_step(smoothing: float = 0.0, second_order: bool = False,
                          partseg: bool = False) -> Callable:
    """``multi_step(state, batches, prompts) -> (state, metrics)``: the
    reference's ``make_train_multi_step`` (``trainer.py:216-251``) without
    its ``lax.scan``: ``batches`` holds K batches stacked (``pc`` [K, B, N,
    3], ``label`` [K, B]; with ``partseg`` also ``cls_onehot``), and the K
    single steps are launched back to back with no read by the host between
    them; ``metrics`` are [K] tensors. On a mesh as ``make_train_step``."""
    single = make_train_step(smoothing, second_order, partseg)

    def multi_step(state: TrainState, batches: Dict[str, torch.Tensor],
                   prompts: PromptArrays) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        per_step = []
        for k in range(batches["pc"].shape[0]):
            state, metrics = single(state, {n: b[k] for n, b in batches.items()}, prompts)
            per_step.append(metrics)
        return state, {n: torch.stack([m[n] for m in per_step]) for n in per_step[0]}

    return multi_step


def hutchinson_diag(grads: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
                    generator: torch.Generator, n_samples: int = 1) -> List[torch.Tensor]:
    """Hutchinson's estimate of the Hessian diagonal, ``E_z[z * (H z)]`` over
    Rademacher probes ``z`` drawn from ``generator``, with ``H z`` the
    gradient of ``grads`` (taken with ``create_graph=True``) against ``z``
    (``train/optim.py:193-214``; the reference's ``jax.jvp`` of its gradient
    function, one extra backward per probe)."""
    total = [torch.zeros_like(p) for p in params]
    for i in range(n_samples):
        zs = [(torch.randint(0, 2, tuple(p.shape), generator=generator, device=p.device) * 2
               - 1).to(p.dtype) for p in params]
        hz = torch.autograd.grad(grads, params, grad_outputs=zs, retain_graph=i < n_samples - 1)
        total = [t + h * z / n_samples for t, h, z in zip(total, hz, zs)]
    return total


def make_eval_step(partseg: bool = False) -> Callable:
    """``eval_step(state, batch, prompts) -> logits`` with running
    statistics, no DropPath and no dropout; recomputes the text tower per
    call. With ``partseg`` the batch's ``cls_onehot`` goes to the point
    tower and the logits are [B, N, P] (``trainer.py:279-295``)."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor], prompts: PromptArrays):
        return state.model(batch["pc"], prompts, train=False,
                           cls_onehot=batch["cls_onehot"] if partseg else None)

    return eval_step
