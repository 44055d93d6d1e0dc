"""Trainer: the trainable partition, AdamW on it alone, the train step.

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
from typing import Callable, Dict, Tuple

import torch
from torch import nn

from ppt_torch.models.losses import smoothed_cross_entropy
from ppt_torch.models.ulip import PromptArrays, apply_trainable_mask
from ppt_torch.train.optim import AdamW

LOGIT_SCALE_MAX = 4.6052  # ln(100), main_cls.py:213


@dataclasses.dataclass
class TrainState:
    """The model (its parameters are the trainable and frozen partitions,
    its buffers the batch statistics), the optimizer with its moments, the
    step count, and the generator DropPath and augmentation draw from."""

    model: nn.Module
    optimizer: AdamW
    generator: torch.Generator
    step: int = 0

    @property
    def trainable(self) -> Dict[str, torch.Tensor]:
        return self.optimizer.params

    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return {k: v for k, v in self.model.named_buffers()
                if k.endswith(("running_mean", "running_var"))}


def create_train_state(model: nn.Module, mask: Dict[str, bool],
                       make_optimizer: Callable[[Dict[str, torch.Tensor]], AdamW],
                       seed: int) -> TrainState:
    """Apply ``mask`` to ``model`` and build the optimizer over what it
    leaves trainable; the generator lives on the model's device."""
    trainable = apply_trainable_mask(model, mask)
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)
    return TrainState(model=model, optimizer=make_optimizer(trainable), generator=generator)


@torch.no_grad()
def clamp_logit_scale(trainable: Dict[str, torch.Tensor]) -> None:
    if "logit_scale" in trainable:
        trainable["logit_scale"].clamp_(0.0, LOGIT_SCALE_MAX)


def make_train_step(smoothing: float = 0.0) -> Callable:
    """``train_step(state, batch, prompts) -> (state, metrics)``: one
    optimizer step on ``batch`` (``pc`` [B, N, 3], ``label`` [B], on the
    model's device). ``metrics`` holds ``loss`` and ``acc`` (percent) as
    0-dim tensors, so the caller decides when to wait for the device. The
    model and the optimizer come with ``state``."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   prompts: PromptArrays) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        trainable = state.trainable
        logits = state.model(batch["pc"], prompts, train=True, generator=state.generator)
        loss = smoothed_cross_entropy(logits, batch["label"], smoothing)
        names = list(trainable)
        grads = torch.autograd.grad(loss, [trainable[k] for k in names])
        state.optimizer.step(dict(zip(names, grads)))
        clamp_logit_scale(trainable)
        state.step += 1
        with torch.no_grad():
            acc = (logits.argmax(-1) == batch["label"]).float().mean() * 100.0
        return state, {"loss": loss.detach(), "acc": acc}

    return train_step


def make_train_multi_step(*args, **kwargs):
    raise NotImplementedError("steps_per_dispatch > 1 (several optimizer steps per dispatch) "
                              "is not ported yet")


def make_eval_step() -> Callable:
    """``eval_step(state, batch, prompts) -> logits`` with running
    statistics and no DropPath; recomputes the text tower per call."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor], prompts: PromptArrays):
        return state.model(batch["pc"], prompts, train=False)

    return eval_step
