"""Best-only checkpoints of the trainable partition.

Counterpart of ``ppt_tpu/train/checkpoint.py:35-76``: what
``trainable_mask`` marked trainable is what is saved and restored, with
its optimizer state, the batch statistics and the step. The reference
writes flax msgpack; the port writes ``checkpoint_best.pt`` (``torch.save``
of plain tensors and ints) beside the same ``checkpoint_best.json``
metadata. A reference run is carried across with
``ppt_torch.convert.train_state_from_jax``. Loading converted pretrained
backbones is not ported yet.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, Optional

import torch

from ppt_torch.train.trainer import TrainState

log = logging.getLogger(__name__)

FILE = "checkpoint_best.pt"
META = "checkpoint_best.json"


def _cpu(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone() for k, v in tree.items()}


def _cpu_state(tree):
    """An optimizer's state dict with every tensor copied to the host."""
    if isinstance(tree, dict):
        return {k: _cpu_state(v) for k, v in tree.items()}
    return tree.detach().cpu().clone() if isinstance(tree, torch.Tensor) else tree


def state_payload(state: TrainState) -> Dict[str, Any]:
    return {
        "trainable": _cpu(state.trainable),
        "opt_state": _cpu_state(state.optimizer.state_dict()),
        "batch_stats": _cpu(state.batch_stats()),
        "step": int(state.step),
    }


def save_checkpoint(directory: str, state: TrainState,
                    meta: Optional[Dict[str, Any]] = None) -> None:
    """Save trainable params + their optimizer state + batch stats."""
    os.makedirs(directory, exist_ok=True)
    torch.save(state_payload(state), os.path.join(directory, FILE))
    if meta is not None:
        with open(os.path.join(directory, META), "w") as f:
            json.dump(meta, f, indent=2, default=str)
    log.info("saved checkpoint to %s", directory)


def restore_payload(payload: Dict[str, Any], state: TrainState) -> TrainState:
    """Copy a payload into ``state`` in place; raises when its leaves are
    not exactly the state's trainable partition and batch statistics."""
    for what, have in (("trainable", state.trainable), ("batch_stats", state.batch_stats())):
        got = payload[what]
        if set(got) != set(have):
            raise ValueError(
                f"checkpoint {what} leaves {sorted(got)} do not match the state's "
                f"{sorted(have)} (another head_type or model?)")
        with torch.no_grad():
            for k, v in got.items():
                if tuple(v.shape) != tuple(have[k].shape):
                    raise ValueError(f"checkpoint {what} leaf {k} has shape {tuple(v.shape)}, "
                                     f"the state {tuple(have[k].shape)}")
                have[k].copy_(v)
    state.optimizer.load_state_dict(payload["opt_state"])
    state.step = int(payload["step"])
    return state


def load_checkpoint(path: str, state: TrainState) -> TrainState:
    """Restore a saved trainable partition into ``state`` (a directory
    holding ``checkpoint_best.pt``, or the file)."""
    if os.path.isdir(path):
        path = os.path.join(path, FILE)
    return restore_payload(torch.load(path, map_location="cpu", weights_only=True), state)
