"""Best-only checkpoints of the trainable partition.

Counterpart of ``ppt_tpu/train/checkpoint.py:35-76``: what
``trainable_mask`` marked trainable is what is saved and restored, with
its optimizer state, the batch statistics and the step. The reference
writes flax msgpack; the port writes ``checkpoint_best.pt`` (``torch.save``
of plain tensors and ints) beside the same ``checkpoint_best.json``
metadata. A reference run is carried across with
``ppt_torch.convert.train_state_from_jax``.

Pretrained backbones (``:79-147``): ``load_pretrained_backbones`` reads
the ``<backbone>.msgpack`` and ``slip_text.msgpack`` files that
``python -m ppt_torch.tools.ckpt_convert`` (or the reference's own
converter) writes from the published ``.pt`` files, through the port's
msgpack reader, and grafts them onto the model in place.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from ppt_torch.convert import port_leaves
from ppt_torch.train.trainer import TrainState
import ppt_torch.utils.msgpack as flax_msgpack  # the port's own reader and writer

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


def load_params_file(path: str) -> Dict[str, Any]:
    """A raw variable tree written by the checkpoint converter (msgpack)."""
    with open(path, "rb") as f:
        return flax_msgpack.msgpack_restore(f.read())


def merge_pretrained(model: nn.Module, pretrained: Dict[str, Any]) -> Dict[str, Tuple[int, int]]:
    """Graft a converted ``{"params", "batch_stats"}`` tree onto ``model``
    in place, by the weight bridge's leaf names. A leaf whose port key
    exists with the same shape overrides the init, cast to the
    parameter's dtype; every other leaf (a ``pc_projection`` of another
    width, a tower the model lacks) is skipped, and what no leaf names
    keeps its init: the reference's rule (``ppt_tpu/train/checkpoint.py:
    84-111``). The writes are in-place ``copy_``s: the optimizer keeps its
    parameters and ``CastCache`` sees their bumped versions. Returns
    (loaded, total) by collection, as logged."""
    targets: Dict[str, Dict[str, torch.Tensor]] = {"params": {}, "batch_stats": {}}
    for name, t in model.state_dict(keep_vars=True).items():
        leaf = name.rsplit(".", 1)[-1]
        targets["batch_stats" if leaf in ("running_mean", "running_var") else "params"][name] = t
    counts = {}
    for collection, stats in (("params", False), ("batch_stats", True)):
        if collection not in pretrained:
            continue
        have = targets[collection]
        flat = {key: arr for _, key, arr in port_leaves(pretrained[collection], stats)
                if key is not None}
        loaded = 0
        with torch.no_grad():
            for name, t in have.items():
                arr = flat.get(name)
                if arr is None or tuple(arr.shape) != tuple(t.shape):
                    continue
                src = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(arr)
                t.copy_(src.to(t.dtype))
                loaded += 1
        log.info("%s: loaded %d/%d leaves from pretrained", collection, loaded, len(have))
        counts[collection] = (loaded, len(have))
    return counts


# the converted point tower's file by model (ppt_tpu/train/checkpoint.py:122-129)
BACKBONE_FILES = {
    "ULIP_PN_SSG": "pointnet2_ssg",
    "ULIP_PN_MSG": "pointnet2_msg_1kpts",
    "ULIP_PN_MLP": "pointmlp",
    "ULIP_PN_NEXT": "pointnext",
}


def backbone_file(args) -> Optional[str]:
    """The converted point tower's file name for ``args.model`` (PointBERT
    and its part-segmentation trunk: ``pointbert``, or ``pointbert_ulip2``
    under ``--ulip2``; the partseg trunk loads the cls trunk's leaves and its
    heads keep their init)."""
    if args.model in ("ULIP_PointBERT", "ULIP_PointBERT_partseg"):
        return "pointbert_ulip2" if args.ulip2 else "pointbert"
    return BACKBONE_FILES.get(args.model)


def load_pretrained_backbones(args, model: nn.Module) -> List[Tuple[str, Dict]]:
    """Load ``{pretrained_dir}/<backbone>.msgpack``, then
    ``{pretrained_dir}/slip_text.msgpack`` (so SLIP's ``logit_scale`` wins,
    as in the reference), into ``model`` in place. Returns (path, counts)
    per file loaded; ``FileNotFoundError`` when neither exists."""
    paths = []
    fname = backbone_file(args)
    if fname:
        paths.append(os.path.join(args.pretrained_dir, fname + ".msgpack"))
    paths.append(os.path.join(args.pretrained_dir, "slip_text.msgpack"))
    loaded = [(p, merge_pretrained(model, load_params_file(p)))
              for p in paths if os.path.exists(p)]
    if not loaded:
        raise FileNotFoundError(f"no converted checkpoints in {args.pretrained_dir}")
    return loaded
