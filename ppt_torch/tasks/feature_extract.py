"""Frozen-feature extraction: the linear probe's first stage, and the
recognition dump.

Counterpart of ``ppt_tpu/tasks/feature_extract.py``: ``main`` runs the
frozen point tower in eval mode over the train and test splits and writes
``<output_dir>/<exp_name or "lp_feats">/{train,test}.npz`` (``feature_list``
f32, the readout before ``pc_projection``, and ``label_list``);
``save_recog_feats`` writes the test split's features with their logits to
``<output_dir>/<exp_name or "recog_feats">/recog_feats.npz``. The split,
prompts and model are built as ``tasks/cls.py:setup`` builds them, with the
converted backbones from ``--pretrained_dir`` where they exist;
``--test_ckpt_addr`` restores a trained partition from the port's
``checkpoint_best.pt`` (the reference merges a msgpack there). The text
tower runs once per split; each batch's logits then come from its features,
by the ops of ``train/eval.py``'s eval step. Under ``--use_height`` the
height goes in as a 4th channel, as ``cls.validate`` gives it.

    python -m ppt_torch.tasks.feature_extract --dataset_name modelnet40 \
        --npoints 1024 --batch_size 32 [--test_ckpt_addr outputs/cls] [--device cpu]
    python -m ppt_torch.tasks.linear_probe      # reads the two files
    python -m ppt_torch.tasks.feature_extract --save_recog_feats ...  # the recognition dump
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from ppt_torch.data.augment import append_height
from ppt_torch.data.datasets import build_dataset
from ppt_torch.data.loader import Loader
from ppt_torch.tasks import cls
from ppt_torch.tasks.args import TaskArgs, parse_args
from ppt_torch.train.checkpoint import load_checkpoint
from ppt_torch.utils.device import resolve_device

log = logging.getLogger(__name__)


@torch.no_grad()
def extract_features(args: TaskArgs, split: str,
                     with_logits: bool = False) -> Dict[str, np.ndarray]:
    """The frozen point tower over ``split``: ``feature_list`` [n, F] f32,
    ``label_list`` [n] and, ``with_logits``, ``logits`` [n, C] f32; the
    padded rows of the last batch dropped."""
    device = resolve_device(args.device or None)
    ds = build_dataset(args.dataset_name, args, split)
    classnames = ds.classnames if ds.name.startswith("synthetic") else args.load_classnames()
    prompts, model = cls.prompts_and_model(args, classnames, device)
    if args.test_ckpt_addr:
        state, _ = cls.train_state(args, model, 1)
        load_checkpoint(args.test_ckpt_addr, state)
    text_embed = model.encode_text(prompts) if with_logits else None

    feats_out, logits_out, labels_out = [], [], []
    for batch in Loader(ds, batch_size=args.batch_size):
        valid = batch["valid"]
        pc = torch.from_numpy(batch["pc"].astype(np.float32)).to(device)
        if args.use_height:
            pc = append_height(pc)
        feats = model.point_encoder(pc, train=False).float()
        if with_logits:  # encode_pc's product, then eval_step's
            logits = torch.exp(model.logit_scale) * (feats @ model.pc_projection) @ text_embed.t()
            logits_out.append(logits.cpu().numpy()[valid])
        feats_out.append(feats.cpu().numpy()[valid])
        labels_out.append(batch["label"][valid])
    result = {"feature_list": np.concatenate(feats_out),
              "label_list": np.concatenate(labels_out)}
    if with_logits:
        result["logits"] = np.concatenate(logits_out)
    return result


def main(args: Optional[Union[TaskArgs, Sequence[str]]] = None) -> str:
    """Train and test features to ``<output_dir>/<exp_name or
    "lp_feats">/{train,test}.npz``; returns the directory."""
    if not isinstance(args, TaskArgs):
        args = parse_args(args)
    logging.basicConfig(level=logging.INFO)
    out_dir = os.path.join(args.output_dir, args.exp_name or "lp_feats")
    os.makedirs(out_dir, exist_ok=True)
    for split in ("train", "test"):
        data = extract_features(args, split)
        path = os.path.join(out_dir, f"{split}.npz")
        np.savez(path, **data)
        log.info("%s: %s features -> %s", split, data["feature_list"].shape, path)
    return out_dir


def save_recog_feats(args: Optional[Union[TaskArgs, Sequence[str]]] = None) -> str:
    """The test split's logits and features to ``<output_dir>/<exp_name or
    "recog_feats">/recog_feats.npz``; returns the file."""
    if not isinstance(args, TaskArgs):
        args = parse_args(args)
    logging.basicConfig(level=logging.INFO)
    out_dir = os.path.join(args.output_dir, args.exp_name or "recog_feats")
    os.makedirs(out_dir, exist_ok=True)
    data = extract_features(args, "test", with_logits=True)
    path = os.path.join(out_dir, "recog_feats.npz")
    np.savez(path, **data)
    log.info("saved logits %s features %s -> %s", data["logits"].shape,
             data["feature_list"].shape, path)
    return path


if __name__ == "__main__":
    argv = sys.argv[1:]
    if "--save_recog_feats" in argv:  # save_recog_feats.py's dump instead
        argv.remove("--save_recog_feats")
        save_recog_feats(argv)
    else:
        main(argv)
