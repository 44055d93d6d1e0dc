"""Task CLI: the flag surface of ``ppt_tpu/tasks/args.py`` for the port.

The flags the recognition, few-shot and pretraining tasks read, with the
reference package's names and defaults, plus ``--device`` (empty: the card).
``--config`` YAML files are not ported yet, so the published recipe is
spelled out as flags.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import List, Optional, Tuple


@dataclasses.dataclass
class TaskArgs:
    # data
    output_dir: str = "outputs"
    dataset_name: str = "modelnet40"
    data_path: str = "data"
    use_height: bool = False
    npoints: int = 8192
    nshots: int = 16
    allow_synthetic_fallback: bool = True
    # prompt
    template_init: str = ""
    num_learnable_prompt_tokens: int = 32
    class_name_position: str = "end"
    # model
    model: str = "ULIP_PointBERT"
    head_type: int = 0
    test_ckpt_addr: str = ""
    pretrained_dir: str = "data/pretrained_models"
    # training
    epochs: int = 250
    warmup_epochs: int = 1
    start_epoch: int = 0
    batch_size: int = 64
    data_ratio: float = 1.0
    optim: str = "adamw"
    sched: str = "cosine"
    lr: float = 3e-3
    lr_start: float = 1e-6
    lr_end: float = 1e-5
    wd: float = 0.1
    betas: Tuple[float, float] = (0.9, 0.98)
    eps: float = 1e-8
    grad_norm_clip: float = 0.0  # global L2 clip before the update; 0 = off
    eval_freq: int = 1
    resume: str = ""
    label_smoothing: float = 0.3
    # system
    evaluate_3d: bool = False
    seed: int = 0
    task: str = "cls"
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'
    steps_per_dispatch: int = 1  # >1 is not ported yet
    exp_name: str = ""
    device: str = ""  # '' = cuda; 'cpu' runs the plain PyTorch path

    # populated at runtime
    classnames: Optional[List[str]] = None

    def load_classnames(self, labels_path: Optional[str] = None) -> List[str]:
        """Classnames from ``assets/labels.json`` keyed by dataset name."""
        if self.classnames is not None:
            return self.classnames
        if labels_path is None:
            labels_path = os.path.join(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                "assets", "labels.json",
            )
        if os.path.exists(labels_path):
            with open(labels_path) as f:
                catalog = json.load(f)
            for key in (self.dataset_name, self.dataset_name.replace("_fs", "")):
                if key in catalog:
                    self.classnames = catalog[key]
                    return self.classnames
        raise FileNotFoundError(f"no classnames for {self.dataset_name} in {labels_path}")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="PPT PyTorch port: training and evaluation")
    for field in dataclasses.fields(TaskArgs):
        if field.name == "classnames":
            continue
        arg = "--" + field.name
        if isinstance(field.default, bool):
            p.add_argument(arg, action="store_true", default=None)
        elif field.name == "betas":
            p.add_argument(arg, nargs=2, type=float, default=None)
        else:
            p.add_argument(arg, type=type(field.default), default=None)
    return p


def parse_args(argv=None) -> TaskArgs:
    ns = build_argparser().parse_args(argv)
    args = TaskArgs()
    for k, v in vars(ns).items():
        if v is None:
            continue
        setattr(args, k, tuple(v) if k == "betas" else v)
    return args
