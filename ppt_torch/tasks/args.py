"""Task CLI: the flag surface of ``ppt_tpu/tasks/args.py`` for the port.

The flags the recognition, few-shot, pretraining, linear-probe and
scene-segmentation tasks read, with the reference package's names and defaults, plus ``--device``
(empty: the card).
``--config`` reads an experiment YAML (``configs/experiments/*``) and
``--set KEY=VALUE ...`` overrides its keys; the order of precedence is the
reference's (``ppt_tpu/tasks/args.py:140-157``): defaults, then the YAML
with its overrides, then explicit flags.

    python -m ppt_torch.tasks.cls --config configs/experiments/ppt_base_mn40.yaml \
        --set epochs=1 --votes 3 [--device cpu]
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
    dataset_type: str = "test"  # read nowhere, as in the reference
    sonn_type: str = "hardest"  # ScanObjectNN variant: obj_only | obj_bg | hardest
    dataset_prompt: str = "modelnet40_64"  # read nowhere, as in the reference
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
    ulip2: bool = False  # the loader's PointBERT file: pointbert_ulip2.msgpack
    fpath: str = ""  # interpret_prompt: the checkpoint holding the learned prompt
    topk: int = 5  # interpret_prompt: nearest words per context vector
    pretrained_dir: str = "data/pretrained_models"
    # training
    epochs: int = 250
    warmup_epochs: int = 1
    start_epoch: int = 0
    batch_size: int = 64
    data_ratio: float = 1.0
    optim: str = "adamw"
    sched: str = "cosine"
    plateau_patience: int = 10  # epochs without improvement (sched=plateau)
    plateau_factor: float = 0.1  # update scale on a plateau
    lr: float = 3e-3
    lr_start: float = 1e-6
    lr_end: float = 1e-5
    update_freq: int = 1  # read nowhere, as in the reference
    wd: float = 0.1
    betas: Tuple[float, float] = (0.9, 0.98)
    eps: float = 1e-8
    grad_norm_clip: float = 0.0  # global L2 clip before the update; 0 = off
    eval_freq: int = 1
    resume: str = ""
    label_smoothing: float = 0.3
    # linear probe
    num_step: int = 8  # ternary-search steps on log10(C) after the grid
    num_run: int = 10  # shot subsets drawn per shot count
    # system
    print_freq: int = 10  # read nowhere, as in the reference
    evaluate_3d: bool = False
    seed: int = 0
    task: str = "cls"
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'
    steps_per_dispatch: int = 1  # >1: that many steps launched before the host reads a metric
    votes: int = 1  # evaluation votes in the train loop (vote 0 the untouched batch)
    # scene segmentation (tasks/sceneseg.py)
    voxel_size: float = 0.04
    voxel_max: int = 4096
    test_area: int = 5  # the S3DIS area held out
    eval_scene: bool = False  # the whole-scene (multi-voxel-pass) eval of the best checkpoint
    allow_train_eval: bool = False  # evaluate on the train split when val is missing
    max_eval_passes: int = 0  # 0: every voxel pass (the reference's full coverage)
    cm_out: str = ""  # where the eval confusion matrix goes (.npz, tools/s3dis_6fold.py)
    proj_name: str = "PPT_TPU"  # the wandb project (utils/logging_utils.py)
    exp_name: str = ""
    wandb: bool = False  # fan the logged metrics out to wandb too
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


# the fields of the reference's TaskArgs (``ppt_tpu/tasks/args.py:19-87``):
# a config key among them that the port lacks raises by name
REFERENCE_FIELDS = (
    "output_dir", "dataset_name", "dataset_type", "sonn_type", "dataset_prompt", "data_path",
    "use_height", "npoints", "nshots", "allow_synthetic_fallback", "template_init",
    "num_learnable_prompt_tokens", "class_name_position", "model", "head_type",
    "test_ckpt_addr", "ulip2", "fpath", "topk", "pretrained_dir", "epochs", "warmup_epochs",
    "start_epoch", "batch_size", "data_ratio", "optim", "sched", "plateau_patience",
    "plateau_factor", "lr", "lr_start", "lr_end", "update_freq", "wd", "betas", "eps",
    "grad_norm_clip", "eval_freq", "resume", "label_smoothing", "num_step", "num_run",
    "print_freq", "evaluate_3d", "seed", "task", "compute_dtype", "mesh_devices",
    "steps_per_dispatch", "votes", "voxel_size", "voxel_max", "test_area", "eval_scene",
    "allow_train_eval", "max_eval_passes", "cm_out", "proj_name", "exp_name", "wandb",
)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="PPT PyTorch port: training and evaluation")
    p.add_argument("--config", default="", help="experiment YAML (configs/experiments/*)")
    p.add_argument("--set", dest="overrides", nargs="*", default=[], metavar="KEY=VALUE",
                   help="dotted config overrides, each value read as YAML")
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
    """Later wins: the dataclass defaults, the ``--config`` YAML with its
    ``--set`` overrides, the explicit flags."""
    ns = build_argparser().parse_args(argv)
    args = TaskArgs()
    if ns.config:
        from ppt_torch.utils.config import apply_overrides, config_to_args, load_config

        args = config_to_args(apply_overrides(load_config(ns.config), ns.overrides or []), args)
    for k, v in vars(ns).items():
        if k in ("config", "overrides") or v is None:
            continue
        setattr(args, k, tuple(v) if k == "betas" else v)
    return args
