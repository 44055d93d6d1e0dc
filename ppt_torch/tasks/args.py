"""Task CLI: the flag surface of ``ppt_tpu/tasks/args.py`` for the port.

The flags the evaluation path reads, with the reference package's names
and defaults, plus ``--device`` (empty: the card). Training flags and
``--config`` YAML files come with the training slice.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import List, Optional


@dataclasses.dataclass
class TaskArgs:
    # data
    dataset_name: str = "modelnet40"
    data_path: str = "data"
    npoints: int = 8192
    allow_synthetic_fallback: bool = True
    # prompt
    template_init: str = ""
    num_learnable_prompt_tokens: int = 32
    class_name_position: str = "end"
    # model
    model: str = "ULIP_PointBERT"
    test_ckpt_addr: str = ""
    # evaluation
    batch_size: int = 64
    evaluate_3d: bool = False
    seed: int = 0
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'
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
            if self.dataset_name in catalog:
                self.classnames = catalog[self.dataset_name]
                return self.classnames
        raise FileNotFoundError(f"no classnames for {self.dataset_name} in {labels_path}")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="PPT PyTorch port: evaluation")
    for field in dataclasses.fields(TaskArgs):
        if field.name == "classnames":
            continue
        arg = "--" + field.name
        if isinstance(field.default, bool):
            p.add_argument(arg, action="store_true", default=None)
        else:
            p.add_argument(arg, type=type(field.default), default=None)
    return p


def parse_args(argv=None) -> TaskArgs:
    ns = build_argparser().parse_args(argv)
    args = TaskArgs()
    for k, v in vars(ns).items():
        if v is None:
            continue
        setattr(args, k, v)
    return args
