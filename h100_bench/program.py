"""The system under test, built from a configuration file.

Everything here goes through ``ppt_torch``'s own entry points: ``TaskArgs``
carries the recipe, the model comes out of ``models.ulip.MODEL_REGISTRY``
on the routes ``tasks.cls`` reads from the environment (its defaults:
this harness clears the switches), the prompts out of ``build_prompt_spec``
and ``PromptArrays``, and the seeded weights go in by a strict
``load_state_dict``. What ``build_model`` would add, an initialisation on
the host, is left out: the weights are drawn on the card instead.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict

import numpy as np
import torch

ROUTE_SWITCHES = ("PPT_FUSED_TEXT", "PPT_FUSED_TEXT_TOWER", "PPT_FORCE_XLA_ATTN",
                  "PPT_FUSED_BLOCK", "PPT_FUSED_VIT_TOWER")
LOADER_SEEDS = 42000  # Loader seeds its epochs with seed * 100003 + epoch < 2**32


def program_seed(seed: int) -> int:
    """The seed the program's own generators get (loader order, DropPath,
    augmentation): ``Loader`` takes no seed of 32 bits."""
    return seed % LOADER_SEEDS


@dataclasses.dataclass
class Program:
    args: object  # ppt_torch.tasks.args.TaskArgs
    model: torch.nn.Module
    prompts: object  # ppt_torch.models.ulip.PromptArrays
    classnames: list


def task_args(cfg: Dict, seed: int, device):
    from ppt_torch.nn.pointbert import PointBertConfig
    from ppt_torch.nn.pointnext import PointNextConfig
    from ppt_torch.nn.text import TextConfig
    from ppt_torch.tasks.args import TaskArgs

    t = cfg["train"]
    args = TaskArgs(
        model=cfg["model"], npoints=cfg["npoints"], use_height=cfg["use_height"],
        batch_size=cfg["batch_size"], compute_dtype=cfg["compute_dtype"],
        num_learnable_prompt_tokens=cfg["prompt"]["n_ctx"],
        class_name_position=cfg["prompt"]["class_name_position"],
        head_type=t["head_type"], label_smoothing=t["label_smoothing"], optim=t["optim"],
        sched=t["sched"], lr=t["lr"], lr_start=t["lr_start"], lr_end=t["lr_end"],
        warmup_epochs=t["warmup_epochs"], epochs=t["epochs"], wd=t["wd"],
        betas=tuple(t["betas"]), eps=t["eps"], data_ratio=t["data_ratio"],
        seed=program_seed(seed), device=str(device), classnames=list(cfg["classnames"]))
    point = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["point"].items()}
    if cfg["model"] == "ULIP_PointBERT":
        args.pointbert_config = PointBertConfig(**point)
    else:
        args.pointnext_config = PointNextConfig(**point)
    args.text_config = TextConfig(**cfg["text"])
    return args


def build(cfg: Dict, weights: Dict[str, torch.Tensor], seed: int, device) -> Program:
    """The model on ``device`` in eval mode with ``weights``, its prompts."""
    from ppt_torch.models.ulip import MODEL_REGISTRY, PromptArrays
    from ppt_torch.prompt.learner import build_prompt_spec
    from ppt_torch.tasks import cls

    for k in ROUTE_SWITCHES:
        os.environ.pop(k, None)
    args = task_args(cfg, seed, device)
    classnames = args.load_classnames()
    spec = build_prompt_spec(classnames, n_ctx=args.num_learnable_prompt_tokens,
                             class_name_position=args.class_name_position,
                             template_init=args.template_init)
    prompts = PromptArrays.from_spec(spec, device=device)
    args.point_route = cls.point_route_from_env()
    with torch.device(device):
        model = MODEL_REGISTRY[args.model](args, text_fused=cls.text_route_from_env()).model
    model.to(device)
    model.load_state_dict(weights, strict=True)
    return Program(args, model.eval(), prompts, classnames)


def dataset(points: np.ndarray, labels: np.ndarray, classnames):
    from ppt_torch.data.datasets import ArrayDataset

    return ArrayDataset(points, labels, list(classnames), name="synthetic")
