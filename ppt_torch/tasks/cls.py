"""Recognition task driver, inference path (``--evaluate_3d``).

Counterpart of ``ppt_tpu/tasks/cls.py:setup``, ``:validate`` and the
``--evaluate_3d`` branch of ``:main`` (``:318-327``): the text tower runs
once per pass (``make_cached_text_eval``), then every batch runs the
point tower and one product. Without ``--test_ckpt_addr`` the weights
are random from ``--seed``. Training (``train_loop``) and checkpoint
loading belong to later slices.

    python -m ppt_torch.tasks.cls --evaluate_3d --dataset_name synthetic \
        --npoints 1024 --batch_size 32 [--device cpu]
"""

from __future__ import annotations

import logging
import sys
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from ppt_torch.data.datasets import build_dataset
from ppt_torch.data.loader import Loader
from ppt_torch.models.ulip import PromptArrays, build_model
from ppt_torch.prompt.learner import build_prompt_spec
from ppt_torch.tasks.args import TaskArgs, parse_args
from ppt_torch.train.eval import make_cached_text_eval
from ppt_torch.utils.device import resolve_device
from ppt_torch.utils.metrics import per_class_accuracy

log = logging.getLogger(__name__)


def setup(args: TaskArgs) -> Dict:
    """Dataset, prompts and model on ``args.device`` (the card if empty)."""
    device = resolve_device(args.device or None)
    test_ds = build_dataset(args.dataset_name, args, "test")
    if test_ds.name.startswith("synthetic"):
        classnames = test_ds.classnames
    else:
        classnames = args.load_classnames()
    spec = build_prompt_spec(
        classnames,
        n_ctx=args.num_learnable_prompt_tokens,
        class_name_position=args.class_name_position,
        template_init=args.template_init,
    )
    prompts = PromptArrays.from_spec(spec, device=device)
    model = build_model(args.model, args, device=device).model
    return {
        "classnames": classnames,
        "test_ds": test_ds,
        "prompts": prompts,
        "model": model,
        "device": device,
    }


def validate(state, eval_fn, test_ds, prompts, args: TaskArgs, device) -> Dict[str, float]:
    """Eval loop over ``test_ds``; ``eval_fn`` is the (embed, step) pair of
    ``make_cached_text_eval``."""
    embed_fn, step_fn = eval_fn
    text_embed = embed_fn(state, prompts)
    preds, labels = [], []
    for batch in Loader(test_ds, batch_size=args.batch_size):
        valid = batch["valid"]
        pc = torch.from_numpy(batch["pc"].astype(np.float32)).to(device)
        logits = step_fn(state, {"pc": pc}, text_embed)
        preds.append(logits.argmax(-1).cpu().numpy()[valid])
        labels.append(batch["label"][valid])
    preds = np.concatenate(preds)
    labels = np.concatenate(labels)
    acc = 100.0 * float(np.mean(preds == labels))
    return {"acc1": acc, "per_class": per_class_accuracy(preds, labels, test_ds.num_classes)}


def main(args: Optional[Union[TaskArgs, Sequence[str]]] = None) -> Dict[str, float]:
    if not isinstance(args, TaskArgs):
        args = parse_args(args)
    logging.basicConfig(level=logging.INFO)
    if not args.evaluate_3d:
        raise SystemExit("ppt_torch.tasks.cls runs the --evaluate_3d path; training is "
                         "not ported yet")
    if args.test_ckpt_addr:
        raise NotImplementedError("loading a JAX .msgpack checkpoint is not ported yet")
    ctx = setup(args)
    model = ctx["model"]
    val = validate(model, make_cached_text_eval(model), ctx["test_ds"], ctx["prompts"],
                   args, ctx["device"])
    log.info("eval acc1=%.2f", val["acc1"])
    return {"best_acc": val["acc1"], "best_epoch": -1, "history": []}


if __name__ == "__main__":
    main(sys.argv[1:])
