"""FLOP audit of the benchmark workloads -> ``ppt_torch/assets/flops.json``.

Counterpart of the repository's ``tools/flops_audit.py``, which lowers the
JAX programs on the CPU and reads XLA's cost analysis into
``ppt_tpu/assets/flops.json``. Here ``FlopCounterMode`` counts the card's
program itself: every tensor lies on the ``meta`` device at full width in
the card's compute dtype (bf16), so each kernel entry point takes its
registered operator's fake and counts by its formula (``kernels/_ops.py``),
every library product by PyTorch's, and no weight is computed, no kernel
built and no card needed: the whole audit takes seconds on a CPU. The
counts are the card's because a meta tensor takes the card's route through
every wrapper (``tests/test_torch_card_route.py`` holds the launches, and
``chip_smoke.py`` phase 17 the card's own count).

Workloads (FLOPs a cloud; the JAX tool's four, at its shapes):
  - ``train_per_cloud``: PPT-Base's prompt-tuning step, B=32 x 1024,
    head_type 0, label smoothing 0.2, AdamW on the cosine schedule;
  - ``n8192_fwd_per_cloud``: PPT-Base's forward (point and text towers),
    B=32 x 8192;
  - ``n8192_train_per_cloud``: the train step at B=32 x 8192;
  - ``anchor_per_cloud``: PointNeXt-S's forward, B=128 x 1024 x 4.

    python -m ppt_torch.tools.flops_audit [--out PATH]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Callable, Dict, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from ppt_torch.kernels._ops import OpCounter
from ppt_torch.models.ulip import PromptArrays, build_model, trainable_mask
from ppt_torch.nn.pointbert import PointBertConfig
from ppt_torch.nn.pointnext import PointNext, PointNextConfig
from ppt_torch.prompt.learner import build_prompt_spec
from ppt_torch.tasks.args import TaskArgs
from ppt_torch.train.optim import build_optimizer, build_schedule
from ppt_torch.train.trainer import create_train_state, make_train_step

OUT = Path(__file__).resolve().parent.parent / "assets" / "flops.json"
COMPUTE_DTYPE = "bfloat16"
# name -> (what runs, batch, points a cloud)
WORKLOADS = {"train_per_cloud": ("train", 32, 1024),
             "n8192_fwd_per_cloud": ("forward", 32, 8192),
             "n8192_train_per_cloud": ("train", 32, 8192),
             "anchor_per_cloud": ("anchor", 128, 1024)}
PROVENANCE = ("FlopCounterMode over the card's program traced on meta tensors at full width "
              "in bf16: library products by PyTorch's formulas, the ppt operators by their "
              "registered ones (2 a multiply-add). Regenerate: python -m "
              "ppt_torch.tools.flops_audit")


def clouds(batch: int, npoints: int, channels: int, device) -> torch.Tensor:
    """Clouds in the unit cube from seed 0 (numpy); shapes only on meta."""
    if torch.device(device).type == "meta":
        return torch.empty(batch, npoints, channels, device=device)
    rng = np.random.RandomState(0)
    return torch.from_numpy(rng.rand(batch, npoints, channels).astype(np.float32)).to(device)


def ppt_base(device, point_route: str = "block", text_route: str = "off",
             num_group: int = 512) -> Tuple[torch.nn.Module, PromptArrays]:
    """PPT-Base at full width (``PointBertConfig(num_group=...)``, the CLIP
    text tower, 32 prompt tokens "middle", ModelNet40's classes) on
    ``device`` in ``COMPUTE_DTYPE``, weights from seed 0; the trunk on
    ``point_route``, the text tower on ``text_route``."""
    args = TaskArgs(num_learnable_prompt_tokens=32, class_name_position="middle",
                    compute_dtype=COMPUTE_DTYPE, seed=0)
    args.pointbert_config = PointBertConfig(num_group=num_group)
    args.point_route = point_route
    prompts = PromptArrays.from_spec(
        build_prompt_spec(args.load_classnames(), n_ctx=32, class_name_position="middle"),
        device=device)
    return build_model("ULIP_PointBERT", args, device=device, text_fused=text_route).model, prompts


def forward(model, prompts, batch: int, npoints: int, device) -> Callable[[], None]:
    """The forward of both towers on one batch, as the JAX tool counts it."""
    pc = clouds(batch, npoints, 3, device)

    def run():
        with torch.no_grad():
            model(pc, prompts)
    return run


def train_step(model, prompts, batch: int, npoints: int, device) -> Callable[[], None]:
    """One prompt-tuning step (``train/trainer.py:make_train_step``, label
    smoothing 0.2, AdamW on the cosine schedule of ``tools/flops_audit.py``:
    3e-3 to 1e-5 over 250 epochs of 100 steps, one warm-up epoch), head_type 0."""
    sched = build_schedule("cosine", 3e-3, 250, 100, final_lr=1e-5, warmup_epochs=1)
    state = create_train_state(model, trainable_mask(model, head_type=0),
                               lambda tr: build_optimizer("adamw", tr.items(), sched), seed=1)
    step = make_train_step(smoothing=0.2)
    pc = clouds(batch, npoints, 3, device)
    labels = torch.zeros(batch, dtype=torch.long, device=device)
    return lambda: step(state, {"pc": pc, "label": labels}, prompts)


def anchor(batch: int, npoints: int, device) -> Callable[[], None]:
    """PointNeXt-S's forward (``PointNextConfig()``, the height channel in) in
    ``COMPUTE_DTYPE``."""
    model = PointNext(PointNextConfig(in_channels=4),
                      dtype=getattr(torch, COMPUTE_DTYPE)).to(device).eval()
    pc = clouds(batch, npoints, 4, device)

    def run():
        with torch.no_grad():
            model(pc)
    return run


def workload(name: str, device) -> Callable[[], None]:
    """The audit's workload ``name`` on ``device``, ready to run once."""
    kind, batch, npoints = WORKLOADS[name]
    if kind == "anchor":
        return anchor(batch, npoints, device)
    model, prompts = ppt_base(device)
    return (forward if kind == "forward" else train_step)(model, prompts, batch, npoints, device)


def trace(run: Callable[[], None]) -> Tuple[int, Dict[str, int]]:
    """(FLOPs, the ``ppt`` operators called by name) of one ``run()``."""
    with FlopCounterMode(display=False) as flops, OpCounter() as ops:
        run()
    return flops.get_total_flops(), dict(ops.counts)


def audit() -> Dict[str, float]:
    """Each workload's FLOPs a cloud, traced on meta tensors (no card)."""
    meta = torch.device("meta")
    out = {"_provenance": PROVENANCE}
    for name, (_, batch, _) in WORKLOADS.items():
        out[name] = trace(workload(name, meta))[0] / batch
    return out


def main(argv=None) -> Dict[str, float]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=str(OUT))
    a = p.parse_args(argv)
    results = audit()
    for name in WORKLOADS:
        print(f"{name}: {results[name] / 1e9:.3f} GFLOP/cloud")
    with open(a.out, "w") as f:
        json.dump(results, f, indent=2)
        f.write("\n")
    print(f"wrote {a.out}")
    return results


if __name__ == "__main__":
    main()
