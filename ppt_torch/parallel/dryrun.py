"""The multi-rank dry run: the counterpart of the reference's
``dryrun_multichip`` (``__graft_entry__.py:134``).

    python -m ppt_torch.parallel.dryrun --nproc N [--device cuda|cpu]

runs on the card unless ``--device cpu`` is given (without CUDA it raises
rather than fall back to the CPU, as every entry point of the port), and
spawns N ranks of one group (``nccl`` where each rank owns a card, else
gloo: the CPU, or ranks that share a card) and runs four stages on tiny
models, each held against the same step in one process, which every rank
also runs:

  1. recognition at dp = N/2 x tp = 2 (pure dp below 4 ranks): one AdamW
     step training the prompt and the last block, whose matrices are
     sharded over the 'model' axis; its loss must equal one process's;
  2. part segmentation at dp = N: the loss equal to one process's, the
     BatchNorm statistics moved (sync-BN);
  3. ULIP pretraining at dp = N: the InfoNCE over the global batch, its
     loss equal to one process's, the point encoder moved;
  4. the pipeline at dp = 2 x pp = N/2 (N a multiple of 4): the trunk
     pipelined, the loss equal to the sequential model's, the last stage's
     block moved by an Adam update of the gradients.

Each stage prints one line; the run exits non-zero when a rank fails.
``run_dryrun`` is the function each rank runs.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
from typing import Dict, List

import numpy as np
import torch

# the reference's tiny widths, but 64 wide: the card's kernels take head dims
# that are multiples of 8 (16 here, 2 heads of 16 a rank under tp = 2)
TINY = dict(trans_dim=64, depth=2, num_heads=4, group_size=8, num_group=16, encoder_dims=32,
            drop_path_rate=0.0)
SEG = dict(TINY, depth=12)  # the partseg trunk taps blocks 3, 7 and 11
PIPE = dict(TINY, depth=4)
TEXT = dict(width=64, layers=2, heads=4, embed_dim=64)
N_POINTS = 64


def _labels() -> List[str]:
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets",
                        "labels.json")
    with open(path) as f:
        return json.load(f)["modelnet40"]


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= 1e-4 * max(1.0, abs(b))


def _moved(after: Dict[str, torch.Tensor], before: Dict[str, torch.Tensor]) -> float:
    return float(sum((after[k] - before[k]).abs().sum() for k in after))


def _pipeline_stage(world: int, device, rng: np.random.RandomState) -> str:
    """Stage 4: a prompt-tuning loss through the pipelined trunk, its
    gradients reduced, one Adam update."""
    from ppt_torch.models.losses import smoothed_cross_entropy
    from ppt_torch.parallel.collectives import global_mean, reduce_gradients
    from ppt_torch.parallel.mesh import axis_group, create_mesh, shard_batch
    from ppt_torch.parallel.pipeline import grad as pipeline_grad
    from ppt_torch.parallel.pipeline import pipelined_trunk_features
    from ppt_torch.parallel.workers import build_ulip
    from ppt_torch.train.optim import Adam

    pp, dp, n_micro = world // 2, 2, 4
    mesh = create_mesh(axis_names=("data", "pipe"), shape=(dp, pp))
    spec = dict(point=PIPE, text=TEXT, classes=[f"thing {i}" for i in range(10)], n_ctx=4,
                seed=6, class_name_position="middle")
    model, prompts = build_ulip(spec, device)
    last = f"point_encoder.block_{PIPE['depth'] - 1}"
    trainable = {k: p for k, p in model.named_parameters()
                 if k.startswith(("prompt_learner", last))}
    for k, p in model.named_parameters():
        p.requires_grad_(k in trainable)
    B = n_micro * dp
    pc = torch.from_numpy(rng.rand(B, N_POINTS, 3).astype(np.float32)).to(device)
    labels = torch.arange(B, device=device) % 10

    def loss_of(feat, lab):
        pc_embed = feat.float() @ model.pc_projection
        logits = torch.exp(model.logit_scale) * pc_embed @ model.encode_text(prompts).t()
        return smoothed_cross_entropy(logits, lab, 0.0)

    with torch.no_grad():
        seq = float(loss_of(model.point_encoder(pc, train=False), labels))
    rows = shard_batch({"pc": pc, "label": labels}, mesh)
    feat = pipelined_trunk_features(model.point_encoder, rows["pc"], mesh, n_micro=n_micro)
    loss = loss_of(feat, rows["label"])
    names = list(trainable)
    grads = dict(zip(names, pipeline_grad(loss, [trainable[k] for k in names])))
    grads = reduce_gradients(grads, world, {})
    pp_loss = float(global_mean(loss.detach(), axis_group(mesh, "data")))  # the shards' mean
    if not math.isfinite(pp_loss) or not _close(pp_loss, seq):
        raise AssertionError(f"pp loss {pp_loss} != sequential {seq}")
    before = {k: v.detach().clone() for k, v in trainable.items() if k.startswith(last)}
    Adam(trainable.items(), lambda count: 1e-3).step(grads)
    delta = _moved({k: trainable[k].detach() for k in before}, before)
    if not delta > 0.0:
        raise AssertionError("pp backward did not reach the last stage's block")
    return (f"dryrun({world}): pipeline mesh=(dp={dp}, pp={pp}) loss={pp_loss:.4f} "
            f"(= sequential {seq:.4f}) adapter_delta={delta:.3e} ok")


def run_dryrun(rank: int, world: int, device, payload=None) -> List[str]:
    """The four stages on this rank; returns the printed lines."""
    from ppt_torch.parallel import workers

    lines = []
    tp = 2 if world >= 4 and world % 2 == 0 else 1
    dp = world // tp
    rng = np.random.RandomState(0)
    B = 2 * dp
    cls = dict(kind="step", name="cls",
               model=dict(point=TINY, text=TEXT, classes=_labels(), n_ctx=4, seed=0,
                          class_name_position="middle"),
               batch={"pc": rng.rand(B, N_POINTS, 3).astype(np.float32),
                      "label": np.arange(B) % 40},
               trainable=["prompt_learner", f"point_encoder.block_{TINY['depth'] - 1}"],
               optim="adamw", lr=3e-3,
               mesh=dict(axes=("data", "model"), shape=(dp, tp)))
    got = workers.step_job(cls, device)
    want = workers.step_job(dict(cls, mesh=None), device)
    if not (math.isfinite(got["loss"]) and _close(got["loss"], want["loss"])):
        raise AssertionError(f"cls loss {got['loss']} != one process {want['loss']}")
    lines.append(f"dryrun({world}): cls mesh=(dp={dp}, tp={tp}) loss={got['loss']:.4f} ok")

    Bd = 2 * world
    seg = dict(kind="step", name="seg",
               model=dict(point=SEG, text=TEXT, classes=[f"part {i}" for i in range(8)],
                          n_ctx=4, seed=2, task="partseg", class_name_position="middle"),
               batch={"pc": rng.rand(Bd, 512, 3).astype(np.float32),
                      "label": rng.randint(0, 8, (Bd, 512)),
                      "cls_onehot": np.eye(16, dtype=np.float32)[rng.randint(0, 16, Bd)]},
               head_type=0, task="partseg", optim="adamw", lr=1e-3,
               mesh=dict(axes=("data",), shape=(world,)))
    got = workers.step_job(seg, device)
    want = workers.step_job(dict(seg, mesh=None), device)
    if not (math.isfinite(got["loss"]) and _close(got["loss"], want["loss"])):
        raise AssertionError(f"partseg loss {got['loss']} != one process {want['loss']}")
    moved = _moved(got["stats"], got["stats_before"])
    if not moved > 0.0:
        raise AssertionError("partseg BN statistics did not move under dp")
    lines.append(f"dryrun({world}): partseg dp={world} loss={got['loss']:.4f} "
                 f"bn_delta={moved:.3e} ok")

    tokens = np.zeros((Bd, 77), dtype=np.int64)
    tokens[:, 0], tokens[:, 1], tokens[:, 2] = 49406, 320 + np.arange(Bd), 49407
    pre = dict(kind="pretrain", name="pre",
               model=dict(point=TINY, text=TEXT, classes=_labels()[:2], n_ctx=4, seed=4),
               batch={"pc": rng.rand(Bd, N_POINTS, 3).astype(np.float32), "tokens": tokens},
               optim="adamw", lr=1e-3, mesh=dict(axes=("data",), shape=(world,)))
    got = workers.pretrain_job(pre, device)
    want = workers.pretrain_job(dict(pre, mesh=None), device)
    if not (math.isfinite(got["loss"]) and _close(got["loss"], want["loss"])):
        raise AssertionError(f"pretrain loss {got['loss']} != one process {want['loss']}")
    model, _ = workers.build_ulip(pre["model"], device)
    start = {k: v.detach().cpu() for k, v in model.named_parameters() if k in got["trainable"]
             and k.startswith("point_encoder")}
    delta = _moved({k: got["trainable"][k] for k in start}, start)
    if not delta > 0.0:
        raise AssertionError("pretrain gradients did not reach the point encoder")
    lines.append(f"dryrun({world}): pretrain dp={world} loss={got['loss']:.4f} "
                 f"enc_delta={delta:.3e} ok")

    if world >= 4 and world % 4 == 0:
        lines.append(_pipeline_stage(world, device, rng))
        lines.append(f"dryrun({world}): cls+partseg+pretrain+pipeline all ok")
    else:
        lines.append(f"dryrun({world}): cls+partseg+pretrain all ok")
    return lines


def main(argv=None) -> int:
    from ppt_torch.kernels import _build
    from ppt_torch.parallel.launch import spawn
    from ppt_torch.parallel.mesh import default_backend
    from ppt_torch.utils.device import resolve_device

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nproc", type=int, default=4)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--timeout", type=float, default=900.0)
    a = p.parse_args(argv)
    resolve_device(a.device)  # raises by name when the card is asked for and CUDA is missing
    if a.device == "cuda":
        _build.build_all()  # once, before the ranks start: each only loads the libraries
    with tempfile.TemporaryDirectory(prefix="ppt_dryrun_") as work:
        lines = spawn("ppt_torch.parallel.dryrun:run_dryrun", a.nproc, None, workdir=work,
                      backend=default_backend(a.device, a.nproc), device=a.device,
                      timeout=a.timeout)[0]
    for line in lines:
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
