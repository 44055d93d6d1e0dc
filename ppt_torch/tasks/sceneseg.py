"""Scene semantic segmentation: the segmentation backbones on scene datasets.

Counterpart of ``ppt_tpu/tasks/sceneseg.py`` (the openpoints segmentation
example trainer): per-point label-smoothed cross entropy with labels < 0
ignored, a confusion matrix's mIoU and OA over fixed crops each epoch,
best-mIoU checkpoints with ``--resume``, and the whole-scene evaluation
(``--eval_scene``) of the best checkpoint: each raw room voxelized, pass
``i`` taking the i-th point of every voxel until every point is covered,
the eval step run over fixed-size tiles that wrap around, the logits
averaged back onto the raw points, optional rotation votes, mIoU over
whole scenes. ``--cm_out`` saves that confusion matrix for
``ppt_torch.tools.s3dis_6fold``.

The backbones are ``ptseg`` (Point Transformer, the reference's default),
``randlanet`` and ``baafnet``; ``stratified`` is refused by name. On the
card they compute in bf16 (BatchNorm in f32), on the CPU in f32, as the
reference computes in bf16 on its accelerator. The schedule is a cosine
decay over every step of the run; the optimizer comes by name
(``adahessian`` refused: this step threads no Hessian diagonal), and
``--betas`` left at the CLIP-style (0.9, 0.98) becomes (0.9, 0.999), the
segmentation recipes' AdamW default.

    python -m ppt_torch.tasks.sceneseg --dataset_name s3dis --data_path data/s3dis \\
        --model ptseg --npoints 4096 --voxel_max 4096 --batch_size 8 --epochs 100 \\
        --eval_scene --cm_out outputs/s3dis_a5.npz [--device cpu]
"""

from __future__ import annotations

import json
import logging
import math
import os
import sys
import time
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ppt_torch.data.datasets import build_dataset
from ppt_torch.data.loader import Loader
from ppt_torch.nn.layers import init_dense_
from ppt_torch.tasks.args import TaskArgs, parse_args
from ppt_torch.train.checkpoint import FILE, META, load_checkpoint, save_checkpoint
from ppt_torch.train.optim import build_optimizer
from ppt_torch.train.schedules import cosine_with_warmup
from ppt_torch.train.trainer import TrainState
from ppt_torch.utils.device import resolve_device
from ppt_torch.utils.logging_utils import ExperimentLogger
from ppt_torch.utils.metrics import ConfusionMatrix

log = logging.getLogger(__name__)


def _feat_channels(in_channels: int) -> int:
    """The width of the features the backbones get: the channels after xyz,
    or xyz itself when there are none (``_apply``)."""
    return in_channels - 3 if in_channels > 3 else 3


def _ptseg(num_classes: int, in_channels: int, dtype: torch.dtype) -> nn.Module:
    from ppt_torch.nn.pointtransformer import PointTransformerConfig, PointTransformerSeg

    return PointTransformerSeg(
        PointTransformerConfig(num_classes=num_classes, in_channels=in_channels),
        feat_channels=_feat_channels(in_channels), dtype=dtype)


def _randla(num_classes: int, in_channels: int, dtype: torch.dtype) -> nn.Module:
    from ppt_torch.nn.randlanet import RandLANet, RandLANetConfig

    return RandLANet(RandLANetConfig(num_classes=num_classes, d_in=max(in_channels, 3)),
                     dtype=dtype)


def _baaf(num_classes: int, in_channels: int, dtype: torch.dtype) -> nn.Module:
    from ppt_torch.nn.baafnet import BaafNet, BaafNetConfig

    return BaafNet(BaafNetConfig(num_classes=num_classes,
                                 dims=(max(in_channels, 3), 4, 16, 64, 128, 256, 512)),
                   feat_channels=_feat_channels(in_channels), dtype=dtype)


SEG_MODELS: Dict[str, Callable[[int, int, torch.dtype], nn.Module]] = {
    "ptseg": _ptseg, "randlanet": _randla, "baafnet": _baaf}


def backbone(name: str) -> Callable[[int, int, torch.dtype], nn.Module]:
    """``SEG_MODELS[name]``; ``stratified`` refused by name."""
    if name == "stratified":
        raise ValueError("sceneseg: --model stratified (the Stratified Transformer) is not "
                         "in the port yet: its slice has not landed")
    if name not in SEG_MODELS:
        raise KeyError(f"sceneseg: unknown model {name!r}; have {sorted(SEG_MODELS)}")
    return SEG_MODELS[name]


def build_model(name: str, num_classes: int, in_channels: int, dtype: torch.dtype,
                seed: int) -> nn.Module:
    """The backbone ``name`` with random weights from ``seed`` (lecun-normal
    Dense kernels drawn on the CPU, zero biases, identity BatchNorms)."""
    model = backbone(name)(num_classes, in_channels, dtype)
    with torch.no_grad():
        init_dense_(model, torch.Generator().manual_seed(seed))
    return model


def _apply(model_name: str, model: nn.Module, pts: torch.Tensor,
           feats: Optional[torch.Tensor], train: bool,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The backbones' signatures (``ppt_tpu/tasks/sceneseg.py:106-119``):
    BAAF-Net takes (xyz, features or xyz), RandLA-Net one row of xyz and
    features, PTSeg (xyz, features or None)."""
    if model_name == "baafnet":
        return model(pts, feats if feats is not None else pts, train, generator)
    if model_name == "randlanet":
        return model(pts if feats is None else torch.cat([pts, feats], -1), train, generator)
    return model(pts, feats, train)


def seg_loss(logits: torch.Tensor, labels: torch.Tensor, num_classes: int,
             smoothing: float = 0.0):
    """(loss, accuracy in percent): per-point label-smoothed cross entropy
    in f32 and accuracy over the points whose label is >= 0
    (``ppt_tpu/tasks/sceneseg.py:132-157``)."""
    valid = labels >= 0
    safe = torch.clamp_min(labels, 0).long()
    ll = F.log_softmax(logits.float(), dim=-1)
    if smoothing > 0.0:
        soft = F.one_hot(safe, num_classes).float() * (1.0 - smoothing) + smoothing / num_classes
        nll = -(soft * ll).sum(-1)
    else:
        nll = -torch.gather(ll, -1, safe[..., None])[..., 0]
    n = torch.clamp_min(valid.sum(), 1)
    loss = (nll * valid).sum() / n
    acc = ((logits.argmax(-1) == labels) & valid).sum() / n
    return loss, acc * 100.0


def make_seg_train_step(model_name: str, num_classes: int,
                        smoothing: float = 0.0) -> Callable:
    """``step(state, batch) -> metrics``: one optimizer step of every
    parameter on ``batch`` (``pts``, ``feats`` or None, ``label``), the
    model in training mode (batch statistics, dropout from the state's
    generator); ``metrics`` holds ``loss`` and ``acc`` as 0-dim tensors."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        logits = _apply(model_name, state.model, batch["pts"], batch.get("feats"), True,
                        state.generator)
        loss, acc = seg_loss(logits, batch["label"], num_classes, smoothing)
        names = list(state.optimizer.params)
        grads = torch.autograd.grad(loss, [state.optimizer.params[k] for k in names])
        state.optimizer.step(dict(zip(names, grads)))
        return {"loss": loss.detach(), "acc": acc.detach()}

    return step


def make_seg_eval_step(model_name: str, model: nn.Module, device) -> Callable:
    """``eval_fn(batch) -> logits`` with running statistics and no dropout;
    ``batch`` holds ``pts`` and maybe ``feats``, numpy or tensors."""

    @torch.no_grad()
    def eval_fn(batch):
        feats = batch.get("feats")
        return _apply(model_name, model, torch.as_tensor(batch["pts"], device=device),
                      None if feats is None else torch.as_tensor(feats, device=device), False)

    return eval_fn


def split_batch(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A loader batch's ``pc`` split into xyz and features, on ``device``."""
    pc = torch.from_numpy(batch["pc"].astype(np.float32)).to(device)
    return {"pts": pc[..., :3], "feats": pc[..., 3:] if pc.shape[-1] > 3 else None,
            "label": torch.from_numpy(batch["label"].astype(np.int64)).to(device)}


def whole_scene_eval(eval_fn: Callable, scene_ds, *, npoints: int, num_classes: int,
                     voxel_size: float = 0.04, batch_size: int = 8, num_votes: int = 1,
                     max_passes: int = 0, seed: int = 0) -> ConfusionMatrix:
    """Multi-voxel-pass whole-scene confusion matrix over RAW points
    (``ppt_tpu/tasks/sceneseg.py:196-278``), numpy around ``eval_fn``.

    Per scene and vote (a vote past the first turns the room by a random
    angle about z): voxelize (mode 1); pass ``i`` takes the i-th member of
    every voxel, so the passes cover every raw point; each pass is shuffled
    and tiled into ``npoints`` chunks that wrap around, batched to
    ``batch_size`` (a short batch repeated to size); the logits are summed
    onto the raw points and divided by their counts. ``max_passes`` 0 runs
    every pass. The draws are the reference's, from one
    ``RandomState(seed)``."""
    from ppt_torch.data.scenes import voxelize

    cm = ConfusionMatrix(num_classes)
    rng = np.random.RandomState(seed)
    for coord, feat, label in scene_ds.scenes:
        n_raw = coord.shape[0]
        logits_acc = np.zeros((n_raw, num_classes), np.float64)
        counts = np.zeros((n_raw,), np.float64)
        for vote in range(max(1, num_votes)):
            c = coord.astype(np.float32).copy()
            if vote > 0:
                ang = rng.uniform(0, 2 * np.pi)
                ca, sa = np.cos(ang), np.sin(ang)
                c = c @ np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]], np.float32).T
            c -= c.min(0)
            idx_sort, _, count = voxelize(c, voxel_size, mode=1)
            starts = np.cumsum(np.insert(count, 0, 0)[:-1])
            n_pass = int(count.max())
            if max_passes:
                n_pass = min(n_pass, max_passes)
            for i in range(n_pass):
                idx_part = idx_sort[starts + i % count]
                rng.shuffle(idx_part)
                n_tiles = max(1, math.ceil(idx_part.shape[0] / npoints))
                tiles = np.resize(idx_part, n_tiles * npoints).reshape(n_tiles, npoints)
                for ts in range(0, n_tiles, batch_size):
                    tb = tiles[ts:ts + batch_size]
                    real_b = tb.shape[0]
                    if real_b < batch_size:
                        tb = np.resize(tb, (batch_size, npoints))
                    pts = c[tb]
                    batch = {"pts": pts - pts.min(axis=1, keepdims=True)}
                    if feat is not None:
                        batch["feats"] = feat[tb].astype(np.float32)
                    logits = eval_fn(batch)
                    if isinstance(logits, torch.Tensor):
                        logits = logits.float().cpu().numpy()
                    logits = np.asarray(logits, dtype=np.float64)[:real_b]
                    flat = tb[:real_b].reshape(-1)
                    np.add.at(logits_acc, flat, logits.reshape(-1, num_classes))
                    np.add.at(counts, flat, 1.0)
        pred = np.argmax(logits_acc / np.maximum(counts, 1.0)[:, None], axis=-1)
        keep = (label >= 0) & (counts > 0)
        cm.update(pred[keep], label[keep].astype(np.int64))
    return cm


def load_eval_scenes(args):
    """The raw (un-voxelized) scenes of the eval split."""
    from ppt_torch.data import scenes

    name = args.dataset_name
    if name == "s3dis":
        return scenes.load_s3dis(args.data_path, "val", test_area=args.test_area,
                                 voxel_size=0.0)
    if name == "scannetv2":
        return scenes.load_scannetv2(args.data_path, "val")
    if name == "semantic_kitti":
        return scenes.load_semantic_kitti(args.data_path, "val")
    raise KeyError(f"whole-scene eval: unknown scene dataset {name}")


def _eval_split(args: TaskArgs, train_ds):
    """(val split, its name): the train split under ``--allow_train_eval``
    when val cannot be loaded, else the failure raised."""
    try:
        return build_dataset(args.dataset_name, args, "val"), "val"
    except Exception as e:
        if not args.allow_train_eval:
            raise RuntimeError(
                f"could not load the '{args.dataset_name}' val split ({e}); pass "
                "--allow_train_eval to evaluate on the TRAIN split (metric reported as "
                "train_miou)") from e
        log.warning("val split unavailable (%s): evaluating on the TRAIN split; the metric is "
                    "train_miou, NOT validation mIoU", e)
        return train_ds, "train"


def _resumed_best(path: str) -> float:
    """The best mIoU recorded beside a checkpoint (0 without its file)."""
    meta = os.path.join(path if os.path.isdir(path) else os.path.dirname(path), META)
    if not os.path.exists(meta):
        return 0.0
    with open(meta) as f:
        m = json.load(f)
    return max(float(m.get("miou", 0.0) or 0.0), float(m.get("train_miou", 0.0) or 0.0))


def crop_eval(eval_fn, test_ds, args: TaskArgs, num_classes: int) -> ConfusionMatrix:
    """The confusion matrix over the eval split's fixed crops."""
    cm = ConfusionMatrix(num_classes)
    for batch in Loader(test_ds, batch_size=args.batch_size, shuffle=False):
        valid = batch.pop("valid")
        pc = batch["pc"].astype(np.float32)
        logits = eval_fn({"pts": pc[..., :3], "feats": pc[..., 3:] if pc.shape[-1] > 3
                          else None})
        preds = logits.argmax(-1).cpu().numpy()[valid]
        labels = batch["label"][valid]
        keep = labels >= 0
        cm.update(preds[keep], labels[keep])
    return cm


def train_loop(args: TaskArgs) -> Dict:
    device = resolve_device(args.device or None)
    backbone(args.model)
    train_ds = build_dataset(args.dataset_name, args, "train")
    test_ds, eval_split = _eval_split(args, train_ds)
    in_channels = train_ds.points.shape[-1]
    num_classes = max(len(train_ds.classnames), int(train_ds.seg_labels.max()) + 1)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = build_model(args.model, num_classes, in_channels, dtype, args.seed).to(device)

    steps = max(args.epochs * max(len(train_ds.points) // args.batch_size, 1), 1)
    optim_name = (args.optim or "adamw").lower()
    if optim_name == "adahessian":
        raise ValueError("sceneseg's train step does not thread the Hessian diagonal; use "
                         "adamw/sgd/lamb/... (adahessian is supported by the cls/partseg/mpm/"
                         "dvae drivers)")
    betas = tuple(args.betas)
    if betas == (0.9, 0.98):  # TaskArgs' CLIP default -> the seg recipes' AdamW default
        betas = (0.9, 0.999)
    optimizer = build_optimizer(optim_name, model.named_parameters(),
                                cosine_with_warmup(args.lr, 0.0, 1, steps),
                                weight_decay=args.wd, betas=betas, eps=args.eps,
                                grad_norm_clip=args.grad_norm_clip)
    state = TrainState(model=model, optimizer=optimizer,
                       generator=torch.Generator(device=device).manual_seed(args.seed + 1))

    start_epoch, best_miou = 0, 0.0
    if args.resume:
        load_checkpoint(args.resume, state)
        start_epoch = state.step + 1
        best_miou = _resumed_best(args.resume)  # a worse epoch must not clobber the best
        log.info("resumed from %s at epoch %d (best mIoU %.2f)", args.resume, start_epoch,
                 best_miou)

    logger = ExperimentLogger(args, task_name="sceneseg")
    step_fn = make_seg_train_step(args.model, num_classes, args.label_smoothing)
    eval_fn = make_seg_eval_step(args.model, model, device)
    loader = Loader(train_ds, batch_size=args.batch_size, shuffle=True, drop_last=True,
                    seed=args.seed)
    miou_key = "miou" if eval_split == "val" else "train_miou"
    cm, history = None, []
    for epoch in range(start_epoch, args.epochs):
        loader.set_epoch(epoch)
        t0 = time.perf_counter()
        losses = [float(step_fn(state, split_batch(batch, device))["loss"]) for batch in loader]
        train_seconds = time.perf_counter() - t0  # each loss read waits for its step
        cm = crop_eval(eval_fn, test_ds, args, num_classes)
        miou = cm.miou
        if miou >= best_miou:
            best_miou = miou
            state.step = epoch
            save_checkpoint(logger.dir, state, meta={"epoch": epoch, miou_key: miou,
                                                     "oa": cm.overall_accuracy})
        record = {"epoch": epoch, "loss": float(np.mean(losses)), miou_key: miou,
                  "oa": cm.overall_accuracy, "eval_split": eval_split}
        logger.log(record, step=epoch)
        log.info("epoch %d loss %.4f %s %.2f OA %.2f", epoch, record["loss"], miou_key, miou,
                 cm.overall_accuracy)
        history.append({"epoch": epoch, "loss": record["loss"], "miou": miou,
                        "train_crops": len(losses) * args.batch_size,
                        "train_seconds": train_seconds})

    result = {"best_miou": best_miou, "history": history}
    if args.eval_scene:
        if os.path.exists(os.path.join(logger.dir, FILE)):  # the best checkpoint, not the last
            load_checkpoint(logger.dir, state)
        scenes = load_eval_scenes(args)
        t0 = time.perf_counter()
        cm = whole_scene_eval(eval_fn, scenes, npoints=args.npoints, num_classes=num_classes,
                              voxel_size=args.voxel_size, batch_size=max(1, args.batch_size),
                              num_votes=args.votes, max_passes=args.max_eval_passes,
                              seed=args.seed)
        result.update(scene_miou=cm.miou, scene_oa=cm.overall_accuracy,
                      scene_points=sum(len(s[0]) for s in scenes.scenes),
                      scene_eval_seconds=time.perf_counter() - t0)
        logger.log({"scene_miou": cm.miou, "scene_oa": cm.overall_accuracy})
        log.info("whole-scene eval: mIoU %.2f OA %.2f (%d scenes)", cm.miou,
                 cm.overall_accuracy, len(scenes))
        if args.cm_out:
            np.savez(args.cm_out, matrix=cm.matrix,
                     classnames=np.asarray(scenes.classnames, dtype=object))
    elif args.cm_out and cm is not None:
        log.warning("--cm_out without --eval_scene: writing the crop-eval confusion matrix")
        np.savez(args.cm_out, matrix=cm.matrix,
                 classnames=np.asarray(train_ds.classnames, dtype=object))
    elif args.cm_out:
        log.warning("--cm_out: no evaluation ran (no epochs, no --eval_scene): nothing written")
    logger.close()
    return result


def main(args: Optional[Union[TaskArgs, Sequence[str]]] = None) -> Dict:
    if not isinstance(args, TaskArgs):
        args = parse_args(args)
    logging.basicConfig(level=logging.INFO)
    args.task = "sceneseg"
    return train_loop(args)


if __name__ == "__main__":
    main(sys.argv[1:])
