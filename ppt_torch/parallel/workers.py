"""The jobs a spawned rank runs (``parallel/launch.py``), shared by the
tests, the dry run and ``chip_smoke.py``.

``run_jobs(rank, world, device, payload)`` runs ``payload["jobs"]`` in
order, each ``{"kind": ..., "name": ..., ...}`` on its own mesh, and
returns ``{name: result}``; every tensor in a result is on the CPU. A
model comes from ``model`` specs: PointBERT and text widths (the configs'
keyword arguments), the class names, and either a ``state_dict`` (the
tests carry the JAX package's weights in with ``convert.from_jax``) or a
``seed`` (``models.ulip.init_weights``, equal on every rank).

Kinds:
  - ``"step"``: one train step (``trainer.make_train_step``) on the mesh,
    tensor-parallel when the mesh has a 'model' axis; returns the global
    loss and accuracy, the updated trainable tensors whole, the running
    statistics, optionally the eval logits, and the launch counts;
  - ``"pretrain"``: one ULIP contrastive step (``make_pretrain_step``);
  - ``"selfsup"``: one step of a point tower's self-supervised stage,
    ``model["stage"]`` "dvae" (``make_dvae_step``), "mpm" (``make_mpm_step``
    against a frozen dVAE) or "mae" (``MaskedPointMAE`` in training mode,
    its noise from ``masking_noise``); weights from ``model["seed"]``;
    returns the global loss, the parameters before and after the step and
    the running statistics;
  - ``"pipeline"``: ``pipelined_trunk_features`` or
    ``pipelined_partseg_features`` (the point tower's weights from
    ``encoder_state`` when given) and the gradient of ``sum(features**2)``
    over the global batch;
  - ``"refusals"``: ``_run_pipelined``'s four refusals, their messages.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ppt_torch.kernels import _build


def _mesh(job: Dict):
    from ppt_torch.parallel.mesh import create_mesh

    spec = job.get("mesh")
    if spec is None:
        return None
    return create_mesh(axis_names=tuple(spec["axes"]), shape=tuple(spec["shape"]))


def build_ulip(spec: Dict, device):
    """(model, prompts) from a model spec (see the module docstring)."""
    from ppt_torch.models.ulip import PromptArrays, Ulip, init_weights
    from ppt_torch.nn.pointbert import PointBert, PointBertConfig, PointBertPartSeg
    from ppt_torch.nn.text import TextConfig
    from ppt_torch.prompt.learner import build_prompt_spec
    from ppt_torch.utils.device import resolve_dtype

    cfg = PointBertConfig(**spec.get("point", {}))
    dt = resolve_dtype(spec.get("dtype", "float32"))
    partseg = spec.get("task") == "partseg"
    encoder = (PointBertPartSeg if partseg else PointBert)(cfg, dtype=dt,
                                                           route=spec.get("route", "block"))
    model = Ulip(encoder, pc_feat_dims=128 if partseg else 2 * cfg.trans_dim,
                 n_ctx=spec["n_ctx"], text_config=TextConfig(**spec.get("text", {})), dtype=dt,
                 task="partseg" if partseg else "cls")
    if "state_dict" in spec:
        model.load_state_dict(spec["state_dict"])
    else:
        init_weights(model, spec.get("seed", 0))
    model.to(device).eval()
    prompts = PromptArrays.from_spec(
        build_prompt_spec(spec["classes"], n_ctx=spec["n_ctx"],
                          class_name_position=spec.get("class_name_position", "end")),
        device=device)
    return model, prompts


def _optimizer(job: Dict):
    from ppt_torch.train.optim import Sgd, build_optimizer

    lr = job.get("lr", 0.05)
    if job.get("optim", "sgd") == "sgd":  # optax.sgd(lr): no momentum, no decay
        return lambda tr: Sgd(tr.items(), lambda count: lr, momentum=0.0, nesterov=False)
    return lambda tr: build_optimizer(job["optim"], tr.items(), lambda count: lr,
                                      weight_decay=0.0)


def _mask(model, job: Dict) -> Dict[str, bool]:
    from ppt_torch.models.ulip import trainable_mask

    if "trainable" in job:
        prefixes = tuple(job["trainable"])
        return {n: n.startswith(prefixes) for n, _ in model.named_parameters()}
    return trainable_mask(model, head_type=job.get("head_type", 0),
                          task=job.get("task", "cls"))


@contextlib.contextmanager
def _head_dropout(on: bool):
    """With ``on`` False, part segmentation's head dropout as the identity
    (a comparison with another package's random stream runs both heads
    without it)."""
    from ppt_torch.nn import pointbert as npb

    keep = npb.dropout
    if not on:
        npb.dropout = lambda x, rate, train, generator: x
    try:
        yield
    finally:
        npb.dropout = keep


def _tensors(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        out[k] = (t.long() if not t.is_floating_point() else t.float()).to(device)
    return out


def _stats(model) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone() for k, v in model.named_buffers()
            if k.endswith(("running_mean", "running_var"))}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def step_job(job: Dict, device) -> Dict[str, Any]:
    from ppt_torch.parallel.mesh import axis_size, gather_rows, shard_batch
    from ppt_torch.parallel.sharding import shard_params, whole_params
    from ppt_torch.train.trainer import create_train_state, make_train_step

    model, prompts = build_ulip(job["model"], device)
    partseg = job["model"].get("task") == "partseg"
    mesh = _mesh(job)
    if axis_size(mesh, "model") > 1:
        shard_params(model, mesh)
    state = create_train_state(model, _mask(model, job), _optimizer(job), seed=job.get("seed", 1),
                               mesh=mesh)
    names = list(state.trainable)
    step = make_train_step(smoothing=job.get("smoothing", 0.2), partseg=partseg)
    batch = _tensors(job["batch"], device)
    local = shard_batch(batch, mesh) if axis_size(mesh, "data") > 1 else batch
    out: Dict[str, Any] = {}
    if job.get("logits"):
        with torch.no_grad():
            logits = model(local["pc"], prompts, train=False,
                           cls_onehot=local.get("cls_onehot") if partseg else None)
        if axis_size(mesh, "data") > 1:
            logits = gather_rows(logits, mesh)
        out["logits"] = logits.float().cpu()
    stats0 = _stats(model)
    with _head_dropout(job.get("dropout", True)):
        _sync(device)
        _build.reset_launches()
        state, metrics = step(state, local, prompts)
        _sync(device)
        out["launches"] = dict(_build.LAUNCHES)
    whole = whole_params(model)
    out.update(loss=float(metrics["loss"]), acc=float(metrics["acc"]),
               trainable={k: whole[k].float().cpu() for k in names}, stats=_stats(model),
               stats_before=stats0)
    return out


def pretrain_job(job: Dict, device) -> Dict[str, Any]:
    from ppt_torch.parallel.mesh import axis_size, shard_batch
    from ppt_torch.tasks.pretrain import make_pretrain_step
    from ppt_torch.train.trainer import create_train_state

    model, _ = build_ulip(job["model"], device)
    mesh = _mesh(job)
    state = create_train_state(model, _mask(model, {"task": "pretrain", **job}),
                               _optimizer(job), seed=job.get("seed", 1), mesh=mesh)
    names = list(state.trainable)
    step = make_pretrain_step(model, state.optimizer)
    batch = _tensors(job["batch"], device)
    if axis_size(mesh, "data") > 1:
        batch = shard_batch(batch, mesh)
    _build.reset_launches()
    state, metrics = step(state, {"pc": batch["pc"]}, batch["tokens"])
    _sync(device)
    return {"loss": float(metrics["loss"]), "pc_text_acc": float(metrics["pc_text_acc"]),
            "launches": dict(_build.LAUNCHES),
            "trainable": {k: state.trainable[k].detach().float().cpu() for k in names},
            "stats": _stats(model)}


def _selfsup_model(spec: Dict, device):
    """(model, frozen dVAE or None) of a ``"selfsup"`` job's model spec."""
    from ppt_torch.nn.dvae import DiscreteVAE, DvaeConfig, init_dvae
    from ppt_torch.nn.mae import MaeConfig, MaskedPointMAE, init_mae
    from ppt_torch.nn.mpm import PointBertMPM, init_mpm
    from ppt_torch.nn.pointbert import PointBertConfig

    seed = spec.get("seed", 0)
    if spec["stage"] == "dvae":
        return init_dvae(DiscreteVAE(DvaeConfig(**spec["dvae"])), seed).to(device), None
    if spec["stage"] == "mae":
        return init_mae(MaskedPointMAE(MaeConfig(**spec["mae"])), seed).to(device), None
    dvae = init_dvae(DiscreteVAE(DvaeConfig(**spec["dvae"])), seed + 10).to(device)
    student = PointBertMPM(PointBertConfig(**spec["point"]), num_tokens=spec["dvae"]["num_tokens"])
    return init_mpm(student, seed).to(device), dvae.requires_grad_(False)


def selfsup_job(job: Dict, device) -> Dict[str, Any]:
    from ppt_torch.nn.mae import masking_noise
    from ppt_torch.parallel.collectives import data_parallel, global_mean
    from ppt_torch.parallel.mesh import axis_group, axis_size, shard_batch
    from ppt_torch.tasks.dvae_pretrain import make_dvae_step
    from ppt_torch.tasks.mpm_pretrain import make_mpm_step
    from ppt_torch.train.trainer import apply_gradients, create_train_state

    spec = job["model"]
    model, dvae = _selfsup_model(spec, device)
    mesh = _mesh(job)
    state = create_train_state(model, {n: True for n, _ in model.named_parameters()},
                               _optimizer(job), seed=job.get("seed", 1), mesh=mesh)
    start = {k: v.detach().float().cpu().clone() for k, v in state.trainable.items()}
    pc = _tensors(job["batch"], device)["pc"]
    if axis_size(mesh, "data") > 1:
        pc = shard_batch(pc, mesh)
    _build.reset_launches()
    if spec["stage"] == "dvae":
        step = make_dvae_step(model, state.optimizer)
        state, metrics = step(state, {"pc": pc}, job.get("temperature", 1.0))
    elif spec["stage"] == "mpm":
        cfg = spec["point"]
        step = make_mpm_step(model, dvae, state.optimizer, spec.get("mask_ratio", 0.4),
                             cfg["num_group"], cfg["group_size"])
        state, metrics = step(state, {"pc": pc})
    else:  # the MAE has no step factory: its training forward, as one would step it
        data = axis_group(mesh, "data")
        with data_parallel(data):
            noise = masking_noise(state.generator, pc.shape[0], model.config.num_group)
            loss, _ = model(pc, noise, train=True)
        apply_gradients(state.optimizer, loss, state.generator)
        metrics = {"loss": global_mean(loss.detach(), data)}
    _sync(device)
    return {"loss": float(metrics["loss"]), "launches": dict(_build.LAUNCHES),
            "trainable": {k: v.detach().float().cpu() for k, v in state.trainable.items()},
            "start": start, "stats": _stats(model)}


def pipeline_job(job: Dict, device) -> Dict[str, Any]:
    from ppt_torch.parallel.collectives import reduce_gradients
    from ppt_torch.parallel.mesh import axis_size, gather_rows, shard_batch
    from ppt_torch.parallel.pipeline import grad as pipeline_grad
    from ppt_torch.parallel.pipeline import (pipelined_partseg_features,
                                             pipelined_trunk_features)

    model, _ = build_ulip(job["model"], device)
    encoder = model.point_encoder
    if "encoder_state" in job:
        encoder.load_state_dict(job["encoder_state"])
    mesh = _mesh(job)
    dp_axis = job.get("dp_axis", "data")
    batch = _tensors(job["batch"], device)
    if dp_axis and axis_size(mesh, dp_axis) > 1:
        batch = shard_batch(batch, mesh, dp_axis)
    params = dict(encoder.named_parameters())
    with torch.enable_grad() if job.get("grads", True) else torch.no_grad():
        _sync(device)
        _build.reset_launches()
        if job["model"].get("task") == "partseg":
            feats = pipelined_partseg_features(encoder, batch["pc"], batch["cls_onehot"], mesh,
                                               n_micro=job.get("n_micro"), dp_axis=dp_axis)
        else:
            feats = pipelined_trunk_features(encoder, batch["pc"], mesh,
                                             n_micro=job.get("n_micro"), dp_axis=dp_axis)
        out: Dict[str, Any] = {}
        if job.get("grads", True):
            grads = dict(zip(params, pipeline_grad((feats.float() ** 2).sum(),
                                                   list(params.values()))))
            # the gradient of the global sum: the pipe ranks' partial sums
            # over every rank, divided by the pipe size
            pp = axis_size(mesh, job.get("pp_axis", "pipe"))
            grads = reduce_gradients(grads, pp, {})
            out["grads"] = {k: grads[k].float().cpu() for k in job.get("grad_names", grads)}
        _sync(device)
        out["launches"] = dict(_build.LAUNCHES)
    if dp_axis and axis_size(mesh, dp_axis) > 1:
        feats = gather_rows(feats.detach(), mesh, dp_axis)
    out["features"] = feats.detach().float().cpu()
    return out


def refusals_job(job: Dict, device) -> List[str]:
    """``_run_pipelined``'s four refusals on a (data, pipe) mesh, as the
    reference's ``test_validation_errors`` provokes them."""
    from ppt_torch.nn.pointbert import PointBert, PointBertConfig
    from ppt_torch.parallel.pipeline import pipelined_trunk_features

    mesh = _mesh(job)
    cfg = dict(job["model"]["point"])
    good = PointBert(PointBertConfig(**cfg)).to(device).eval()
    bad = PointBert(PointBertConfig(**{**cfg, "depth": job["bad_depth"]})).to(device).eval()
    pts = torch.as_tensor(np.asarray(job["batch"]["pc"])).to(device)
    calls = [
        lambda: pipelined_trunk_features(bad, pts, mesh, dp_axis=None),
        lambda: pipelined_trunk_features(good, pts, mesh, dp_axis=None, n_micro=3),
        lambda: pipelined_trunk_features(good, pts, mesh, pp_axis="pp"),
        lambda: pipelined_trunk_features(good, pts, mesh, dp_axis="dp"),
    ]
    messages = []
    with torch.no_grad():
        for call in calls:
            try:
                call()
                messages.append("")
            except ValueError as e:
                messages.append(str(e))
    return messages


JOBS = {"step": step_job, "pretrain": pretrain_job, "selfsup": selfsup_job,
        "pipeline": pipeline_job, "refusals": refusals_job}


def run_jobs(rank: int, world: int, device, payload: Dict) -> Dict[str, Any]:
    """Every job of ``payload["jobs"]`` in order, by name."""
    return {job["name"]: JOBS[job["kind"]](job, device) for job in payload["jobs"]}


def loader_job(rank: int, world: int, device, payload: Optional[Dict] = None) -> Dict[str, Any]:
    """The reference's two-process bring-up (``tests/test_multihost.py``):
    ``init_multihost`` from the environment, the loader's default striding
    over the group, the labels gathered, a reduced "loss" (the labels' sum)."""
    import types

    import torch.distributed as dist

    from ppt_torch.data.datasets import ArrayDataset
    from ppt_torch.data.loader import Loader
    from ppt_torch.parallel.collectives import all_gather_cat, all_reduce_
    from ppt_torch.parallel.mesh import init_multihost

    args = types.SimpleNamespace(device="cpu")
    distributed = init_multihost(args)
    pts = np.arange(8, dtype=np.float32).reshape(8, 1, 1).repeat(4, 1)
    ds = ArrayDataset(points=pts, labels=np.arange(8, dtype=np.int32), classnames=["a"],
                      name="toy")
    batch = next(iter(Loader(ds, batch_size=4, shuffle=False, drop_last=True)))
    local = torch.as_tensor(batch["label"].astype(np.int64))
    with torch.no_grad():
        global_labels = all_gather_cat(local, dist.group.WORLD)
    loss = all_reduce_(local.float().sum(), dist.group.WORLD)
    return {"rank": args.rank, "world": args.world_size, "distributed": distributed,
            "local": sorted(int(x) for x in local), "global": global_labels.tolist(),
            "loss": float(loss)}


def task_job(rank: int, world: int, device, payload: Dict) -> Dict[str, Any]:
    """A task driver's ``main`` on this rank (``payload["task"]``: "cls",
    "partseg" or "pretrain"), its ``TaskArgs`` from ``payload["args"]``
    and, where given, the shrunk ``pointbert_config`` / ``text_config``
    (keyword arguments); the group comes up inside ``main`` from the
    environment. Returns the driver's per-epoch history."""
    import importlib

    from ppt_torch.nn.pointbert import PointBertConfig
    from ppt_torch.nn.text import TextConfig
    from ppt_torch.tasks.args import TaskArgs

    args = TaskArgs(**payload["args"])
    if "point" in payload:
        args.pointbert_config = PointBertConfig(**payload["point"])
    if "text" in payload:
        args.text_config = TextConfig(**payload["text"])
    for k, v in payload.get("extra", {}).items():
        setattr(args, k, v)
    result = importlib.import_module(f"ppt_torch.tasks.{payload['task']}").main(args)
    return {"rank": args.rank, "world": args.world_size, "history": result["history"]}
