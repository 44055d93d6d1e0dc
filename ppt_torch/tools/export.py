"""Serving export: the trained recognizer as a ``torch.export`` program.

Counterpart of ``ppt_tpu/tools/export.py``. The eval forward ``pc ->
logits`` is exported once with ``torch.export.export`` (eval mode, DropPath
off, under ``torch.no_grad()``) and saved with ``torch.export.save``; a
serving process loads it with ``torch.export.load`` and needs no model code,
tokenizer or text tower, only ``import ppt_torch.kernels``, which registers
the ``torch.ops.ppt.*`` operators the graph calls (``kernels/_ops.py``).

What the program computes:
  - the point tower's eval forward (running BatchNorm statistics),
    ``pc_projection``, and the logit scale read inside the graph from the
    shipped ``logit_scale`` leaf as ``exp(min(leaf, ln 100))``;
  - the text side as a constant: ``encode_text`` runs once at export time
    and its ``[C, E]`` output is a buffer of the graph, tied to the exporting
    checkpoint's prompt.
On the card the graph calls the hand-written kernels as operators, none of
them decomposed: ``ppt.fps_batched``, ``ppt.knn_gather``,
``ppt.mini_forward``, ``ppt.fused_vit_block`` (depth - 1 times) and
``ppt.fused_vit_block_readout``.

Artifact layout (``--out DIR``):
  serve_logits.pt2   the ExportedProgram; with ``--bake-weights`` it holds
                     the weights and takes ``pc`` alone, else it takes
                     ``(weights, pc)``: the serving leaves by the port's
                     names, then the clouds
  weights.msgpack    the serving leaves (absent when baked) under the flax
                     leaf names of ``ppt_tpu``'s file, written by the port's
                     own msgpack writer; the point tower's parameters and
                     batch statistics, ``pc_projection`` and ``logit_scale``
  meta.json          input and output specs, the ``ppt`` operators the graph
                     calls, whether the weights are baked, the text
                     embedding's provenance, ``artifact_bytes``, git rev

``load_exported(path, weights=...)`` returns the loaded program as a
callable ``pc -> logits``; an unbaked program takes its weights from the
given ``weights.msgpack`` (or dict), by default the one beside it.

Usage:
  python -m ppt_torch.tools.export --out outputs/export_cls \\
      --ckpt outputs/cls --pretrained_dir data/pretrained_models --head_type 0
  python -m ppt_torch.tools.export --out /tmp/e --tiny --device cpu --batch 4 --npoints 128
  python -m ppt_torch.tools.export --out build/e --bake-weights --measure 50   # on the card
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import sys
import time
from typing import Callable, Dict, Tuple, Union

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch import nn

import ppt_torch.kernels  # noqa: F401  (registers the torch.ops.ppt operators)
import ppt_torch.utils.msgpack as flax_msgpack
from ppt_torch.convert import port_leaves
from ppt_torch.models.ulip import PromptArrays, Ulip, build_model
from ppt_torch.nn.pointbert import PointBertConfig
from ppt_torch.nn.text import TextConfig
from ppt_torch.prompt.learner import build_prompt_spec
from ppt_torch.tasks.args import TaskArgs
from ppt_torch.utils.device import resolve_device
from ppt_torch.utils.logging_utils import _git_rev

ARTIFACT, WEIGHTS, META = "serve_logits.pt2", "weights.msgpack", "meta.json"
KEEP = ("point_encoder", "pc_projection", "logit_scale")  # what the graph reads
LOGIT_SCALE_MAX = math.log(100.0)  # the reference clamps exp(logit_scale) at 100
_STATS = {"running_mean": "mean", "running_var": "var"}


def flagship_args(tiny: bool, device: torch.device, head_type: int = 0,
                  pretrained_dir: str = "", ulip2: bool = False) -> TaskArgs:
    """PPT-Base's arguments: ULIP_PointBERT, 32 prompt tokens "middle", in
    bf16 on the card and f32 on the CPU (the JAX tool's rule on its chip).
    ``tiny`` shrinks both towers to the tests' widths (``ppt_tpu``'s
    ``_flagship(tiny=True)``: PointBERT 48 wide, 2 blocks, 16 groups of 8;
    the text tower 64 wide, 2 layers; 4 prompt tokens)."""
    args = TaskArgs(model="ULIP_PointBERT", num_learnable_prompt_tokens=4 if tiny else 32,
                    class_name_position="middle", head_type=head_type, seed=0,
                    compute_dtype="bfloat16" if device.type == "cuda" else "float32",
                    pretrained_dir=pretrained_dir, ulip2=ulip2, device=str(device))
    if tiny:
        args.pointbert_config = PointBertConfig(trans_dim=48, depth=2, num_heads=4,
                                                group_size=8, num_group=16, encoder_dims=32,
                                                drop_path_rate=0.0)
        args.text_config = TextConfig(width=64, layers=2, heads=4, embed_dim=64)
    return args


def flagship(args: TaskArgs, device: torch.device) -> Tuple[Ulip, PromptArrays]:
    """The model (eval mode, weights from ``args.seed``) and ModelNet40's 40
    class prompts."""
    labels = TaskArgs(dataset_name="modelnet40").load_classnames()
    spec = build_prompt_spec(labels, n_ctx=args.num_learnable_prompt_tokens,
                             class_name_position="middle")
    model = build_model("ULIP_PointBERT", args, device=device).model
    return model, PromptArrays.from_spec(spec, device=device)


def serving_variables(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The leaves the serving graph reads, by the port's names: the point
    tower's parameters and BatchNorm statistics, ``pc_projection`` and
    ``logit_scale``. The parameters and the statistics are pruned to the
    same keep-set; the text tower and the prompt are baked into the graph
    as one constant, so shipping them would be dead payload."""
    return {k: v.detach() for k, v in model.state_dict().items() if k.split(".")[0] in KEEP}


class ServingModel(nn.Module):
    """``pc [B, N, 3] -> logits [B, C]``: the eval forward with the text
    embedding ``[C, E]`` as a constant buffer and the logit scale read from
    the ``logit_scale`` leaf in the graph, clamped at ln(100). Its products
    are ``train/eval.py``'s eval step's, in the same order."""

    def __init__(self, model: Ulip, text_embed: torch.Tensor):
        super().__init__()
        self.point_encoder = model.point_encoder
        self.pc_projection = model.pc_projection
        self.logit_scale = model.logit_scale
        self.register_buffer("text_embed", text_embed)

    def forward(self, pc: torch.Tensor) -> torch.Tensor:
        pc_embed = self.point_encoder(pc, train=False).float() @ self.pc_projection
        scale = torch.exp(torch.clamp_max(self.logit_scale, LOGIT_SCALE_MAX))
        return scale * pc_embed @ self.text_embed.t()


class _WeightsAsInput(nn.Module):
    """The unbaked program: ``(weights, pc) -> logits``, the serving leaves
    swapped into ``serving`` by name. ``serving`` is held outside the module
    tree, so its own leaves are not exported; the text embedding is."""

    def __init__(self, serving: ServingModel):
        super().__init__()
        self.register_buffer("text_embed", serving.text_embed)
        object.__setattr__(self, "_serving", serving)

    def forward(self, weights: Dict[str, torch.Tensor], pc: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(self._serving, {**weights, "text_embed": self.text_embed},
                                          (pc,))


@torch.no_grad()
def build_serving_fn(model: Ulip, prompts: PromptArrays) -> ServingModel:
    """The serving module: ``encode_text`` run once, in eval mode."""
    model.eval()
    return ServingModel(model, model.encode_text(prompts).float())


def export_serving(model: Ulip, prompts: PromptArrays, *, batch: int, npoints: int,
                   bake_weights: bool = False, sym_batch: bool = False):
    """``torch.export.export`` of the serving forward at ``[batch, npoints,
    3]`` f32 clouds on the model's device; ``sym_batch`` exports a symbolic
    batch (``torch.export.Dim("b")``), else the batch is static."""
    serving = build_serving_fn(model, prompts)
    dev = serving.text_embed.device
    gen = torch.Generator().manual_seed(0)
    pc = torch.rand(batch, npoints, 3, generator=gen).to(dev)
    pc_dims = {0: torch.export.Dim("b")} if sym_batch else None
    with torch.no_grad():
        if bake_weights:
            exported = torch.export.export(serving, (pc,), dynamic_shapes=(pc_dims,))
        else:
            weights = serving_variables(model)
            exported = torch.export.export(_WeightsAsInput(serving), (weights, pc),
                                           dynamic_shapes=({k: None for k in weights}, pc_dims))
    exported.example_inputs = None  # the artifact carries no example weights or clouds
    return exported


def save_exported(exported, path: str) -> None:
    torch.export.save(exported, path)


def ppt_ops(exported) -> Dict[str, int]:
    """How many times the program's graph calls each ``ppt`` operator."""
    calls = collections.Counter(
        node.target.name().split("::", 1)[1].split(".", 1)[0]
        for node in exported.graph.nodes
        if node.op == "call_function" and isinstance(node.target, torch._ops.OpOverload)
        and node.target.namespace == "ppt")
    return dict(sorted(calls.items()))


def flax_tree(leaves: Dict[str, torch.Tensor]) -> Dict:
    """``{"params": ..., "batch_stats": ...}`` under the flax leaf names:
    the inverse of ``convert.port_leaves`` on the serving leaves (a
    BatchNorm or LayerNorm ``weight`` is flax's ``scale``, the running
    statistics are ``batch_stats`` ``mean``/``var``)."""
    tree: Dict = {"params": {}, "batch_stats": {}}
    for key, t in leaves.items():
        *mods, leaf = key.split(".")
        stats = leaf in _STATS
        node = tree["batch_stats" if stats else "params"]
        for m in mods:
            node = node.setdefault(m, {})
        t = t.detach().cpu()
        node[_STATS[leaf] if stats else "scale" if leaf == "weight" else leaf] = (
            t if t.dtype == torch.bfloat16 else t.numpy())
    tree = {k: v for k, v in tree.items() if v}
    back = [key for c, stats in (("params", False), ("batch_stats", True))
            for _, key, _ in port_leaves(tree.get(c, {}), stats)]
    if sorted(back) != sorted(leaves):
        raise ValueError("flax_tree: the flax names do not map back to "
                         f"{sorted(set(leaves) - set(back))[:4]}")
    return tree


def read_weights(path: str) -> Dict[str, torch.Tensor]:
    """A ``weights.msgpack`` (the port's or ``ppt_tpu``'s) as tensors by the
    port's names."""
    with open(path, "rb") as f:
        tree = flax_msgpack.msgpack_restore(f.read())
    out = {}
    for collection, stats in (("params", False), ("batch_stats", True)):
        for _, key, arr in port_leaves(tree.get(collection, {}), stats):
            out[key] = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.array(arr))
    return out


def load_exported(path: str,
                  weights: Union[None, str, Dict[str, torch.Tensor]] = None) -> Callable:
    """The program at ``path`` (the ``.pt2`` file or its directory) as a
    callable ``pc -> logits``, with ``.program`` (the ExportedProgram) and
    ``.weights`` (the leaves an unbaked program is given, else None). An
    unbaked program takes ``weights``: a ``weights.msgpack`` path or a dict
    by the port's names, by default the file beside the program; they are
    moved to where the program's text embedding lies."""
    if os.path.isdir(path):
        path = os.path.join(path, ARTIFACT)
    program = torch.export.load(path)
    module = program.module().requires_grad_(False)  # serving: autograd records nothing
    if len(program.graph_signature.user_inputs) == 1:  # baked: the clouds alone
        call = module
        call.program, call.weights = program, None
        return call
    if weights is None:
        weights = os.path.join(os.path.dirname(path), WEIGHTS)
    if isinstance(weights, str):
        weights = read_weights(weights)
    device = program.state_dict["text_embed"].device
    # the program flattens its weights in the order it was exported with
    spec = program.call_spec.in_spec
    (names, _), _ = pytree.tree_unflatten(list(range(spec.num_leaves)), spec)
    missing = sorted(set(names) - set(weights))
    if missing:
        raise KeyError(f"load_exported: the weights lack {len(missing)} serving leaves, "
                       f"{missing[:4]}...")
    leaves = {k: weights[k].to(device) for k in names}

    def call(pc: torch.Tensor) -> torch.Tensor:
        return module(leaves, pc)

    call.program, call.weights = program, leaves
    return call


def restore_ckpt(args: TaskArgs, model: Ulip, ckpt: str) -> None:
    """The trained partition (``args.head_type``'s) and batch statistics of
    the port's ``checkpoint_best.pt`` (a file or its directory) into
    ``model`` in place, as ``tasks/feature_extract.py`` restores them."""
    from ppt_torch.tasks import cls
    from ppt_torch.train.checkpoint import load_checkpoint

    state, _ = cls.train_state(args, model, 1)
    load_checkpoint(ckpt, state)


def measure(call: Callable, batch: int, npoints: int, reps: int, device: torch.device) -> dict:
    """The latency of ``reps`` calls on one seeded batch, each closed by a
    synchronize on the card; the first call (warm-up) gives the logit-sum
    probe."""
    pc = torch.from_numpy(np.random.RandomState(1).rand(batch, npoints, 3).astype(np.float32))
    pc = pc.to(device)

    def run():
        out = call(pc)
        if device.type == "cuda":
            torch.cuda.synchronize()
        return out

    warm = float(run().sum())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    med = sorted(times)[len(times) // 2]
    return {"surface": "exported_serving_latency", "device": str(device),
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "batch": batch, "npoints": npoints, "median_latency_ms": med * 1e3,
            "clouds_per_sec": batch / med, "spread_pct": 100 * (max(times) - min(times)) / med,
            "reps": reps, "logit_sum_probe": warm}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--ckpt", default="", help="the port's checkpoint_best.pt (or its directory)")
    ap.add_argument("--head_type", type=int, default=0)
    ap.add_argument("--pretrained_dir", default="",
                    help="directory of converted backbone msgpacks (tools/ckpt_convert). Needed "
                         "for a faithful artifact from a training checkpoint: checkpoints hold "
                         "only the trainable partition, so the frozen towers load here as the "
                         "training run loaded them")
    ap.add_argument("--ulip2", action="store_true", help="the ULIP-2 PointBERT file")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--npoints", type=int, default=1024)
    ap.add_argument("--bake-weights", action="store_true",
                    help="the program holds the weights and takes the clouds alone")
    ap.add_argument("--sym-batch", action="store_true", help="a symbolic batch dimension")
    ap.add_argument("--tiny", action="store_true", help="the tests' tiny model (same code path)")
    ap.add_argument("--measure", type=int, default=0, metavar="N",
                    help="after exporting, load the artifact back and time N serving calls "
                         "(weights resident on the device, each call closed by a synchronize); "
                         "prints a latency JSON line")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the plain path")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    targs = flagship_args(args.tiny, dev, args.head_type, args.pretrained_dir, args.ulip2)
    model, prompts = flagship(targs, dev)
    if args.pretrained_dir:
        # the frozen towers first, as the training run loaded them: checkpoints
        # carry only the trainable partition
        from ppt_torch.train.checkpoint import load_pretrained_backbones

        load_pretrained_backbones(targs, model)
    elif args.ckpt:
        print("WARNING: --ckpt without --pretrained_dir: the frozen towers stay at their "
              "seeded init, the artifact will NOT reproduce the trained model (checkpoints "
              "persist only the trainable partition)", file=sys.stderr)
    if args.ckpt:
        restore_ckpt(targs, model, args.ckpt)

    exported = export_serving(model, prompts, batch=args.batch, npoints=args.npoints,
                              bake_weights=args.bake_weights, sym_batch=args.sym_batch)
    os.makedirs(args.out, exist_ok=True)
    art = os.path.join(args.out, ARTIFACT)
    save_exported(exported, art)
    leaves = serving_variables(model)
    if not args.bake_weights:
        with open(os.path.join(args.out, WEIGHTS), "wb") as f:
            f.write(flax_msgpack.msgpack_serialize(flax_tree(leaves)))
    b = "b" if args.sym_batch else args.batch
    meta = {
        "input": ([f"weights: {len(leaves)} tensors by the port's names ({WEIGHTS}, flax "
                   "names)"] if not args.bake_weights else [])
        + [f"pc [{b}, {args.npoints}, 3] f32"],
        "output": f"logits [{b}, {prompts.perm_tokens.shape[0]}] f32 "
                  "(exp(min(logit_scale, ln 100)) * pc_embed @ text_embed.T)",
        "n_classes": int(prompts.perm_tokens.shape[0]),
        "text_embed": "a constant of the graph, encode_text of the exporting checkpoint's "
                      "prompt; new weights do not change it",
        "ppt_ops": ppt_ops(exported),
        "device": str(dev),
        "compute_dtype": targs.compute_dtype,
        "baked_weights": bool(args.bake_weights),
        "sym_batch": bool(args.sym_batch),
        "artifact_bytes": os.path.getsize(art),
        "git_rev": _git_rev(),
    }
    with open(os.path.join(args.out, META), "w") as f:
        json.dump(meta, f, indent=2)
    print(json.dumps({"out": args.out, **meta}))
    if args.measure:
        line = measure(load_exported(art), args.batch, args.npoints, args.measure, dev)
        print(json.dumps(line))
        meta["latency"] = line
    return meta


if __name__ == "__main__":
    main()
