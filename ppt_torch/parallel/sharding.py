"""Parameter sharding rules and tensor-parallel execution over a 'model'
mesh axis.

Counterpart of ``ppt_tpu/parallel/sharding.py``, with the same rule
tables, matched on path components (a rename of an unrelated module cannot
silently change the layout):

  - attention QKV / ViT qkv kernels: output (head) dim sharded -> each
    model rank computes its heads; the out/proj kernel shards its input
    dim, and one all-reduce follows the projection;
  - MLP fc1/c_fc kernels: hidden dim sharded; fc2/c_proj input dim
    sharded -> one all-reduce per block;
  - token embedding: feature dim sharded, all-gathered after the lookup.

Everything else (norms, biases, prompt tokens, projections) replicates.
``ulip_param_spec`` takes the reference's flax paths and returns
``Shard(1)`` / ``Shard(0)`` / ``Replicate()`` where JAX has
``P(None, "model")`` / ``P("model", None)`` / ``P()``; ``param_spec``
takes a port parameter name (flax's names, ``convert.from_jax``; a
``weight`` is an embedding's ``embedding`` or a norm's ``scale``).

GSPMD executes the reference's layout by itself; here the execution is
Megatron-style and written out. ``shard_params`` keeps each rank's shard
of a sharded matrix as the parameter itself, and the blocks the rules
shard run on their shards: column-parallel products on the local columns
(a replicated bias sliced to them), attention over the rank's ``heads /
tp`` heads (``fused_mha`` or ``flash_mha`` on the card), row-parallel
products on the local rows, their f32 partial sums all-reduced
(differentiably) before the bias. A fused 3-way kernel (``qkv``,
``in_proj``) is sharded per part, so that each rank holds the same heads of
q, k and v. The fused block, tower and text kernels take whole weights, so
under a model axis above 1 PointBERT's blocks take the "unfused" route and
the text tower its "off" route, by name.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import Replicate, Shard

from ppt_torch.parallel import collectives as C

# Exact module-name rules (matched on path COMPONENTS, not substrings).
# Column-parallel shards the output dim; its paired row-parallel module
# shards the input dim so one all-reduce follows per block.
_COLUMN_PARALLEL = {
    "in_proj": None,  # CLIP text attention fused qkv (any parent)
    "qkv": "attn",  # ViT attention, only under an attn module
    "c_fc": None,  # CLIP MLP up-projection
    "fc1": "mlp",  # ViT MLP up-projection, only inside mlp blocks
}
_ROW_PARALLEL = {
    "out_proj": None,
    "proj": "attn",  # ViT attention output proj only (NOT pc/text proj)
    "c_proj": None,
    "fc2": "mlp",
}
_FUSED3 = ("qkv", "in_proj")  # [in, 3 * width] kernels: q, k, v side by side


def _matches(rules: Dict[str, Any], module: str, parent: str) -> bool:
    want_parent = rules.get(module, "missing")
    if want_parent == "missing":
        return False
    return want_parent is None or parent == want_parent


def ulip_param_spec(path: Tuple[str, ...], leaf):
    """Placement of one parameter leaf on the 'model' axis, by its flax path
    (``Shard(1)``: column-parallel; ``Shard(0)``: row-parallel)."""
    name = path[-1]
    if name == "embedding" and leaf.ndim == 2:
        return Shard(1)  # token embedding: feature dim sharded
    if name != "kernel" or leaf.ndim != 2:
        return Replicate()  # biases, norms, scalars, prompt tokens: replicated
    module = path[-2] if len(path) >= 2 else ""
    parent = path[-3] if len(path) >= 3 else ""
    if _matches(_COLUMN_PARALLEL, module, parent):
        return Shard(1)
    if _matches(_ROW_PARALLEL, module, parent):
        return Shard(0)
    return Replicate()


def flax_path(name: str, embedding: bool = False) -> Tuple[str, ...]:
    """The flax path of a port parameter name: a ``weight`` is an
    embedding's ``embedding`` (``embedding=True``) or a norm's ``scale``."""
    path = tuple(name.split("."))
    if path[-1] == "weight":
        path = path[:-1] + ("embedding" if embedding else "scale",)
    return path


def param_spec(name: str, leaf, embedding: bool = False):
    """``ulip_param_spec`` of a port parameter, by its name."""
    return ulip_param_spec(flax_path(name, embedding), leaf)


def _embedding_names(model: nn.Module):
    return {f"{m}.weight" if m else "weight" for m, mod in model.named_modules()
            if isinstance(mod, nn.Embedding)}


def model_specs(model: nn.Module) -> Dict[str, Any]:
    """Every parameter's placement, by name."""
    emb = _embedding_names(model)
    return {name: param_spec(name, p, name in emb) for name, p in model.named_parameters()}


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """The 'model' axis of a mesh: its group, this rank's index, its size."""

    group: Any
    rank: int
    size: int

    def split(self, n: int, what: str) -> int:
        if n % self.size:
            raise ValueError(f"tensor parallelism: {what} ({n}) is not divisible by the "
                             f"'model' axis of {self.size} ranks")
        return n // self.size


def _local(p: torch.Tensor, placement, fused3: bool, tp: TensorParallel) -> torch.Tensor:
    """This rank's shard of a whole parameter."""
    dim = placement.dim
    if fused3:  # [in, 3 * width]: each part sharded alike
        cols = p.shape[1] // 3
        return p.reshape(p.shape[0], 3, tp.size, tp.split(cols, "width"))[:, :, tp.rank] \
            .reshape(p.shape[0], -1)
    n = tp.split(p.shape[dim], "a sharded dimension")
    return p.narrow(dim, tp.rank * n, n)


def _whole(local: torch.Tensor, placement, fused3: bool, tp: TensorParallel) -> torch.Tensor:
    """The whole parameter from every rank's shard (outside autograd)."""
    parts = [torch.empty_like(local) for _ in range(tp.size)]
    src = local.detach().contiguous()
    if C.via_host(src, tp.group):
        host = [torch.empty_like(src, device="cpu") for _ in parts]
        torch.distributed.all_gather(host, src.cpu(), group=tp.group)
        parts = [h.to(src.device) for h in host]
    else:
        torch.distributed.all_gather(parts, src, group=tp.group)
    if fused3:
        rows = local.shape[0]
        return torch.stack([q.reshape(rows, 3, -1) for q in parts], dim=2).reshape(rows, -1)
    return torch.cat(parts, dim=placement.dim)


def shard_params(model: nn.Module, mesh, axis: str = "model") -> Dict[str, Any]:
    """Keep each rank's shard of every parameter the rules shard over
    ``mesh``'s ``axis``, in place, and hand the axis to the module that
    owns each sharded matrix (an attention, an MLP, a text block, the text
    tower for its embedding), which then runs on its shards. Build the
    train state after this: the optimizer's moments then take the shards'
    shapes, and the tensors it reads whole (the global norm, the trust
    ratios) are summed over the axis. Returns the placements by name (also
    ``model.tp_placements``). A mesh without ``axis``, or of size 1 on it,
    leaves the model as it is."""
    from ppt_torch.parallel.mesh import axis_group, axis_size

    specs = model_specs(model)
    if axis_size(mesh, axis) == 1:
        return specs
    tp = TensorParallel(axis_group(mesh, axis), mesh.get_local_rank(axis),
                        axis_size(mesh, axis))
    modules = dict(model.named_modules())
    with torch.no_grad():
        for name, p in model.named_parameters():
            placement = specs[name]
            if not isinstance(placement, Shard):
                continue
            path = name.split(".")
            p.data = _local(p.data, placement, path[-2] in _FUSED3, tp).contiguous().clone()
            owner = modules[".".join(path[:-2])]
            heads = getattr(owner, "heads", None) or getattr(owner, "num_heads", None)
            if heads is not None:
                tp.split(heads, "heads")
            owner.tp = tp
    model.tp = tp
    model.tp_placements = specs
    return specs


def shard_groups(model: nn.Module) -> Dict[str, Any]:
    """The 'model' group of each sharded parameter, by name (what the
    optimizer sums a whole-leaf norm over)."""
    tp: Optional[TensorParallel] = getattr(model, "tp", None)
    if tp is None:
        return {}
    return {name: tp.group for name, spec in model.tp_placements.items()
            if isinstance(spec, Shard)}


def whole_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter whole on every rank, the shards gathered (for
    checkpoints and comparisons; outside autograd)."""
    tp: Optional[TensorParallel] = getattr(model, "tp", None)
    out = {}
    for name, p in model.named_parameters():
        spec = getattr(model, "tp_placements", {}).get(name)
        if tp is not None and isinstance(spec, Shard):
            out[name] = _whole(p, spec, name.split(".")[-2] in _FUSED3, tp)
        else:
            out[name] = p.detach()
    return out


# ---------------------------------------------------------------------------
# Megatron-style products on the shards
# ---------------------------------------------------------------------------


def column_bias(bias: Optional[torch.Tensor], tp: TensorParallel,
                fused3: bool = False) -> Optional[torch.Tensor]:
    """This rank's columns of a replicated column-parallel bias."""
    if bias is None:
        return None
    if fused3:
        return bias.reshape(3, tp.size, -1)[:, tp.rank].reshape(-1)
    return bias.reshape(tp.size, -1)[tp.rank]


def column_parallel(x: torch.Tensor, dense, tp: TensorParallel, fused3: bool = False):
    """``dense`` (a ``layers.Dense`` holding its column shard) on ``x``: the
    local columns, rounded as the Dense rounds."""
    dt = dense.dtype
    y = x.to(dt) @ dense.kernel.to(dt)
    b = column_bias(dense.bias, tp, fused3)
    return y if b is None else y + b.to(dt)


def row_parallel(x: torch.Tensor, dense, tp: TensorParallel) -> torch.Tensor:
    """``dense`` (holding its row shard) on the local features ``x``: the
    f32 partial product all-reduced over the axis, rounded once to the
    compute dtype, then the bias."""
    dt = dense.dtype
    y = C.all_reduce_sum(x.to(dt).float() @ dense.kernel.to(dt).float(), tp.group).to(dt)
    return y if dense.bias is None else y + dense.bias.to(dt)


def gather_features(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """A feature-sharded activation made whole (the token embedding's
    lookup), differentiably."""
    return C.all_gather_cat(x, tp.group, dim=-1)
