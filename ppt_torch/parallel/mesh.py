"""Process bring-up, the device mesh, and batch placement.

Counterpart of ``ppt_tpu/parallel/mesh.py`` over ``torch.distributed``.
The reference runs one controller over a ``jax.sharding.Mesh`` and lets
GSPMD place every collective; here each rank is a process, the mesh is a
``DeviceMesh`` whose named dimensions give the process groups, and the
collectives are written out (``parallel/collectives.py``).

The reference's rank plumbing maps as:
  jax.distributed.initialize        -> init_process_group (init_multihost)
  jax.process_index()/count()       -> dist.get_rank()/get_world_size()
  NamedSharding(mesh, P("data"))    -> shard_batch: this rank's contiguous rows
  NamedSharding(mesh, P())          -> replicate: rank 0's tensors broadcast

``batch_size`` is the GLOBAL batch, as the reference's mesh reads it: W
data ranks hold ``batch_size / W`` rows each, and a batch the data axis
does not divide raises by name (ranks cannot be dropped from a mesh the way
the reference shrinks its device list).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from ppt_torch.parallel import collectives as C

log = logging.getLogger(__name__)


def _first_slurm_node(nodelist: str) -> str:
    """First hostname of a SLURM nodelist, expanding the compressed
    bracket form: ``'node[01-04,07],other'`` -> ``'node01'`` (the
    reference resolves the coordinator the same way via
    ``scontrol show hostnames``; this avoids shelling out)."""
    if not nodelist:
        return ""
    # first top-level element (commas inside [...] are range separators)
    depth, head = 0, nodelist
    for i, ch in enumerate(nodelist):
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        elif ch == "," and depth == 0:
            head = nodelist[:i]
            break
    if "[" not in head:
        return head
    prefix, rest = head.split("[", 1)
    spec = rest.split("]", 1)[0].split(",")[0]  # first range/id in brackets
    first = spec.split("-", 1)[0]
    return prefix + first


def local_rank() -> int:
    """This process's index on its host: ``LOCAL_RANK`` (torchrun and the
    port's spawner set it), else ``SLURM_LOCALID``, else 0."""
    return int(os.environ.get("LOCAL_RANK", os.environ.get("SLURM_LOCALID", "0")))


def local_world_size(world: int) -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("SLURM_NTASKS_PER_NODE",
                                                                 str(world))))


def rank_device(device=None) -> torch.device:
    """This rank's device: the CPU when asked for, else its own card,
    ``cuda:{LOCAL_RANK % device_count}`` (ranks beyond the host's cards
    share them); a bare ``"cuda"`` would name card 0 on every rank."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if device is not None and torch.device(device).index is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run the ranks on the "
                           "CPU")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def default_backend(device=None, world: int = 1) -> str:
    """``nccl`` where each rank of this host owns a card, ``gloo`` on the
    CPU or where ranks share a card (NCCL refuses two ranks on one device)."""
    if device is not None and torch.device(device).type == "cpu":
        return "gloo"
    if not torch.cuda.is_available():
        return "gloo"
    return "nccl" if local_world_size(world) <= torch.cuda.device_count() else "gloo"


def _discover():
    """(init_method, world_size, rank) from the environment, in the
    reference's order (``mesh.py:60-144``), or None for one process."""
    env = os.environ
    if "PPT_COORDINATOR" in env:
        addr = env["PPT_COORDINATOR"]
        if "://" not in addr:
            addr = "tcp://" + addr
        return addr, int(env.get("PPT_NUM_PROCESSES", "1")), int(env.get("PPT_PROCESS_ID", "0"))
    if "MASTER_ADDR" in env and "WORLD_SIZE" in env:
        return (f"tcp://{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '12355')}",
                int(env["WORLD_SIZE"]), int(env.get("RANK", "0")))
    if "SLURM_PROCID" in env and "SLURM_NTASKS" in env:
        nodelist = env.get("SLURM_STEP_NODELIST", env.get("SLURM_NODELIST", ""))
        first = _first_slurm_node(nodelist) or "localhost"
        port = env.get("PPT_COORDINATOR_PORT", "12355")
        return f"tcp://{first}:{port}", int(env["SLURM_NTASKS"]), int(env["SLURM_PROCID"])
    return None


def _fill(args, rank: int, world: int) -> None:
    if args is not None:
        args.rank, args.world_size, args.distributed = rank, world, world > 1


def init_multihost(args=None, backend: Optional[str] = None) -> bool:
    """Process-group bring-up: the counterpart of the reference's
    ``init_multihost`` (and of ``init_distributed_mode``,
    ``utils/utils.py:104-143``).

    Discovery, in the reference's order:
      1. ``PPT_COORDINATOR`` (``host:port`` or a URL such as
         ``file:///path``) with ``PPT_NUM_PROCESSES`` / ``PPT_PROCESS_ID``;
      2. torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` with ``WORLD_SIZE`` /
         ``RANK``;
      3. SLURM: ``SLURM_PROCID`` / ``SLURM_NTASKS`` and the first node of
         ``SLURM_STEP_NODELIST``.
    The reference's fourth source, the TPU metadata
    (``TPU_WORKER_HOSTNAMES``, a pod slice discovering itself), has no GPU
    counterpart and is not read.

    ``backend`` defaults to ``default_backend``: ``nccl`` where each rank
    owns a card, ``gloo`` on the CPU (``args.device == "cpu"``) or where
    ranks share a card. A rank on the card selects its own,
    ``cuda:{LOCAL_RANK % device_count}``, before the group starts, and
    ``args.device`` names it. Idempotent: with a group already up it only
    fills ``args``. Sets ``args.rank``, ``args.world_size`` and
    ``args.distributed``; returns whether more than one process runs (False
    with no coordinator: "not using distributed mode")."""
    if dist.is_available() and dist.is_initialized():
        _fill(args, dist.get_rank(), dist.get_world_size())
        return dist.get_world_size() > 1
    found = _discover()
    if found is None:
        _fill(args, 0, 1)
        log.info("init_multihost: no coordinator config; single process")
        return False
    init_method, world, rank = found
    want = getattr(args, "device", "") or None
    backend = backend or default_backend(want, world)
    device = rank_device(want)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        if args is not None:
            args.device = str(device)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    _fill(args, rank, world)
    log.info("init_multihost: process %d/%d, backend %s, device %s", rank, world, backend,
             device)
    return world > 1


def create_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("data",),
                shape: Optional[Sequence[int]] = None, batch_size: Optional[int] = None):
    """A ``DeviceMesh`` over the process group's ranks, its dimensions named
    ``axis_names`` (``init_device_mesh(..., mesh_dim_names=axis_names)``);
    ``shape`` defaults to every rank on the first axis. ``n_devices``, if
    given, must be the world size. With ``batch_size``, the first axis (the
    data axis) must divide it: the reference shrinks its data axis to a
    divisor of the batch (``mesh.py:163-166``), but ranks cannot be shrunk
    away, so this raises by name."""
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("create_mesh: no process group; call init_multihost (or "
                           "init_process_group) first")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"create_mesh: {n_devices} devices asked for, the process group "
                         f"has {world} ranks (one device a rank)")
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"create_mesh: shape {shape} does not fit axes {tuple(axis_names)}")
    if torch.Size(shape).numel() != world:
        raise ValueError(f"create_mesh: shape {shape} holds {torch.Size(shape).numel()} "
                         f"ranks, the process group has {world}")
    if batch_size is not None and batch_size % shape[0]:
        raise ValueError(f"create_mesh: batch {batch_size} is not divisible by the "
                         f"'{axis_names[0]}' axis of {shape[0]} ranks (batch_size is the "
                         "global batch)")
    # the mesh only names the groups; gloo groups (the CPU, or ranks sharing
    # a card) build a CPU mesh, NCCL groups a CUDA one
    device_type = "cuda" if C.backend_of(None) == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axis_names))


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis`` on ``mesh``; 1 for a mesh without it (or none)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_group(mesh, axis: str):
    """The process group of ``axis`` on ``mesh`` (this rank's), or None."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return None
    return mesh.get_group(axis)


@dataclasses.dataclass(frozen=True)
class DataSharding:
    """``P(axis)``: the leading (batch) dimension split over ``axis``, each
    rank holding the contiguous rows ``[r B / W, (r + 1) B / W)``."""

    mesh: Any
    axis: str = "data"

    def rows(self, n: int) -> slice:
        if self.axis not in (self.mesh.mesh_dim_names or ()):
            raise ValueError(f"mesh has no '{self.axis}' axis (axes: "
                             f"{tuple(self.mesh.mesh_dim_names)})")
        dim = self.mesh.mesh_dim_names.index(self.axis)
        w, r = self.mesh.size(dim), self.mesh.get_local_rank(self.axis)
        if n % w:
            raise ValueError(f"batch of {n} rows is not divisible by the '{self.axis}' axis of "
                             f"{w} ranks")
        return slice(r * n // w, (r + 1) * n // w)


def data_sharding(mesh, axis: str = "data") -> DataSharding:
    """Sharding that splits the leading (batch) dim over the data axis."""
    return DataSharding(mesh, axis)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch: Any, mesh, axis: str = "data") -> Any:
    """This rank's rows of a global batch (a tensor, an array, or dicts and
    lists of them), as ``P(axis)`` places them."""
    sharding = data_sharding(mesh, axis)
    return _tree_map(lambda x: x[sharding.rows(x.shape[0])], batch)


def _tensors(tree) -> list:
    if isinstance(tree, torch.nn.Module):
        return [*tree.parameters(), *tree.buffers()]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree) for t in _tensors(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def replicate(tree: Any, mesh=None) -> Any:
    """Make ``tree`` (a module's parameters and buffers, or tensors in
    dicts, lists and dataclasses) equal on every rank: rank 0's values are
    broadcast in place. Returns ``tree``."""
    del mesh  # every rank of the world takes rank 0's values
    for t in _tensors(tree):
        C.broadcast_(t.data if isinstance(t, torch.nn.Parameter) else t, 0)
    return tree


def task_mesh(args):
    """A task driver's mesh: None for one process without a group; else
    ``create_mesh`` over every rank, its data axis holding
    ``args.batch_size`` (the global batch). ``args.mesh_devices`` is 0 or
    the world size (``torchrun --nproc_per_node W``: W); anything else
    raises by name."""
    n = int(getattr(args, "mesh_devices", 0) or 0)
    if not (dist.is_available() and dist.is_initialized()):
        if n > 1:
            raise ValueError(f"mesh_devices={n} needs {n} ranks: run the driver under "
                             f"torchrun --nproc_per_node {n} (or PPT_COORDINATOR / SLURM)")
        return None
    world = dist.get_world_size()
    if n not in (0, world):
        raise ValueError(f"mesh_devices={n}, but the process group has {world} ranks: "
                         f"give 0 or {world}")
    return create_mesh(world, batch_size=args.batch_size)


def is_main() -> bool:
    """Rank 0, or the one process: the rank that writes checkpoints and logs."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def gather_rows(t: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """Every data rank's rows of ``t`` in rank order, the inverse of
    ``shard_batch`` (outside autograd)."""
    with torch.no_grad():
        return C.all_gather_cat(t, axis_group(mesh, axis), dim=0)


def on_rows(mesh, fn, batch, axis: str = "data"):
    """``fn(batch)`` split over the data axis: each rank runs its rows and
    the result's rows are gathered back; ``fn(batch)`` itself without a
    mesh (evaluation under a mesh)."""
    if mesh is None:
        return fn(batch)
    return gather_rows(fn(shard_batch(batch, mesh, axis)), mesh, axis)
