"""Data, tensor and pipeline parallelism over ``torch.distributed``.

Counterpart of ``ppt_tpu/parallel/``. The names load on first use: the
modules of ``ppt_torch.nn`` import ``parallel.collectives`` for sync-BN and
the global draws, and this package must not import them back.
"""

import importlib

_EXPORTS = {
    "create_mesh": "mesh", "init_multihost": "mesh", "shard_batch": "mesh",
    "replicate": "mesh", "data_sharding": "mesh",
    "pipeline_blocks": "pipeline", "pipelined_partseg_features": "pipeline",
    "pipelined_trunk_features": "pipeline", "stack_vit_blocks": "pipeline",
    "shard_params": "sharding", "ulip_param_spec": "sharding",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
