"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
device given and no CUDA available they raise, so a run never drops to
the CPU without being told to.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.distributed


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``device``, else the card. Under a
    process group a card without an index is the rank's own
    (``parallel.mesh.rank_device``): a bare ``cuda`` would be card 0 on
    every rank."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU"
            )
        dev = torch.device("cuda")
    else:
        dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type == "cuda" and dev.index is None and torch.distributed.is_available() \
            and torch.distributed.is_initialized():
        from ppt_torch.parallel.mesh import rank_device

        return rank_device(dev)
    return dev


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_dtype(value) -> torch.dtype:
    if isinstance(value, str):
        if value not in _DTYPES:
            raise ValueError(f"compute dtype {value!r} not in {sorted(_DTYPES)}")
        return _DTYPES[value]
    return value
