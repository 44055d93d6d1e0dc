"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
device given and no CUDA available they raise, so a run never drops to
the CPU without being told to.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_dtype(value) -> torch.dtype:
    if isinstance(value, str):
        if value not in _DTYPES:
            raise ValueError(f"compute dtype {value!r} not in {sorted(_DTYPES)}")
        return _DTYPES[value]
    return value
