"""Synthetic point clouds from the seed, made on the card in a few calls.

A copy of the structure of ``ppt_torch/data/datasets.py:make_synthetic``
(class-structured gaussian blobs): class ``c`` has ``2 + c % 4`` blob
centres, each point is a centre times 0.5 plus N(0, 0.15^2) noise, and each
cloud is centred and scaled into the unit ball. Here the centres come from
the seed too, labels cycle through the classes, and the whole set is drawn
at once on the device and handed over as host arrays, as a dataset read
from disk would be.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

SPLIT_SALT = {"train": 0, "test": 1 << 41}


def make(n_clouds: int, npoints: int, num_classes: int, seed: int, split: str,
         device) -> Tuple[np.ndarray, np.ndarray]:
    """(points [M, N, 3] float32, labels [M] int32) as numpy arrays."""
    gen = torch.Generator(device=device).manual_seed(seed + SPLIT_SALT[split])
    centres = torch.randn(num_classes, 5, 3, generator=gen, device=device)
    labels = torch.arange(n_clouds, device=device) % num_classes
    n_blobs = (2 + labels % 4)[:, None]
    blob = (torch.rand(n_clouds, npoints, generator=gen, device=device) * n_blobs).long()
    blob = torch.minimum(blob, n_blobs - 1)
    pts = centres[labels[:, None], blob] * 0.5
    pts = pts + torch.randn(n_clouds, npoints, 3, generator=gen, device=device) * 0.15
    pts = pts - pts.mean(1, keepdim=True)
    pts = pts / pts.norm(dim=-1).amax(1)[:, None, None]
    return pts.cpu().numpy(), labels.int().cpu().numpy()
