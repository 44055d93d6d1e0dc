"""Shared layers with the reference's numerical behaviours.

Counterpart of ``ppt_tpu/nn/layers.py``. Parameters stay f32 (as in the
flax modules); a layer built with a compute ``dtype`` casts its inputs
and parameters to it, as flax's ``Dense(dtype=...)`` does. ``Dense``
keeps flax's ``kernel`` ``[in, out]`` layout, the layout the hand-written
kernels take, so neither the weight bridge nor a kernel call transposes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Module):
    """flax ``Dense(dtype=...)``: ``kernel`` ``[in, out]``; inputs, kernel
    and bias are cast to the compute dtype, the product is rounded to it
    and the bias added after."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = x.to(dt) @ self.kernel.to(dt)
        return y if self.bias is None else y + self.bias.to(dt)


class LayerNormF32(nn.Module):
    """LayerNorm with f32 statistics and affine, result cast back to the
    input dtype (reference ``models/ULIP_models.py:21-27``); flax's fast
    variance ``E[x^2] - E[x]^2``."""

    def __init__(self, width: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        var = (x32 * x32).mean(-1, keepdim=True) - mu * mu
        y = (x32 - mu) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return y.to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's sigmoid-approximated GELU (``models/ULIP_models.py:30-32``)."""
    return x * torch.sigmoid(1.702 * x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu`` default (tanh approximation)."""
    return F.gelu(x, approximate="tanh")


class MlpBlock(nn.Module):
    """Transformer MLP: fc1 -> tanh-GELU -> fc2 (PointBERT ``Mlp``)."""

    def __init__(self, width: int, hidden_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Dense(width, hidden_dim, dtype=dtype)
        self.fc2 = Dense(hidden_dim, width, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu_tanh(self.fc1(x)))
