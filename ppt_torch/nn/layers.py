"""Shared layers with the reference's numerical behaviours.

Counterpart of ``ppt_tpu/nn/layers.py``. Parameters stay f32 (as in the
flax modules); a layer built with a compute ``dtype`` casts its inputs
and parameters to it, as flax's ``Dense(dtype=...)`` does. ``Dense``
keeps flax's ``kernel`` ``[in, out]`` layout, the layout the hand-written
kernels take, so neither the weight bridge nor a kernel call transposes.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ppt_torch.parallel import collectives as _dp


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


BN_EPS = 1e-5  # flax nn.BatchNorm default
BN_MOMENTUM = 0.99  # flax nn.BatchNorm default: ra = 0.99 ra + 0.01 batch


class BatchNormStats(nn.Module):
    """BatchNorm parameters and running statistics (flax ``scale``/``bias``
    and ``batch_stats`` ``mean``/``var``), for a caller that folds them
    into adjacent Dense weights: with the running statistics in eval, with
    the batch's in training, which also moves the running statistics as
    flax does, with ``momentum`` and ``eps`` (flax's 0.99 and 1e-5 unless a
    module sets others: RandLA-Net's are 0.01 and 1e-6)."""

    def __init__(self, width: int, momentum: float = BN_MOMENTUM, eps: float = BN_EPS):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))
        self.register_buffer("running_mean", torch.zeros(width))
        self.register_buffer("running_var", torch.ones(width))

    def fold(self, mean: Optional[torch.Tensor] = None,
             var: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(scale, shift) with BN(x) = x * scale + shift, from the given
        batch statistics or else the running ones."""
        if mean is None:
            mean, var = self.running_mean, self.running_var
        scale = self.weight / torch.sqrt(var + self.eps)
        return scale, self.bias - mean * scale

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """flax's update, in place: ``ra = m ra + (1 - m) batch`` (m 0.99 by
        default) with the BIASED batch variance (torch's BatchNorm would use
        0.1 and the unbiased one)."""
        m = self.momentum
        self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
        self.running_var.mul_(m).add_(var, alpha=1.0 - m)


class BatchNorm(BatchNormStats):
    """flax ``nn.BatchNorm(dtype=float32)`` over the last axis: statistics
    and affine in f32 whatever the input's dtype (a bf16 Dense output), the
    result f32. ``train``: the batch's mean and biased variance
    (``E[x^2] - E[x]^2`` clamped at 0, flax's fast variance) normalise and
    move the running statistics; in a data-parallel step the global batch's,
    from sums over the data group (sync-BN, ``parallel/collectives.py``);
    else the running statistics normalise."""

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.float()
        if train:
            flat = x.reshape(-1, x.shape[-1])
            if _dp.active() is None:
                mean = flat.mean(0)
                var = torch.clamp_min((flat * flat).mean(0) - mean * mean, 0.0)
            else:  # sync-BN: the sums over the data group, as flax's global statistics
                n = _dp.sync_count(flat.shape[0])
                mean = _dp.sync_sum(flat.sum(0)) / n
                var = torch.clamp_min(_dp.sync_sum((flat * flat).sum(0)) / n - mean * mean, 0.0)
            self.update_running(mean.detach(), var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: in training each element is kept with
    probability ``1 - rate`` and scaled by its inverse, the mask drawn from
    ``generator`` (on ``x``'s device; at the global batch in a data-parallel
    step, ``parallel.collectives.global_draw``); identity in eval or at rate
    0."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = _dp.global_draw(torch.rand, x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class LayerNormF32(nn.Module):
    """LayerNorm with f32 statistics and affine, result cast back to the
    input dtype (reference ``models/ULIP_models.py:21-27``); flax's fast
    variance ``E[x^2] - E[x]^2`` clamped at 0, as flax's ``_compute_stats``
    takes it (a near-constant row of large values can round it negative).
    The kernels' LayerNorms follow the Pallas kernels, which do not clamp."""

    def __init__(self, width: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        var = torch.clamp_min((x32 * x32).mean(-1, keepdim=True) - mu * mu, 0.0)
        y = (x32 - mu) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return y.to(x.dtype)


GN_EPS = 1e-6  # flax nn.GroupNorm default (torch's is 1e-5)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups, dtype=float32)`` on channels-last
    input ``[B, ..., C]``: each group of ``C / num_groups`` channels is
    normalised over every non-batch axis together (for ``[B, G, k, C]``: G,
    k and the group's channels; torch's ``GroupNorm`` is channel-first),
    with flax's fast variance ``E[x^2] - E[x]^2`` clamped at 0 and eps 1e-6;
    f32 statistics, parameters and output whatever the input's dtype."""

    def __init__(self, width: int, num_groups: int = 4, eps: float = GN_EPS):
        super().__init__()
        if width % num_groups:
            raise ValueError(f"GroupNorm: {num_groups} groups do not divide {width} channels")
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[0], x.shape[-1]
        shape = (self.num_groups, C // self.num_groups)
        g = x.float().reshape(B, -1, *shape)
        mean = g.mean((1, 3), keepdim=True)
        var = torch.clamp_min((g * g).mean((1, 3), keepdim=True) - mean * mean, 0.0)
        y = (g - mean) * (torch.rsqrt(var + self.eps) * self.weight.reshape(shape))
        return (y + self.bias.reshape(shape)).reshape(x.shape)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """flax ``nn.leaky_relu``: ``x`` where ``x >= 0``, else ``slope * x``."""
    return F.leaky_relu(x, negative_slope)


@torch.no_grad()
def init_dense_(module: nn.Module, gen: torch.Generator) -> None:
    """Every ``Dense`` under ``module``, in module order: a lecun-normal
    kernel (std 1/sqrt(fan_in), drawn from ``gen`` on the CPU, so every
    device gets the same values) and a zero bias, the reference's
    initialiser families."""
    for mod in module.modules():
        if isinstance(mod, Dense):
            mod.kernel.copy_(torch.randn(mod.kernel.shape, generator=gen)
                             * (1.0 / math.sqrt(mod.kernel.shape[0])))
            if mod.bias is not None:
                mod.bias.zero_()


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's sigmoid-approximated GELU (``models/ULIP_models.py:30-32``)."""
    return x * torch.sigmoid(1.702 * x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu`` default (tanh approximation)."""
    return F.gelu(x, approximate="tanh")


def drop_path_scales(rates: Sequence[float], batch: int, train: bool,
                     generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Stochastic depth as the per-sample branch scales the block kernel
    takes: ``[len(rates), batch, 2]`` f32, one scale for the attention
    branch and one for the MLP branch of each block. In training each is
    Bernoulli(keep) / keep with keep = 1 - rate (``nn/pointbert.py:339-349``),
    drawn from ``generator`` (at the global batch in a data-parallel step); a
    block of rate 0 (block 0 of the
    ``linspace(0, drop_path_rate, depth)`` ladder) and eval mode give ones."""
    if not train or max(rates) == 0.0:
        return torch.ones(len(rates), batch, 2, dtype=torch.float32, device=device)
    keep = 1.0 - torch.tensor(list(rates), dtype=torch.float32, device=device)[:, None, None]
    u = _dp.global_draw(torch.rand, (len(rates), batch, 2), dim=1, generator=generator,
                        device=device)
    return (u < keep).float() / keep


def drop_path(h: torch.Tensor, scale: torch.Tensor, rate: float) -> torch.Tensor:
    """The reference's ``DropPath`` on a branch ``h`` [B, ...]
    (``ppt_tpu/nn/layers.py:77-89``) for the samples that ``scale`` (one
    column of ``drop_path_scales``, zero where a sample is dropped) keeps:
    ``h / keep`` in ``h``'s dtype with ``keep = 1 - rate`` rounded to it,
    an exact zero where dropped; ``h`` itself at rate 0 (and in eval)."""
    if rate == 0.0:
        return h
    keep = torch.tensor(1.0 - rate, dtype=h.dtype, device=h.device)
    kept = (scale > 0).reshape((-1,) + (1,) * (h.dim() - 1))
    return torch.where(kept, h / keep, torch.zeros((), dtype=h.dtype, device=h.device))


class MlpBlock(nn.Module):
    """Transformer MLP: fc1 -> tanh-GELU -> fc2 (PointBERT ``Mlp``)."""

    def __init__(self, width: int, hidden_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Dense(width, hidden_dim, dtype=dtype)
        self.fc2 = Dense(hidden_dim, width, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tp = getattr(self, "tp", None)
        if tp is not None:  # Megatron: fc1 on its columns, fc2 on its rows, one all-reduce
            from ppt_torch.parallel.sharding import column_parallel, row_parallel

            return row_parallel(gelu_tanh(column_parallel(x, self.fc1, tp)), self.fc2, tp)
        return self.fc2(gelu_tanh(self.fc1(x)))


class CastCache:
    """Copies of frozen parameters in the form a kernel takes them (cast,
    stacked), kept until a source parameter changes (an in-place write
    bumps its ``_version``; ``.to(device)`` or a new storage changes its
    pointer). The text and point towers keep one each."""

    def __init__(self):
        self._key = None
        self._value = None

    def get(self, params: List[torch.Tensor], dt: torch.dtype, build):
        if torch.is_grad_enabled() and any(p.requires_grad for p in params):
            return build()  # a training weight: stay in the autograd graph
        key = (dt, tuple((p.data_ptr(), p._version) for p in params))
        if key != self._key:
            with torch.no_grad():
                self._value = build()
            self._key = key
        return self._value
