"""Multi-head attention for the unfused ViT block, on hand-written kernels.

Counterpart of ``ppt_tpu/kernels/attention.py``; the CUDA side is
``csrc/attention.cu`` (whole-row kernels shared with the block through
``csrc/attention.cuh``), whose header says what bounds each kernel on the
H100 and how its design answers that. Layout ``[B, L, H, D]`` in and out,
as the reference's (the ``jax.nn`` convention).

- ``fused_mha``: whole-row attention below ``FLASH_MIN_SEQ`` tokens
  (``_mha_kernel``, ``:65-106``): f32 scores times ``1/sqrt(D)``, the f32
  row max and ``exp``, P rounded to the compute dtype before P @ V, the f32
  accumulator divided by the f32 denominator afterwards. Its gradient is
  ``mha_reference``'s, which normalises before the cast: the reference's
  VJP differentiates ``_mha_reference`` (``:193-196``), not the kernel.
- ``flash_mha``: the plain ``jax.nn.dot_product_attention`` below
  ``FLASH_MIN_SEQ``, else the flash kernel (``:245-289``).
  Its backward is the TPU's stock flash dq/dkv Pallas kernels, not ported:
  it raises.

On the CPU each wrapper runs its kernel's plain version; on the card it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ppt_torch.kernels import _build
from ppt_torch.kernels._autograd import recompute_grad

# At and above this length every trunk route takes the unfused block with
# flash_mha (ppt_tpu/kernels/attention.py:45): the whole-row scores stop
# fitting the TPU's VMEM.
FLASH_MIN_SEQ = 1024

_SMEM_LIMIT = 227 * 1024


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """f32-accumulated q k^T per head: [B, L, H, D] x2 -> [B, H, L, L] f32."""
    return q.float().transpose(1, 2) @ k.float().permute(0, 2, 3, 1)


def _pv(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """f32-accumulated P @ V: [B, H, L, L] x [B, L, H, D] -> [B, L, H, D] f32."""
    return (p.float() @ v.float().transpose(1, 2)).transpose(1, 2)


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The whole-row kernel's math (``_mha_kernel``): the row max over all
    keys, unnormalised P rounded to the compute dtype before P @ V, the
    division by the f32 denominator afterwards."""
    dt = q.dtype
    s = _scores(q, k) * (1.0 / math.sqrt(q.shape[-1]))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    denom = p.sum(-1, keepdim=True).transpose(1, 2)  # [B, L, H, 1]
    return (_pv(p.to(dt), v) / denom).to(dt)


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``_mha_reference`` (``:167-174``), the source of ``fused_mha``'s
    gradient: scores in the compute dtype then f32, softmax normalised in
    f32, cast, P @ V in the compute dtype."""
    dt = q.dtype
    s = _scores(q, k).to(dt).float() * (1.0 / math.sqrt(q.shape[-1]))
    p = torch.softmax(s, dim=-1)
    return _pv(p.to(dt), v).to(dt)


def flash_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``jax.nn.dot_product_attention`` as the installed JAX computes it
    (``_dot_product_attention_core``): f32 logits times the f32 scale,
    softmax normalised in f32, probabilities cast to the compute dtype,
    P @ V rounded to it."""
    dt = q.dtype
    s = _scores(q, k) * (1.0 / math.sqrt(q.shape[-1]))
    p = torch.softmax(s, dim=-1)
    return _pv(p.to(dt), v).to(dt)


def _views(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q, k, v as the kernels take them: one device, one dtype, D contiguous
    and strides shared (views of one qkv product qualify as they are);
    anything else is copied to a contiguous [B, L, H, D]. bf16 rows must be
    16-byte aligned. Returns (q, k, v, (sb, sl, sh))."""
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(f"{name}: q, k, v must share one [B, L, H, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{name}: q, k, v dtypes differ")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{name}: tensors on {q.device}, {k.device}, {v.device}")
    st = q.stride()
    ok = st == k.stride() == v.stride() and st[-1] == 1
    if ok and q.dtype == torch.bfloat16:
        ok = all(s % 8 == 0 for s in st[:3]) and all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    if not ok:
        q, k, v = (t.contiguous() for t in (q, k, v))
        st = q.stride()
    return q, k, v, st[:3]


def _check_dims(name: str, dt: torch.dtype, D: int) -> None:
    if dt == torch.bfloat16:
        if D not in (32, 64, 128):
            raise ValueError(f"{name}: bf16 needs head dim 32, 64 or 128 (got {D})")
    elif D % 8 or D > 128:
        raise ValueError(f"{name}: head dim {D} must be a multiple of 8 and <= 128")


def _launch(name: str, entry: str, q, k, v) -> torch.Tensor:
    B, L, H, D = q.shape
    code = _build.dtype_code(name, q.dtype)
    _check_dims(name, q.dtype, D)
    if entry == "ppt_mha" and q.dtype == torch.float32 and \
            4 * (32 * D + 64 * (D + 1) + 32 * L + 32) > _SMEM_LIMIT:
        raise ValueError(f"{name}: L={L} too long for whole-row attention tiles")
    q, k, v, (sb, sl, sh) = _views(name, q, k, v)
    out = torch.empty(B, L, H, D, dtype=q.dtype, device=q.device)
    lib = _build.load("attention")
    fn = getattr(lib, entry)
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 2)
    p = _build.ptr
    rc = fn(code, p(q), p(k), p(v), B, L, H, D, sb, sl, sh, p(out), _build.stream_ptr(q))
    _build.check(lib, rc, name)
    _build.LAUNCHES[name] += 1
    return out


def _mha_run(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if q.device.type == "cpu":
        return mha_plain(q, k, v)
    return _launch("fused_mha", "ppt_mha", q, k, v)


def fused_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Whole-row attention, [B, L, H, D] -> [B, L, H, D] in q's dtype.
    Differentiable: the backward recomputes ``mha_reference``."""
    return recompute_grad(_mha_run, mha_reference, q, k, v)


def _flash_run(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if q.device.type == "cpu":
        return flash_plain(q, k, v)
    return _launch("flash_mha", "ppt_flash_mha", q, k, v)


class _FlashMha(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        return _flash_run(q, k, v)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "flash_mha has no backward yet: the reference's is the stock TPU flash-attention "
            "dq/dkv Pallas kernels (jax.experimental.pallas.ops.tpu.flash_attention), which "
            "are still to port; no plain recompute stands in for them")


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Multi-head attention, [B, L, H, D] -> [B, L, H, D]: the plain
    ``jax.nn.dot_product_attention`` semantics below ``FLASH_MIN_SEQ`` tokens
    (as the reference routes by shape), else the flash kernel, whose
    backward raises. The reference's ``causal`` option has no caller in
    either package and is not ported."""
    if q.shape[1] < FLASH_MIN_SEQ:
        return flash_plain(q, k, v)
    return _FlashMha.apply(q, k, v)
