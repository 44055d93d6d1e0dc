"""Multi-head attention for the unfused ViT block, on hand-written kernels.

Counterpart of ``ppt_tpu/kernels/attention.py``; the CUDA side is
``csrc/attention.cu`` (whole-row kernels shared with the block through
``csrc/attention.cuh``; the bf16 whole-row kernel and the bf16 flash
forward and backward load their tiles by TMA and run wgmma, from
``csrc/hopper.cuh``),
whose header says what bounds each kernel on the H100 and how its design
answers that. Layout ``[B, L, H, D]`` in and out,
as the reference's (the ``jax.nn`` convention).

- ``fused_mha``: whole-row attention below ``FLASH_MIN_SEQ`` tokens
  (``_mha_kernel``, ``:65-106``): f32 scores times ``1/sqrt(D)``, the f32
  row max and ``exp``, P rounded to the compute dtype before P @ V, the f32
  accumulator divided by the f32 denominator afterwards. Its gradient is
  ``mha_reference``'s, which normalises before the cast: the reference's
  VJP differentiates ``_mha_reference`` (``:193-196``), not the kernel.
- ``flash_mha``: the plain ``jax.nn.dot_product_attention`` below
  ``FLASH_MIN_SEQ``, else the flash kernel (``:245-289``). Its backward is
  the kernel set ``flash_mha_bwd`` (``ppt_flash_mha_bwd``), the
  counterpart of the TPU's stock flash dq/dkv Pallas kernels: it reads the
  row log-sum-exp that the training forward writes. ``flash_bwd_plain``
  spells out that backward's arithmetic and cast points.

On the CPU each wrapper runs its kernel's plain version (``flash_mha``'s
gradient there is autograd of ``flash_plain``, which is what the reference
differentiates off the TPU); on the card it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ppt_torch.kernels import _build
from ppt_torch.kernels._autograd import recompute_grad, refuse_second_order

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


def flash_lse_plain(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The row log-sum-exp the training forward writes, [B, H, L] f32:
    m + log(sum exp(s - m)) over the f32 scaled scores."""
    s = _scores(q, k) * (1.0 / math.sqrt(q.shape[-1]))
    m = s.amax(-1, keepdim=True)
    return (m + torch.log(torch.exp(s - m).sum(-1, keepdim=True)))[..., 0]


def flash_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                    lse: torch.Tensor, do: torch.Tensor):
    """``flash_mha_bwd``'s arithmetic step by step (the stock TPU backward's
    function, ``flash_attention.py:254-276``, ``:894-919``, ``:1227-1261``):
    p = exp(s * scale - lse) in f32; dV = p^T (rounded to the compute dtype)
    do; dP = do v^T and di = rowsum(o do) in f32, o being the forward's
    rounded output; dS = (dP - di) p scale; dK = dS^T q and dQ = dS k with
    dS rounded to the compute dtype. Sums in f32, results in q's dtype.
    Returns (dq, dk, dv), [B, L, H, D] each."""
    dt = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_scores(q, k) * scale - lse[..., None])  # [B, H, L, L]
    dof = do.float().transpose(1, 2)  # [B, H, L, D]
    dv = p.to(dt).float().transpose(-1, -2) @ dof
    dp = dof @ v.float().permute(0, 2, 3, 1)
    di = (o.float() * do.float()).sum(-1).transpose(1, 2)  # [B, H, L]
    ds = ((dp - di[..., None]) * p * scale).to(dt).float()
    dk = ds.transpose(-1, -2) @ q.float().transpose(1, 2)
    dq = ds @ k.float().transpose(1, 2)
    return tuple(g.transpose(1, 2).to(dt) for g in (dq, dk, dv))


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


def _check_tma(name: str, dt: torch.dtype, strides, *tensors: torch.Tensor) -> None:
    """The bf16 kernels load their tiles by TMA (``fused_mha``, the flash
    forward and backward), which needs every stride (sb, sl, sh) a multiple
    of 16 bytes and 16-byte aligned bases; ``_views`` copies what does not
    qualify, and this refuses by name what reaches the C call otherwise."""
    if dt != torch.bfloat16:
        return
    if any(st * 2 % 16 for st in strides):
        raise ValueError(f"{name}: TMA needs strides that are multiples of 16 bytes, got "
                         f"{tuple(strides)} bf16 elements")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: TMA needs 16-byte aligned bases")


def _check_dims(name: str, dt: torch.dtype, D: int) -> None:
    if dt == torch.bfloat16:
        if D not in (32, 64, 128):
            raise ValueError(f"{name}: bf16 needs head dim 32, 64 or 128 (got {D})")
    elif D % 8 or D > 128:
        raise ValueError(f"{name}: head dim {D} must be a multiple of 8 and <= 128")


_ARGS = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 3


def _launch(name: str, entry: str, q, k, v, want_lse: bool = False):
    """One attention kernel; with ``want_lse`` (the flash kernel in
    training) returns (out, the [B, H, L] f32 row log-sum-exp)."""
    B, L, H, D = q.shape
    code = _build.dtype_code(name, q.dtype)
    _check_dims(name, q.dtype, D)
    if entry == "ppt_mha" and q.dtype == torch.float32 and \
            4 * (32 * D + 64 * (D + 1) + 32 * L + 32) > _SMEM_LIMIT:
        raise ValueError(f"{name}: L={L} too long for whole-row attention tiles")
    q, k, v, (sb, sl, sh) = _views(name, q, k, v)
    _check_tma(name, q.dtype, (sb, sl, sh), q, k, v)
    out = torch.empty(B, L, H, D, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, L, dtype=torch.float32, device=q.device) if want_lse else None
    lib = _build.load("attention")
    fn = getattr(lib, entry)
    p = _build.ptr
    args = [code, p(q), p(k), p(v), B, L, H, D, sb, sl, sh, p(out)]
    if entry == "ppt_flash_mha":  # the lse pointer: null when serving
        args.append(ctypes.c_void_p(None) if lse is None else p(lse))
    fn.argtypes = _ARGS + [ctypes.c_void_p] * (len(args) - len(_ARGS) + 1)
    rc = fn(*args, _build.stream_ptr(q))
    _build.check(lib, rc, name)
    _build.LAUNCHES[name] += 1
    return (out, lse) if want_lse else out


def bwd_smem_bytes(dt: torch.dtype, D: int) -> int:
    """Shared memory of the larger backward CTA (``csrc/attention.cu``): in
    bf16 the dK/dV kernel's K and V tiles of its two 64-key consumers, four
    stages of 64-query Q and dO tiles with their di and lse rows, its
    mbarriers and the slack that aligns the tiles to 1024 bytes
    (``dkv_smem_bytes``); in f32 four 32-row tiles, the P and dS tiles and
    the lse/di slices."""
    if dt == torch.bfloat16:
        tile = 64 * D * 2
        return 1024 + 4 * tile + 4 * (2 * tile + 512) + 8 * 9
    return 4 * (4 * 32 * (D + 1) + 2 * 32 * 33 + 2 * 32)


def bwd_scratch_shape(dt: torch.dtype, B: int, L: int, H: int):
    """The f32 scratch of the di launch: in bf16 di and a copy of the lse
    side by side, rows padded to a multiple of 64 so that the dK/dV kernel
    takes a query tile's by one bulk copy each, [B, H, 2, Lp]; in f32 di
    alone, [B, H, L]."""
    if dt == torch.bfloat16:
        return (B, H, 2, -(-L // 64) * 64)
    return (B, H, L)


def _flash_bwd(q, k, v, o, lse, do):
    """``ppt_flash_mha_bwd`` on the card: di, then dK/dV, then dQ, on the
    forward's saved q, k, v (as it took them), output and lse; -> (dq, dk,
    dv)."""
    name = "flash_mha_bwd"
    B, L, H, D = q.shape
    code = _build.dtype_code(name, q.dtype)
    _check_dims(name, q.dtype, D)
    if bwd_smem_bytes(q.dtype, D) > _SMEM_LIMIT:
        raise ValueError(f"{name}: head dim {D} tiles exceed the SM's shared memory")
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (B, H, L):
        raise ValueError(f"{name}: o {tuple(o.shape)}, do {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)} do not fit q {tuple(q.shape)}")
    if o.dtype != q.dtype or do.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError(f"{name}: o and do must be in q's dtype {q.dtype}, lse in float32")
    q, k, v, (sb, sl, sh) = _views(name, q, k, v)
    o, do, lse = o.contiguous(), do.contiguous(), lse.contiguous()
    _build.check_tensors(name, o, do, lse)
    if o.device != q.device:
        raise ValueError(f"{name}: q on {q.device}, o on {o.device}")
    _check_tma(name, q.dtype, (sb, sl, sh), q, k, v, do)
    di = torch.empty(bwd_scratch_shape(q.dtype, B, L, H), dtype=torch.float32, device=q.device)
    grads = [torch.empty(B, L, H, D, dtype=q.dtype, device=q.device) for _ in range(3)]
    lib = _build.load("attention")
    fn = lib.ppt_flash_mha_bwd
    fn.argtypes = _ARGS + [ctypes.c_void_p] * 8
    p = _build.ptr
    rc = fn(code, p(q), p(k), p(v), B, L, H, D, sb, sl, sh, p(o), p(do), p(lse), p(di),
            *map(p, grads), _build.stream_ptr(q))
    _build.check(lib, rc, name)
    _build.LAUNCHES[name] += 1
    return tuple(grads)


def _mha_run(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if q.device.type == "cpu":
        return mha_plain(q, k, v)
    return _launch("fused_mha", "ppt_mha", q, k, v)


def fused_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Whole-row attention, [B, L, H, D] -> [B, L, H, D] in q's dtype.
    Differentiable: the backward recomputes ``mha_reference``."""
    return recompute_grad("fused_mha", _mha_run, mha_reference, q, k, v)


def _flash_run(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if q.device.type == "cpu":
        return flash_plain(q, k, v)
    return _launch("flash_mha", "ppt_flash_mha", q, k, v)


def _flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """The training forward on the card: (output, row log-sum-exp)."""
    return _launch("flash_mha", "ppt_flash_mha", q, k, v, want_lse=True)


class _FlashMha(torch.autograd.Function):
    """The flash kernel with its backward kernels, for CUDA tensors: the
    forward saves q, k, v, its output and the lse."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = _flash_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        refuse_second_order("flash_mha_bwd")
        grads = _flash_bwd(*ctx.saved_tensors, do)
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Multi-head attention, [B, L, H, D] -> [B, L, H, D]: the plain
    ``jax.nn.dot_product_attention`` semantics below ``FLASH_MIN_SEQ`` tokens
    (as the reference routes by shape), else the flash kernel, which writes
    the row log-sum-exp for its backward kernels only when a gradient is
    wanted. On CPU tensors the gradient is autograd of ``flash_plain``. The
    reference's ``causal`` option has no caller in either package and is
    not ported."""
    if q.shape[1] < FLASH_MIN_SEQ:
        return flash_plain(q, k, v)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))):
        return _flash_run(q, k, v)
    if q.device.type == "cpu":
        return recompute_grad("flash_mha", _flash_run, flash_plain, q, k, v)
    return _FlashMha.apply(q, k, v)
