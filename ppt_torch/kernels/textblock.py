"""One CLIP text block on a hand-written kernel.

Replaces ``ppt_tpu/kernels/textblock.py:fused_text_block``; the CUDA side
is ``csrc/text.cu`` (entry point ``ppt_text_block``), whose header says
what bounds it on the H100 and how its design answers that.

Semantics (``textblock.py:75-150``), in the compute dtype of ``x`` with
f32 accumulation: LN1 in f32 (fast variance, eps 1e-5); fused QKV with the
bias added in f32 before the cast; causal attention with an f32 softmax;
out_proj; residual; LN2; ``c_fc`` with QuickGELU in f32; ``c_proj``;
residual. ``text_block_plain`` follows the reference's twin
(``_text_twin``, ``:195-238``), which normalises the softmax before the
cast; the kernel follows the reference's kernel body, which casts
``exp(s - m)`` and divides the f32 accumulator afterwards. In f32 the two
are the same function.

The block is the registered operator ``torch.ops.ppt.fused_text_block``
(``_ops.py``): the plain version on the CPU key, the launch on the CUDA
key. The reference gives the block no backward kernel (``:267-269``): the
gradient is the twin's, recomputed (``_autograd.py``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from ppt_torch.kernels import _build, _ops
from ppt_torch.kernels._autograd import recompute_grad
from ppt_torch.kernels.vitblock import _mm, check_tma, ln_f32

LN_EPS = 1e-5  # the text tower's LayerNorm, not the point tower's 1e-6
SMEM_LIMIT = 227 * 1024  # dynamic shared memory one block may take on sm_90
ATT_MAX_L = 128  # the bf16 attention's positions: 8 key tiles of 16 (csrc/text.cu)
MATRICES = (2, 4, 8, 10)  # in_proj, out_proj, c_fc, c_proj kernels among a layer's 12 weights
MATRIX_NAMES = ("win", "wout", "wfc", "wproj")


def quick_gelu_f32(x32: torch.Tensor) -> torch.Tensor:
    return x32 * torch.sigmoid(1.702 * x32)


def causal_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """f32 ``q @ k^T / sqrt(d)`` of ``[B, H, L, d]`` heads, -inf above the
    diagonal."""
    L, d = q.shape[-2:]
    s = _mm(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    above = torch.ones(L, L, dtype=torch.bool, device=q.device).triu(1)
    return s.masked_fill(above, float("-inf"))


def split_heads(qkv: torch.Tensor, heads: int):
    """``[B, L, 3D]`` -> q, k, v as ``[B, H, L, d]``."""
    B, L, D3 = qkv.shape
    D = D3 // 3
    return (t.reshape(B, L, heads, D // heads).transpose(1, 2) for t in qkv.split(D, dim=-1))


def text_block_plain(x, ln1s, ln1b, wqkv, bqkv, wout, bout, ln2s, ln2b, wfc, bfc, wproj, bproj,
                     heads) -> torch.Tensor:
    """Plain PyTorch version of one block. x ``[B, L, D]`` and the four
    weight matrices in the compute dtype; LN parameters and biases f32."""
    B, L, D = x.shape
    dt = x.dtype
    xn = ln_f32(x.float(), ln1s, ln1b, LN_EPS).to(dt)
    qkv = (_mm(xn, wqkv) + bqkv).to(dt)
    q, k, v = split_heads(qkv, heads)
    p = torch.softmax(causal_scores(q, k), dim=-1)
    attn = _mm(p.to(dt), v).to(dt).transpose(1, 2).reshape(B, L, D)
    x1 = x + (_mm(attn, wout) + bout).to(dt)
    xn2 = ln_f32(x1.float(), ln2s, ln2b, LN_EPS).to(dt)
    h1 = quick_gelu_f32(_mm(xn2, wfc) + bfc).to(dt)
    return x1 + (_mm(h1, wproj) + bproj).to(dt)


def attention_smem(L: int, d: int, dt: torch.dtype, backward: bool = False) -> int:
    """Dynamic shared memory of one class's attention block in
    ``csrc/text.cu``: in bf16, q, k, v (and dO, T(P), T(dS) in the
    backward) with L padded to 16 and rows padded by 8 elements
    (``attn_bf16_smem``); in f32, q, k, v (and dO) as ``[L][d + 1]`` and one
    (two) ``[L][L]`` score matrices."""
    if dt == torch.bfloat16:
        lp = -(-L // 16) * 16
        return 2 * ((4 if backward else 3) * lp * (d + 8) + (2 * lp * (lp + 8) if backward else 0))
    n_tiles, n_scores = (4, 2) if backward else (3, 1)
    return 4 * (n_tiles * L * (d + 1) + n_scores * L * L + L)


def check_text_shapes(name: str, L: int, D: int, heads: int, hid: int, dt: torch.dtype,
                      backward: bool = False) -> None:
    """Refuse by name what the kernels of ``csrc/text.cu`` do not take."""
    if D % heads:
        raise ValueError(f"{name}: width {D} is not a multiple of the head count {heads}")
    d = D // heads
    if D > 1024 or D % 8:
        raise ValueError(f"{name}: width {D} must be a multiple of 8 up to 1024 (the LayerNorm "
                         f"kernels take a row a warp, the backward in 16-byte chunks)")
    if d > 128:
        raise ValueError(f"{name}: head dim {d} exceeds 128")
    if dt == torch.bfloat16:
        if hid % 8:
            raise ValueError(f"{name}: bf16 GEMMs load rows by TMA, so hidden {hid} must be a "
                             f"multiple of 8 (16-byte rows)")
        if d % 16:
            raise ValueError(f"{name}: the bf16 attention's products step 16 deep, so head dim "
                             f"{d} must be a multiple of 16")
        if L > ATT_MAX_L:
            raise ValueError(f"{name}: L={L} exceeds the bf16 attention's {ATT_MAX_L} "
                             f"positions (a class's scores sit in registers)")
    smem = attention_smem(L, d, dt, backward)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: L={L} at head dim {d} needs {smem} bytes of shared memory "
                         f"for one class's attention, over {SMEM_LIMIT}")


def prepare_weights(dt: torch.dtype, weights: Sequence[torch.Tensor]):
    """The 12 per-layer weights (stacked or not) as the kernels take them:
    matrices in the compute dtype, LN parameters and biases f32, all
    contiguous. A tensor already in that form is passed through."""
    return [w.to(dt if i in MATRICES else torch.float32).contiguous()
            for i, w in enumerate(weights)]


def call_entry(entry: str, name: str, dt: torch.dtype, dims: Sequence[int],
               tensors: Sequence) -> None:
    """One call of a C entry point of ``csrc/text.cu``: ``(dtype, dims,
    pointers, stream)``; ``None`` in ``tensors`` is a null pointer."""
    present = [t for t in tensors if t is not None]
    _build.check_tensors(name, *present)
    lib = _build.load("text")
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p),
                   ctypes.c_void_p]
    c_dims = (ctypes.c_int * len(dims))(*dims)
    c_ptrs = (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])
    rc = fn(_build.dtype_code(name, dt), c_dims, c_ptrs, _build.stream_ptr(present[0]))
    _build.check(lib, rc, name)
    _build.LAUNCHES[name] += 1


def forward_scratch(R: int, D: int, hid: int, dt: torch.dtype, device):
    """y, qkv, attn, x1, h1 of one layer's forward."""
    return [torch.empty(R, n, dtype=dt, device=device) for n in (D, 3 * D, D, D, hid)]


def _launch(x, weights, heads):
    name = "fused_text_block"
    B, L, D = x.shape
    dt = x.dtype
    _build.dtype_code(name, dt)
    hid = weights[8].shape[-1]
    check_text_shapes(name, L, D, heads, hid, dt)
    x = x.contiguous()
    weights = prepare_weights(dt, weights)
    check_tma(name, x=x, **{n: weights[i] for i, n in zip(MATRICES, MATRIX_NAMES)})
    out = torch.empty_like(x)
    call_entry("ppt_text_block", name, dt, (B, L, D, heads, hid),
               [x, *weights, *forward_scratch(B * L, D, hid, dt, x.device), out])
    return out


def _block_cuda(x, ln1s, ln1b, wqkv, bqkv, wout, bout, ln2s, ln2b, wfc, bfc, wproj, bproj,
                heads) -> torch.Tensor:
    """``ppt::fused_text_block`` on the card."""
    return _launch(x, (ln1s, ln1b, wqkv, bqkv, wout, bout, ln2s, ln2b, wfc, bfc, wproj, bproj),
                   heads)


def _block_fake(x, *args) -> torch.Tensor:
    return x.new_empty(x.shape)


def block_flops(B: int, L: int, D: int, hid: int) -> int:
    """One text block's products as ``FlopCounterMode`` counts
    ``text_block_plain``'s, 2 a multiply-add: qkv, out_proj, c_fc, c_proj
    and the attention's two [L, L] products (the causal mask's zeros
    included, as the plain version multiplies them)."""
    return 2 * B * L * (4 * D * D + 2 * D * hid) + 4 * B * L * L * D


def _block_flops(x, ln1s, ln1b, wqkv, bqkv, wout, bout, ln2s, ln2b, wfc, *args) -> int:
    B, L, D = x
    return block_flops(B, L, D, wfc[-1])


TEXT_WEIGHTS = ("Tensor ln1s, Tensor ln1b, Tensor wqkv, Tensor bqkv, Tensor wout, Tensor bout, "
                "Tensor ln2s, Tensor ln2b, Tensor wfc, Tensor bfc, Tensor wproj, Tensor bproj")
_block_run = _ops.register(f"fused_text_block(Tensor x, {TEXT_WEIGHTS}, int heads) -> Tensor",
                           text_block_plain, _block_cuda, _block_fake, _block_flops)


def fused_text_block(x, ln1s, ln1b, wqkv, bqkv, wout, bout, ln2s, ln2b, wfc, bfc, wproj, bproj,
                     heads) -> torch.Tensor:
    """One whole CLIP text block: ``[B, L, D]`` -> ``[B, L, D]`` in x's
    dtype. Differentiable: the backward recomputes ``text_block_plain``."""
    return recompute_grad("fused_text_block", _block_run, text_block_plain, x, ln1s, ln1b, wqkv,
                          bqkv, wout, bout, ln2s, ln2b, wfc, bfc, wproj, bproj, heads)
