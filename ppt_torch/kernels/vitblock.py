"""PointBERT ViT block, block + trunk readout, and the whole trunk on
hand-written kernels.

Replaces ``ppt_tpu/kernels/vitblock.py:fused_vit_block``,
``:fused_vit_block_readout`` and ``:fused_vit_tower``; the CUDA side is
``csrc/vitblock.cu``, whose header says what bounds it on the H100 and how
its design answers that.

Semantics (``vitblock.py:66-125``), in the compute dtype of ``x`` with
f32 accumulation: x0 = x + pos; LN1 with f32 statistics (fast variance,
eps 1e-6); qkv; whole-row softmax attention with an f32 softmax, P cast
to dtype before P@V and the f32 accumulator divided by the f32
denominator; proj; droppath-scaled residual; LN2; MLP with tanh-GELU;
residual. The readout variant adds the final f32 LayerNorm and returns
``[B, 8, C]`` f32 rows: row 0 the normalised cls token, row 1 the
lanewise max over the point tokens, rows 2..7 zero. The tower runs
``depth`` blocks on stacked weights, per-sample droppath scales ``[B,
depth, 2]``, then the readout: on the card one C entry point walks the
block's launches over the depth, so its output equals the block chain's
bit for bit.

The block, the block + readout and the tower are registered operators,
``torch.ops.ppt.fused_vit_block``, ``torch.ops.ppt.fused_vit_block_readout``
and ``torch.ops.ppt.fused_vit_tower`` (``_ops.py``): the plain version on
the CPU key, the launch on the CUDA key. No kernel here has a backward kernel in the reference
(``vitblock.py:398-400``, ``:499-501``, ``:551-553``); each public function
carries the gradient of its plain version (``_autograd.py``), which is what
trains ``block_11`` under head types 1 to 3.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ppt_torch.kernels import _build, _ops
from ppt_torch.kernels._autograd import recompute_grad

LN_EPS = 1e-6


def ln_f32(x32: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = LN_EPS):
    """LayerNorm over the last axis, f32 in and out, fast variance."""
    mu = x32.mean(-1, keepdim=True)
    var = (x32 * x32).mean(-1, keepdim=True) - mu * mu
    return (x32 - mu) * torch.rsqrt(var + eps) * scale + bias


def gelu_tanh(x32: torch.Tensor) -> torch.Tensor:
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x32 * (1.0 + torch.tanh(c * (x32 + 0.044715 * x32 * x32 * x32)))


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32-accumulated product of same-dtype operands, result f32."""
    return a.float() @ b.float()


def vit_block_plain(
    x, pos, dp, ln1s, ln1b, wqkv, wproj, bproj, ln2s, ln2b, wfc1, bfc1, wfc2, bfc2, heads
) -> torch.Tensor:
    """Plain PyTorch version of one block. x/pos [B, L, C] in the compute
    dtype; dp [B, 2] f32; weights in the compute dtype; LN params and
    biases f32."""
    B, L, C = x.shape
    d = C // heads
    dt = x.dtype
    x0 = x + pos.to(dt)
    xn = ln_f32(x0.float(), ln1s, ln1b).to(dt)
    qkv = _mm(xn, wqkv).to(dt)
    q, k, v = (t.reshape(B, L, heads, d).transpose(1, 2) for t in qkv.split(C, dim=-1))
    s = _mm(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(d))  # [B, H, L, L] f32
    p = torch.exp(s - s.amax(-1, keepdim=True))
    denom = p.sum(-1, keepdim=True)
    attn = (_mm(p.to(dt), v) / denom).to(dt)
    attn = attn.transpose(1, 2).reshape(B, L, C)
    y = _mm(attn, wproj).to(dt) + bproj.to(dt)
    x1 = x0 + y * dp[:, None, 0:1].to(dt)
    xn2 = ln_f32(x1.float(), ln2s, ln2b).to(dt)
    h1 = gelu_tanh(_mm(xn2, wfc1) + bfc1).to(dt)
    y2 = _mm(h1, wfc2).to(dt) + bfc2.to(dt)
    return x1 + y2 * dp[:, None, 1:2].to(dt)


def readout_plain(x2: torch.Tensor, lnfs, lnfb) -> torch.Tensor:
    """Final f32 LayerNorm + [cls, max over point tokens] -> [B, 8, C] f32."""
    xn = ln_f32(x2.float(), lnfs, lnfb)
    B, _, C = xn.shape
    out = torch.zeros(B, 8, C, dtype=torch.float32, device=xn.device)
    out[:, 0] = xn[:, 0]
    out[:, 1] = xn[:, 1:].amax(1)
    return out


def vit_block_readout_plain(
    x, pos, dp, ln1s, ln1b, wqkv, wproj, bproj, ln2s, ln2b, wfc1, bfc1, wfc2, bfc2,
    lnfs, lnfb, heads,
) -> torch.Tensor:
    x2 = vit_block_plain(
        x, pos, dp, ln1s, ln1b, wqkv, wproj, bproj, ln2s, ln2b, wfc1, bfc1, wfc2, bfc2, heads
    )
    return readout_plain(x2, lnfs, lnfb)


def vit_tower_plain(
    x, pos, dp, ln1s, ln1b, wqkv, wproj, bproj, ln2s, ln2b, wfc1, bfc1, wfc2, bfc2,
    lnfs, lnfb, heads,
) -> torch.Tensor:
    """``_vit_tower_twin``: ``depth`` plain blocks on the stacked weights
    (leading depth axis), dp ``[B, depth, 2]``, then the readout ->
    ``[B, 8, C]`` f32."""
    for i in range(wqkv.shape[0]):
        x = vit_block_plain(x, pos, dp[:, i], ln1s[i], ln1b[i], wqkv[i], wproj[i], bproj[i],
                            ln2s[i], ln2b[i], wfc1[i], bfc1[i], wfc2[i], bfc2[i], heads)
    return readout_plain(x, lnfs, lnfb)


def _check_shapes(name, dt, B, L, C, heads, hid):
    if C % heads or C > 1024:
        raise ValueError(f"{name}: C={C} must split into {heads} heads and be <= 1024")
    d = C // heads
    if dt == torch.bfloat16:  # tensor-core tiles
        if d not in (16, 32, 64, 128) or C % 32 or hid % 32:
            raise ValueError(f"{name}: bf16 needs head dim 16, 32, 64 or 128 (got {d}) and C, "
                             f"hidden ({C}, {hid}) multiples of 32")
    else:
        if d % 8 or d > 128:
            raise ValueError(f"{name}: head dim {d} must be a multiple of 8 and <= 128")
        if 4 * (32 * d + 64 * (d + 1) + 32 * L + 32) > 227 * 1024:
            raise ValueError(f"{name}: L={L} too long for whole-row attention tiles")


def check_tma(name: str, **tensors: torch.Tensor) -> None:
    """The bf16 GEMMs load their weights by TMA, which needs 16-byte aligned
    bases and rows a multiple of 16 bytes: refuse by name what the C call
    could not load. (Activations reach TMA only through the workspace this
    module allocates; x and pos are read by plain loads.)"""
    for key, t in tensors.items():
        if t.dtype != torch.bfloat16:
            continue
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: TMA needs 16-byte aligned bases; {key} is not")
        if t.shape[-1] * t.element_size() % 16:
            raise ValueError(f"{name}: TMA needs rows a multiple of 16 bytes; {key} has "
                             f"{t.shape[-1]} bf16 elements a row")


def block_operands(name, x, pos, dp, weights, heads):
    """The arguments of a block's launch sequence, checked and cast as the
    kernels take them: x, pos, dp, then the eleven weights in the order
    of the C entry points (ln1s, ln1b, wqkv, wproj, bproj, ln2s, ln2b,
    wfc1, bfc1, wfc2, bfc2), and the intermediates' buffers by name (x0,
    xn, qkv, attn, x1, h1, out; [B * L, width] in x's dtype)."""
    B, L, C = x.shape
    dt = x.dtype
    ln1s, ln1b, wqkv, wproj, bproj, ln2s, ln2b, wfc1, bfc1, wfc2, bfc2 = weights
    hid = wfc1.shape[1]
    _check_shapes(name, dt, B, L, C, heads, hid)
    wq, wp, w1, w2 = (w.to(dt).contiguous() for w in (wqkv, wproj, wfc1, wfc2))
    f = [t.float().contiguous() for t in (ln1s, ln1b, bproj, ln2s, ln2b, bfc1, bfc2)]
    args = [x.contiguous(), pos.to(dt).contiguous(), dp.float().contiguous(),
            f[0], f[1], wq, wp, f[2], f[3], f[4], w1, f[5], w2, f[6]]
    check_tma(name, wqkv=wq, wproj=wp, wfc1=w1, wfc2=w2)
    _build.check_tensors(name, *args)
    widths = dict(x0=C, xn=C, qkv=3 * C, attn=C, x1=C, h1=hid, out=C)
    bufs = {k: torch.empty(B * L, n, dtype=dt, device=x.device) for k, n in widths.items()}
    return args, bufs


def _launch(x, pos, dp, weights, lnf, heads, name, scratch=None):
    """One block launch. ``scratch``: a dict that receives the block's
    intermediates by name (x0, xn, qkv, attn, x1, h1), for a check that
    reads them."""
    B, L, C = x.shape
    code = _build.dtype_code(name, x.dtype)
    args, bufs = block_operands(name, x, pos, dp, weights, heads)
    readout = lnf is not None
    # without the readout the kernel never reads lnf; any f32 [C] pointers do
    lnf = [t.float().contiguous() for t in lnf] if readout else args[3:5]
    _build.check_tensors(name, args[0], *lnf)
    if scratch is not None:
        scratch.update((k, v) for k, v in bufs.items() if k != "out")
    ro = torch.empty(B, 8, C, dtype=torch.float32, device=x.device) if readout else None
    lib = _build.load("vitblock")
    lib.ppt_vit_block.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 22
    )
    p = _build.ptr
    rc = lib.ppt_vit_block(
        code, *map(p, args[:3]), B, L, C, heads, weights[7].shape[1], *map(p, args[3:]),
        *map(p, lnf), *map(p, bufs.values()),
        ctypes.c_void_p(ro.data_ptr() if ro is not None else None), _build.stream_ptr(x),
    )
    _build.check(lib, rc, name)
    _build.LAUNCHES[name] += 1
    return ro if ro is not None else bufs["out"].reshape(B, L, C)


def _block_cuda(
    x, pos, dp, ln1s, ln1b, wqkv, wproj, bproj, ln2s, ln2b, wfc1, bfc1, wfc2, bfc2, heads
) -> torch.Tensor:
    """``ppt::fused_vit_block`` on the card."""
    weights = (ln1s, ln1b, wqkv, wproj, bproj, ln2s, ln2b, wfc1, bfc1, wfc2, bfc2)
    return _launch(x, pos, dp, weights, None, heads, "fused_vit_block")


def _block_readout_cuda(
    x, pos, dp, ln1s, ln1b, wqkv, wproj, bproj, ln2s, ln2b, wfc1, bfc1, wfc2, bfc2,
    lnfs, lnfb, heads,
) -> torch.Tensor:
    """``ppt::fused_vit_block_readout`` on the card."""
    weights = (ln1s, ln1b, wqkv, wproj, bproj, ln2s, ln2b, wfc1, bfc1, wfc2, bfc2)
    return _launch(x, pos, dp, weights, (lnfs, lnfb), heads, "fused_vit_block_readout")


def _block_fake(x, *args) -> torch.Tensor:
    return x.new_empty(x.shape)


def _block_readout_fake(x, *args) -> torch.Tensor:
    return x.new_empty(x.shape[0], 8, x.shape[2], dtype=torch.float32)


def _block_flops(x, pos, dp, ln1s, ln1b, wqkv, wproj, bproj, ln2s, ln2b, wfc1, *args) -> int:
    """A block's products, 2 a multiply-add: qkv, proj, the MLP, and the
    attention's two [L, L] products."""
    B, L, C = x
    return 2 * B * L * (C * wqkv[1] + C * C + 2 * C * wfc1[1]) + 4 * B * L * L * C


def _block_readout_flops(x, *args) -> int:
    """The block's, and the readout's LayerNorm at 8 operations an element."""
    return _block_flops(x, *args) + 8 * x[0] * x[1] * x[2]


_BLOCK_ARGS = ("Tensor x, Tensor pos, Tensor dp, Tensor ln1s, Tensor ln1b, Tensor wqkv, "
               "Tensor wproj, Tensor bproj, Tensor ln2s, Tensor ln2b, Tensor wfc1, Tensor bfc1, "
               "Tensor wfc2, Tensor bfc2")
_block_run = _ops.register(f"fused_vit_block({_BLOCK_ARGS}, int heads) -> Tensor",
                           vit_block_plain, _block_cuda, _block_fake, _block_flops)
_block_readout_run = _ops.register(
    f"fused_vit_block_readout({_BLOCK_ARGS}, Tensor lnfs, Tensor lnfb, int heads) -> Tensor",
    vit_block_readout_plain, _block_readout_cuda, _block_readout_fake, _block_readout_flops)


def fused_vit_block(
    x, pos, dp, ln1s, ln1b, wqkv, wproj, bproj, ln2s, ln2b, wfc1, bfc1, wfc2, bfc2, heads
) -> torch.Tensor:
    """One whole ViT block: [B, L, C] -> [B, L, C] in x's dtype.
    Differentiable: the backward recomputes ``vit_block_plain``."""
    return recompute_grad("fused_vit_block", _block_run, vit_block_plain, x, pos, dp, ln1s, ln1b,
                          wqkv, wproj, bproj, ln2s, ln2b, wfc1, bfc1, wfc2, bfc2, heads)


def fused_vit_block_readout(
    x, pos, dp, ln1s, ln1b, wqkv, wproj, bproj, ln2s, ln2b, wfc1, bfc1, wfc2, bfc2,
    lnfs, lnfb, heads,
) -> torch.Tensor:
    """Last block + trunk readout: [B, L, C] -> [B, 8, C] f32.
    Differentiable: the backward recomputes ``vit_block_readout_plain``."""
    return recompute_grad("fused_vit_block_readout", _block_readout_run, vit_block_readout_plain,
                          x, pos, dp, ln1s, ln1b, wqkv, wproj, bproj, ln2s, ln2b, wfc1, bfc1,
                          wfc2, bfc2, lnfs, lnfb, heads)


def _tower_cuda(
    x, pos, dp, ln1s, ln1b, wqkv, wproj, bproj, ln2s, ln2b, wfc1, bfc1, wfc2, bfc2,
    lnfs, lnfb, heads,
) -> torch.Tensor:
    """``ppt::fused_vit_tower`` on the card: one C entry point walks the
    block's launches over the depth."""
    name = "fused_vit_tower"
    B, L, C = x.shape
    dt = x.dtype
    code = _build.dtype_code(name, dt)
    depth, hid = wfc1.shape[0], wfc1.shape[2]
    if depth < 1 or tuple(dp.shape) != (B, depth, 2):
        raise ValueError(f"{name}: dp {tuple(dp.shape)} must be [B, depth, 2] = "
                         f"[{B}, {depth}, 2]")
    _check_shapes(name, dt, B, L, C, heads, hid)
    x = x.contiguous()
    pos = pos.to(dt).contiguous()
    dp_t = dp.float().transpose(0, 1).contiguous()  # [depth, B, 2]: one [B, 2] slab per block
    mats = [w.to(dt).contiguous() for w in (wqkv, wproj, wfc1, wfc2)]
    f32 = [t.float().contiguous() for t in (ln1s, ln1b, bproj, ln2s, ln2b, bfc1, bfc2, lnfs,
                                            lnfb)]
    check_tma(name, **dict(zip(("wqkv", "wproj", "wfc1", "wfc2"), mats)))
    _build.check_tensors(name, x, pos, dp_t, *mats, *f32)
    rows = B * L
    ws = torch.empty(rows * (9 * C + hid), dtype=dt, device=x.device)
    ro = torch.empty(B, 8, C, dtype=torch.float32, device=x.device)
    lib = _build.load("vitblock")
    lib.ppt_vit_tower.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 16
    )
    p = _build.ptr
    rc = lib.ppt_vit_tower(
        code, p(x), p(pos), p(dp_t), B, L, C, heads, hid, depth,
        p(f32[0]), p(f32[1]), p(mats[0]), p(mats[1]), p(f32[2]), p(f32[3]), p(f32[4]),
        p(mats[2]), p(f32[5]), p(mats[3]), p(f32[6]), p(f32[7]), p(f32[8]),
        p(ws), p(ro), _build.stream_ptr(x),
    )
    _build.check(lib, rc, name)
    _build.LAUNCHES[name] += 1
    return ro


def _tower_fake(x, *args) -> torch.Tensor:
    return x.new_empty(x.shape[0], 8, x.shape[2], dtype=torch.float32)


def _tower_flops(x, pos, dp, ln1s, ln1b, wqkv, wproj, bproj, ln2s, ln2b, wfc1, *args) -> int:
    """``vit_tower_plain``'s products as ``FlopCounterMode`` counts them:
    ``depth`` blocks' (the readout's LayerNorm is not a product)."""
    return wqkv[0] * _block_flops(x, pos, dp, ln1s, ln1b, wqkv[1:], wproj, bproj, ln2s, ln2b,
                                  wfc1[1:])


_tower_run = _ops.register(
    f"fused_vit_tower({_BLOCK_ARGS}, Tensor lnfs, Tensor lnfb, int heads) -> Tensor",
    vit_tower_plain, _tower_cuda, _tower_fake, _tower_flops)


def fused_vit_tower(
    x, pos, dp, ln1s, ln1b, wqkv, wproj, bproj, ln2s, ln2b, wfc1, bfc1, wfc2, bfc2,
    lnfs, lnfb, heads,
) -> torch.Tensor:
    """The whole trunk + readout: x/pos [B, L, C], dp [B, depth, 2] f32,
    weights stacked with a leading depth axis -> [B, 8, C] f32.
    Differentiable: the backward recomputes ``vit_tower_plain``."""
    return recompute_grad("fused_vit_tower", _tower_run, vit_tower_plain, x, pos, dp, ln1s, ln1b,
                          wqkv, wproj, bproj, ln2s, ln2b, wfc1, bfc1, wfc2, bfc2, lnfs, lnfb,
                          heads)
