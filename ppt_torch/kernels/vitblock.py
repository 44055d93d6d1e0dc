"""PointBERT ViT block (and block + trunk readout) on hand-written kernels.

Replaces ``ppt_tpu/kernels/vitblock.py:fused_vit_block`` and
``:fused_vit_block_readout``; the CUDA side is ``csrc/vitblock.cu``,
whose header says what bounds it on the H100 and how its design answers
that.

Semantics (``vitblock.py:66-125``), in the compute dtype of ``x`` with
f32 accumulation: x0 = x + pos; LN1 with f32 statistics (fast variance,
eps 1e-6); qkv; whole-row softmax attention with an f32 softmax, P cast
to dtype before P@V and the f32 accumulator divided by the f32
denominator; proj; droppath-scaled residual; LN2; MLP with tanh-GELU;
residual. The readout variant adds the final f32 LayerNorm and returns
``[B, 8, C]`` f32 rows: row 0 the normalised cls token, row 1 the
lanewise max over the point tokens, rows 2..7 zero.

Neither kernel has a backward kernel in the reference
(``vitblock.py:398-400``, ``:551-553``); both public functions carry the
gradient of their plain version (``_autograd.py``), which is what trains
``block_11`` under head types 1 to 3.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ppt_torch.kernels import _build
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


def _launch(x, pos, dp, weights, lnf, heads, name):
    B, L, C = x.shape
    if C % heads or C > 1024:
        raise ValueError(f"{name}: C={C} must split into {heads} heads and be <= 1024")
    d = C // heads
    dt = x.dtype
    code = _build.dtype_code(name, dt)
    ln1s, ln1b, wqkv, wproj, bproj, ln2s, ln2b, wfc1, bfc1, wfc2, bfc2 = weights
    hid = wfc1.shape[1]
    if dt == torch.bfloat16:  # tensor-core tiles
        if d not in (32, 64, 128) or C % 32 or hid % 32:
            raise ValueError(f"{name}: bf16 needs head dim 32, 64 or 128 (got {d}) and C, "
                             f"hidden ({C}, {hid}) multiples of 32")
    else:
        if d % 8 or d > 128:
            raise ValueError(f"{name}: head dim {d} must be a multiple of 8 and <= 128")
        if 4 * (32 * d + 64 * (d + 1) + 32 * L + 32) > 227 * 1024:
            raise ValueError(f"{name}: L={L} too long for whole-row attention tiles")
    x = x.contiguous()
    pos = pos.to(dt).contiguous()
    dp = dp.float().contiguous()
    wq, wp, w1, w2 = (w.to(dt).contiguous() for w in (wqkv, wproj, wfc1, wfc2))
    f32 = [t.float().contiguous() for t in (ln1s, ln1b, bproj, ln2s, ln2b, bfc1, bfc2)]
    readout = lnf is not None
    # without the readout the kernel never reads lnf; any f32 [C] pointers do
    lnf = [t.float().contiguous() for t in lnf] if readout else f32[:2]
    _build.check_tensors(name, x, pos, dp, wq, wp, w1, w2, *f32, *lnf)
    rows = B * L

    def buf(n):
        return torch.empty(rows, n, dtype=dt, device=x.device)

    x0, xn, qkv, attn, x1, h1, out = buf(C), buf(C), buf(3 * C), buf(C), buf(C), buf(hid), buf(C)
    ro = torch.empty(B, 8, C, dtype=torch.float32, device=x.device) if readout else None
    lib = _build.load("vitblock")
    lib.ppt_vit_block.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 22
    )
    p = _build.ptr
    rc = lib.ppt_vit_block(
        code, p(x), p(pos), p(dp), B, L, C, heads, hid,
        p(f32[0]), p(f32[1]), p(wq), p(wp), p(f32[2]), p(f32[3]), p(f32[4]),
        p(w1), p(f32[5]), p(w2), p(f32[6]), p(lnf[0]), p(lnf[1]),
        p(x0), p(xn), p(qkv), p(attn), p(x1), p(h1), p(out),
        ctypes.c_void_p(ro.data_ptr() if ro is not None else None), _build.stream_ptr(x),
    )
    _build.check(lib, rc, name)
    _build.LAUNCHES[name] += 1
    return ro if ro is not None else out.reshape(B, L, C)


def _block_run(
    x, pos, dp, ln1s, ln1b, wqkv, wproj, bproj, ln2s, ln2b, wfc1, bfc1, wfc2, bfc2, heads
) -> torch.Tensor:
    weights = (ln1s, ln1b, wqkv, wproj, bproj, ln2s, ln2b, wfc1, bfc1, wfc2, bfc2)
    if x.device.type == "cpu":
        return vit_block_plain(x, pos, dp, *weights, heads)
    return _launch(x, pos, dp, weights, None, heads, "fused_vit_block")


def _block_readout_run(
    x, pos, dp, ln1s, ln1b, wqkv, wproj, bproj, ln2s, ln2b, wfc1, bfc1, wfc2, bfc2,
    lnfs, lnfb, heads,
) -> torch.Tensor:
    weights = (ln1s, ln1b, wqkv, wproj, bproj, ln2s, ln2b, wfc1, bfc1, wfc2, bfc2)
    if x.device.type == "cpu":
        return vit_block_readout_plain(x, pos, dp, *weights, lnfs, lnfb, heads)
    return _launch(x, pos, dp, weights, (lnfs, lnfb), heads, "fused_vit_block_readout")


def fused_vit_block(
    x, pos, dp, ln1s, ln1b, wqkv, wproj, bproj, ln2s, ln2b, wfc1, bfc1, wfc2, bfc2, heads
) -> torch.Tensor:
    """One whole ViT block: [B, L, C] -> [B, L, C] in x's dtype.
    Differentiable: the backward recomputes ``vit_block_plain``."""
    return recompute_grad(_block_run, vit_block_plain, x, pos, dp, ln1s, ln1b, wqkv, wproj,
                          bproj, ln2s, ln2b, wfc1, bfc1, wfc2, bfc2, heads)


def fused_vit_block_readout(
    x, pos, dp, ln1s, ln1b, wqkv, wproj, bproj, ln2s, ln2b, wfc1, bfc1, wfc2, bfc2,
    lnfs, lnfb, heads,
) -> torch.Tensor:
    """Last block + trunk readout: [B, L, C] -> [B, 8, C] f32.
    Differentiable: the backward recomputes ``vit_block_readout_plain``."""
    return recompute_grad(_block_readout_run, vit_block_readout_plain, x, pos, dp, ln1s, ln1b,
                          wqkv, wproj, bproj, ln2s, ln2b, wfc1, bfc1, wfc2, bfc2, lnfs, lnfb,
                          heads)
