"""What each component of the ViT block costs on the card: the block's
kernels with one component taken out or replaced.

Counterpart of ``ppt_tpu/tools/vitblock_probe.py``. Runs the production
block (``fused_vit_block``) beside copies of its launch sequence that each
drop one component, at the flagship shape (B32, L513, C384, 6 heads, 12
blocks, bf16), and prints the net ms of a 12-block step for each, so the
block's time is attributed to its components:

  full        the production launch sequence (baseline)
  mm_only     GEMMs and residuals only: no LayerNorm, raw-score attention
              (no max, exp, sum or divide), no GELU; the products' envelope,
              the 64-deep QK / PV products included
  no_softmax  full minus the softmax chain: the difference to ``full``
              prices max / exp / sum / divide
  no_gelu     GELU replaced by the identity: prices GELU
  pv_ones     the softmax denominator from a ones column appended to V in
              the P @ V product, in place of the f32 sum
  rows2       two clouds per block of the attention and LayerNorm launches:
              prices the per-block overhead
  qk_packed2  two heads per product: Q of the pair against a block-diagonal
              K (depth 2d) and P against a block-diagonal V (2d wide):
              twice the products, the same sums (on request)
  prod        ``kernels/vitblock.py:fused_vit_block`` itself (on request)

The kernel is ``csrc/vitblock.cu:ppt_vit_variant`` (its attention modes in
``csrc/attention.cuh``); :func:`variant_block` is its wrapper,
:func:`variant_block_plain` the plain PyTorch version of every mode.

Timing: a chain of ``--iters`` x 12 blocks with a renormalisation after
each 12, timed with CUDA events, best of 3, less the chain of the
renormalisations alone; per 12-block step. Runs on the card unless
``--device cpu`` is given (a CPU time is no device number).

    python -m ppt_torch.tools.vitblock_probe [--iters 8] \
        [--modes full,mm_only,no_softmax,no_gelu,pv_ones,rows2,qk_packed2,prod]
"""

from __future__ import annotations

import argparse
import ctypes
import math
import time

import numpy as np
import torch

from ppt_torch.kernels import _build, _ops
from ppt_torch.kernels import vitblock as kvit
from ppt_torch.utils.device import resolve_device

B, L, C, HEADS, DEPTH = 32, 513, 384, 6, 12
MODES = ("full", "mm_only", "no_softmax", "no_gelu", "pv_ones", "qk_packed2")
DEFAULT_MODES = "full,mm_only,no_softmax,no_gelu,pv_ones,rows2"
_MODE_CODE = {m: i for i, m in enumerate(MODES)}  # csrc/vitblock.cu: VAR_*


def _heads_attention(q, k, v, mode, dt):
    """One mode's attention on [B, H, L, d] heads -> [B, H, L, d] in dt."""
    d = q.shape[-1]
    s = kvit._mm(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(d))  # f32
    if mode in ("mm_only", "no_softmax"):  # the raw scores are P
        return kvit._mm(s.to(dt), v).to(dt)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    if mode == "pv_ones":  # the denominator: the rounded P against a ones column
        pr = p.to(dt)
        return (kvit._mm(pr, v) / pr.float().sum(-1, keepdim=True)).to(dt)
    return (kvit._mm(p.to(dt), v) / p.sum(-1, keepdim=True)).to(dt)


def _packed2_attention(q, k, v, dt):
    """Head pairs: [q1 | q2] against block-diagonal K and V, as written out
    in ``vitblock_probe.py:86-127``."""
    Bx, H, Lx, d = q.shape
    pair = lambda t: t.reshape(Bx, H // 2, 2, Lx, d)  # noqa: E731
    q2, k2, v2 = pair(q), pair(k), pair(v)
    z = torch.zeros(Bx, H // 2, Lx, d, dtype=dt, device=q.device)
    q12 = torch.cat([q2[:, :, 0], q2[:, :, 1]], -1)                       # [B, P, L, 2d]
    k_bd = torch.cat([torch.cat([k2[:, :, 0], z], -1),
                      torch.cat([z, k2[:, :, 1]], -1)], -2)               # [B, P, 2L, 2d]
    v_bd = torch.cat([torch.cat([v2[:, :, 0], z], -1),
                      torch.cat([z, v2[:, :, 1]], -1)], -2)
    s2 = kvit._mm(q12, k_bd.transpose(-1, -2)) * (1.0 / math.sqrt(d))    # [B, P, L, 2L]
    s_a, s_b = s2[..., :Lx], s2[..., Lx:]
    p_a = torch.exp(s_a - s_a.amax(-1, keepdim=True))
    p_b = torch.exp(s_b - s_b.amax(-1, keepdim=True))
    acc2 = kvit._mm(torch.cat([p_a, p_b], -1).to(dt), v_bd)              # [B, P, L, 2d]
    o_a = (acc2[..., :d] / p_a.sum(-1, keepdim=True)).to(dt)
    o_b = (acc2[..., d:] / p_b.sum(-1, keepdim=True)).to(dt)
    return torch.stack([o_a, o_b], 2).reshape(Bx, H, Lx, d)


def variant_block_plain(x, pos, dp, ln1s, ln1b, wqkv, wproj, bproj, ln2s, ln2b, wfc1, bfc1,
                        wfc2, bfc2, *, mode: str, rows: int = 1) -> torch.Tensor:
    """Plain PyTorch version of every mode (``_variant_kernel``'s
    semantics, ``HEADS`` heads); ``rows`` changes no value."""
    if mode not in MODES:
        raise ValueError(f"vit_variant: mode {mode!r} not in {MODES}")
    if mode == "full":
        return kvit.vit_block_plain(x, pos, dp, ln1s, ln1b, wqkv, wproj, bproj, ln2s, ln2b,
                                    wfc1, bfc1, wfc2, bfc2, HEADS)
    Bx, Lx, Cx = x.shape
    d = Cx // HEADS
    dt = x.dtype
    x0 = x + pos.to(dt)
    ln = mode != "mm_only"
    xn = kvit.ln_f32(x0.float(), ln1s, ln1b).to(dt) if ln else x0
    qkv = kvit._mm(xn, wqkv).to(dt)
    q, k, v = (t.reshape(Bx, Lx, HEADS, d).transpose(1, 2) for t in qkv.split(Cx, dim=-1))
    if mode == "qk_packed2":
        attn = _packed2_attention(q, k, v, dt)
    else:
        attn = _heads_attention(q, k, v, mode, dt)
    attn = attn.transpose(1, 2).reshape(Bx, Lx, Cx)
    y = kvit._mm(attn, wproj).to(dt) + bproj.to(dt)
    x1 = x0 + y * dp[:, None, 0:1].to(dt)
    xn2 = kvit.ln_f32(x1.float(), ln2s, ln2b).to(dt) if ln else x1
    h1 = kvit._mm(xn2, wfc1) + bfc1
    h1 = (h1 if mode in ("mm_only", "no_gelu") else kvit.gelu_tanh(h1)).to(dt)
    y2 = kvit._mm(h1, wfc2).to(dt) + bfc2.to(dt)
    return x1 + y2 * dp[:, None, 1:2].to(dt)


def _check_variant(dt, Bx, Lx, Cx, hid, mode, rows):
    name = "vit_variant"
    if mode not in MODES:
        raise ValueError(f"{name}: mode {mode!r} not in {MODES}")
    if rows not in (1, 2) or Bx % rows:
        raise ValueError(f"{name}: rows={rows} must be 1 or 2 and divide B={Bx}")
    kvit._check_shapes(name, dt, Bx, Lx, Cx, HEADS, hid)
    if mode == "qk_packed2":
        d2 = 2 * (Cx // HEADS)
        if HEADS % 2 or d2 > 128:
            raise ValueError(f"{name}: qk_packed2 needs an even head count and 2 x head dim "
                             f"<= 128 (got {HEADS} heads of {Cx // HEADS})")
        if dt == torch.float32 and 4 * (32 * d2 + 64 * (d2 + 1) + 64 * Lx + 64) > 227 * 1024:
            raise ValueError(f"{name}: L={Lx} too long for qk_packed2's whole-row tiles")


def _variant_cuda(x, pos, dp, ln1s, ln1b, wqkv, wproj, bproj, ln2s, ln2b, wfc1, bfc1, wfc2,
                  bfc2, mode: str, rows: int) -> torch.Tensor:
    """``ppt::vit_variant`` on the card: ``csrc/vitblock.cu:ppt_vit_variant``."""
    w = (ln1s, ln1b, wqkv, wproj, bproj, ln2s, ln2b, wfc1, bfc1, wfc2, bfc2)
    name = "vit_variant"
    Bx, Lx, Cx = x.shape
    code = _build.dtype_code(name, x.dtype)
    hid = wfc1.shape[1]
    _check_variant(x.dtype, Bx, Lx, Cx, hid, mode, rows)
    args, bufs = kvit.block_operands(name, x, pos, dp, w, HEADS)
    lib = _build.load("vitblock")
    lib.ppt_vit_variant.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 19
    )
    p = _build.ptr
    rc = lib.ppt_vit_variant(
        code, _MODE_CODE[mode], rows, *map(p, args[:3]), Bx, Lx, Cx, HEADS, hid,
        *map(p, args[3:]), *map(p, bufs.values()), _build.stream_ptr(x),
    )
    _build.check(lib, rc, name)
    _build.LAUNCHES[name] += 1
    return bufs["out"].reshape(Bx, Lx, Cx)


def _variant_plain(*args) -> torch.Tensor:
    """``ppt::vit_variant`` on the CPU (its mode and rows last)."""
    return variant_block_plain(*args[:-2], mode=args[-2], rows=args[-1])


def _variant_fake(x, *args) -> torch.Tensor:
    return x.new_empty(x.shape)


def _variant_flops(x, pos, dp, ln1s, ln1b, wqkv, wproj, bproj, ln2s, ln2b, wfc1, bfc1, wfc2,
                   bfc2, mode: str, rows: int) -> int:
    """``variant_block_plain``'s products as ``FlopCounterMode`` counts
    them: the block's in every mode, and in ``qk_packed2`` the attention's
    two products twice over (each head pair against block-diagonal K and
    V)."""
    Bx, Lx, Cx = x
    attention = 4 * Bx * Lx * Lx * Cx
    flops = kvit._block_flops(x, pos, dp, ln1s, ln1b, wqkv, wproj, bproj, ln2s, ln2b, wfc1)
    return flops + (attention if mode == "qk_packed2" else 0)


_variant_op = _ops.register(
    f"vit_variant({kvit._BLOCK_ARGS}, str mode, int rows) -> Tensor", _variant_plain,
    _variant_cuda, _variant_fake, _variant_flops)


def variant_block(x, pos, dp, ln1s, ln1b, wqkv, wproj, bproj, ln2s, ln2b, wfc1, bfc1, wfc2,
                  bfc2, *, mode: str, rows: int = 1) -> torch.Tensor:
    """One ViT block in ``mode``, [B, L, C] -> [B, L, C] in x's dtype
    (``torch.ops.ppt.vit_variant``): the kernels on the card, the plain
    version on the CPU."""
    return _variant_op(x, pos, dp, ln1s, ln1b, wqkv, wproj, bproj, ln2s, ln2b, wfc1, bfc1, wfc2,
                       bfc2, mode, rows)


def probe_inputs(device, dt=torch.bfloat16):
    """x, pos, dp and the ``DEPTH`` blocks' weights, from
    ``np.random.RandomState(0)`` in the reference tool's order (its
    ``:260-283``)."""
    rng = np.random.RandomState(0)
    hid = 4 * C

    def mk(*shape, scale=0.02):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(device, dt)

    def const(v, n):
        return torch.full((n,), v, dtype=torch.float32, device=device)

    x = mk(B, L, C, scale=1.0)
    pos = mk(B, L, C, scale=1.0)
    dp = torch.ones(B, 2, dtype=torch.float32, device=device)
    blocks = [(const(1.0, C), const(0.0, C), mk(C, 3 * C), mk(C, C), const(0.0, C),
               const(1.0, C), const(0.0, C), mk(C, hid), const(0.0, hid), mk(hid, C),
               const(0.0, C)) for _ in range(DEPTH)]
    return x, pos, dp, blocks


def _best_ms(fn, device) -> float:
    """Best of 3 runs of ``fn`` after a warm-up, in ms: CUDA events on the
    card, the host clock on the CPU."""
    fn()
    best = float("inf")
    for _ in range(3):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--modes", default=DEFAULT_MODES)
    ap.add_argument("--device", default=None, help="'cpu' runs the plain versions")
    flags = ap.parse_args(argv)
    device = resolve_device(flags.device)
    dt = torch.bfloat16
    x, pos, dp, blocks = probe_inputs(device, dt)

    def renorm(y):  # keeps the chain inside bf16's range
        return (y.float() / y.float().abs().max().clamp_min(1.0)).to(dt)

    def chain(body):
        y = x
        for _ in range(flags.iters):
            for w in blocks:
                y = body(y, w)
            y = renorm(y)
        return y.float().sum()

    def run_mode(mode):
        rows = 2 if mode == "rows2" else 1
        kmode = "full" if mode == "rows2" else mode
        if kmode == "prod":
            return _best_ms(lambda: chain(
                lambda y, w: kvit.fused_vit_block(y, pos, dp, *w, HEADS)), device)
        return _best_ms(lambda: chain(
            lambda y, w: variant_block(y, pos, dp, *w, mode=kmode, rows=rows)), device)

    with torch.no_grad():
        nil_ms = _best_ms(lambda: chain(lambda y, w: y), device)
        kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        print(f"# {kind}: B{B} L{L} C{C} h{HEADS} depth{DEPTH}, bf16, iters={flags.iters}, "
              f"renormalisation-only chain {nil_ms:.2f} ms (subtracted)", flush=True)
        results = {}
        base = None
        for mode in flags.modes.split(","):
            try:
                ms = (run_mode(mode) - nil_ms) / flags.iters
            except Exception as e:  # the reference tool reports a mode that fails and goes on
                print(f"{mode:>11}: FAILED — {type(e).__name__}: {str(e)[:160]}", flush=True)
                continue
            results[mode] = ms
            if mode == "full":
                base = ms
            delta = f"  ({ms - base:+.2f} vs full)" if base and mode != "full" else ""
            print(f"{mode:>11}: {ms:7.3f} ms / {DEPTH}-block step{delta}", flush=True)
    return results


if __name__ == "__main__":
    main()
