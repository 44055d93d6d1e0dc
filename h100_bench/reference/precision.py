"""The references' matrix products: float32, or fp8 for the control.

The configurations run in bfloat16, so the control is the same reference
with every product taken in the next precision below: both operands
rounded to float8 e4m3 with one scale a tensor (its absolute maximum
mapped to 448, as an fp8 GEMM's per-tensor scaling does), accumulated in
float32. The backward rounds the incoming gradient the same way.
"""

from __future__ import annotations

import contextlib

import torch

F8_MAX = 448.0


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, back in f32."""
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = F8_MAX / amax
    return (x.float() * scale).to(torch.float8_e4m3fn).float() / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = round_fp8(a), round_fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = round_fp8(g)
        ga = qg @ qb.transpose(-1, -2) if ctx.needs_input_grad[0] else None
        gb = qa.transpose(-1, -2) @ qg if ctx.needs_input_grad[1] else None
        return ga, gb


class Products:
    """``mm(a, b)``: ``a @ b`` in float32 ("f32") or fp8 ("fp8")."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r} not in ('f32', 'fp8')")
        self.precision = precision

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            return _Fp8Matmul.apply(a.float(), b.float())
        return a.float() @ b.float()


@contextlib.contextmanager
def exact_f32():
    """TF32 off for cuBLAS and cuDNN while the reference runs, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])
