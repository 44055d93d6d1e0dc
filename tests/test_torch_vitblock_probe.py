"""Port vs reference: the ViT-block ablation probe
(``ppt_torch/tools/vitblock_probe.py`` against
``ppt_tpu/tools/vitblock_probe.py``).

``variant_block`` on CPU tensors (its plain version) in every mode, and
with two clouds per instance, against the reference's ``_variant_pallas``
in interpret mode at B=2, L=17, C=96 (the probe's 6 heads, so d=16), with
DropPath scales holding a 0 and a 2. Tolerances as
``tests/test_torch_vitblock.py`` states them: f32 1e-5 relative to the
output's scale (same arithmetic, summation order only), bf16 2e-2 (both
sides round qkv, P, attn, y, h1, y2 and each residual to bf16; an f32
summation order that differs can move one rounding by one step). Mode
``full`` is the production block: bit-equal to the port's
``fused_vit_block``. ``main`` times every mode, at shapes shrunk through
the module's constants.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppt_tpu.tools.vitblock_probe import _variant_pallas
from ppt_torch.kernels.vitblock import fused_vit_block
from ppt_torch.tools import vitblock_probe as probe

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
B, L, C = 2, 17, 96
MATS = {2, 3, 7, 9}  # wqkv, wproj, wfc1, wfc2: in the compute dtype


def _inputs(jdt, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s, sc=0.1: (rng.randn(*s) * sc).astype(np.float32)  # noqa: E731
    x, pos = f(B, L, C, sc=1.0), f(B, L, C, sc=1.0)
    dp = np.array([[1.0, 1.0], [0.0, 2.0]], np.float32)
    weights = [1 + f(C), f(C), f(C, 3 * C), f(C, C), f(C), 1 + f(C), f(C),
               f(C, 4 * C), f(4 * C), f(4 * C, C), f(C)]
    tdt = torch.bfloat16 if jdt == jnp.bfloat16 else torch.float32
    j = [jnp.asarray(x, jdt), jnp.asarray(pos, jdt), jnp.asarray(dp)]
    j += [jnp.asarray(w, jdt) if i in MATS else jnp.asarray(w) for i, w in enumerate(weights)]
    t = [torch.from_numpy(x).to(tdt), torch.from_numpy(pos).to(tdt), torch.from_numpy(dp)]
    t += [torch.from_numpy(w).to(tdt) if i in MATS else torch.from_numpy(w)
          for i, w in enumerate(weights)]
    return j, t


def _close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(float(np.max(np.abs(want))), 1.0)
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * scale, err / scale


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mode,rows", [("full", 1), ("mm_only", 1), ("no_softmax", 1),
                                       ("no_gelu", 1), ("pv_ones", 1), ("qk_packed2", 1),
                                       ("full", 2)])
def test_variant_matches_the_reference_probe(mode, rows, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    j, t = _inputs(jdt, seed=len(mode) + rows)
    want = _variant_pallas(*j, mode=mode, rows=rows, interpret=True)
    got = probe.variant_block(*t, mode=mode, rows=rows)
    assert got.dtype == tdt and tuple(got.shape) == (B, L, C)
    assert torch.isfinite(got.float()).all()
    _close(got.float().numpy(), want, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_full_is_the_production_block(dtype):
    _, t = _inputs(DTYPES[dtype][0], seed=5)
    want = fused_vit_block(*t, probe.HEADS)
    assert torch.equal(probe.variant_block(*t, mode="full"), want)
    assert torch.equal(probe.variant_block(*t, mode="full", rows=2), want)


def test_unknown_mode_is_refused():
    _, t = _inputs(jnp.float32)
    with pytest.raises(ValueError, match="vit_variant: mode 'rows2'"):
        probe.variant_block(*t, mode="rows2")


def test_main_times_every_mode(monkeypatch):
    for name, value in (("B", 2), ("L", 17), ("C", 96), ("DEPTH", 2)):
        monkeypatch.setattr(probe, name, value)
    modes = "full,mm_only,no_softmax,no_gelu,pv_ones,rows2,qk_packed2,prod"
    results = probe.main(["--device", "cpu", "--iters", "1", "--modes", modes])
    assert sorted(results) == sorted(modes.split(","))
    assert all(np.isfinite(v) for v in results.values())
