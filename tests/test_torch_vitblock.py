"""Port vs reference: the fused ViT block and block + readout.

The port's plain block (what the wrapper runs on CPU tensors and what
the CUDA kernels are held to on the card) against ``_block_pallas`` /
``_block_readout_pallas`` in interpret mode, at L=33, C=64, 2 heads, and
the port's ``VitBlock`` module against the flax block with the fused
kernel forced (``PPT_FUSED_BLOCK=1``) and converted weights.

Tolerances: f32 1e-5 relative to the output's scale (same arithmetic,
summation order only). bf16 2e-2 relative: both sides round qkv, P,
attn, y, h1, y2 and each residual to bf16 (eps 7.8e-3); a summation
order that differs in f32 can move one of those roundings by one step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppt_tpu.kernels.vitblock import _block_pallas, _block_readout_pallas
from ppt_torch.convert import from_jax
from ppt_torch.kernels.vitblock import fused_vit_block, fused_vit_block_readout
from ppt_torch.nn.pointbert import VitBlock

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
B, L, C, H = 2, 33, 64, 2


def _args(rng):
    f = lambda *s, sc=0.1: (rng.randn(*s) * sc).astype(np.float32)
    x, pos = f(B, L, C, sc=1.0), f(B, L, C, sc=1.0)
    dp = np.array([[1.0, 1.0], [0.0, 2.0]], np.float32)
    weights = [1 + f(C), f(C), f(C, 3 * C), f(C, C), f(C), 1 + f(C), f(C),
               f(C, 4 * C), f(4 * C), f(4 * C, C), f(C)]
    return x, pos, dp, weights


def _split(x, pos, dp, weights, jdt):
    """(jax args, torch args): x/pos and the four matrices in the compute
    dtype, everything else f32 (the wrappers' contract)."""
    mats = {2, 3, 7, 9}
    j = [jnp.asarray(x, jdt), jnp.asarray(pos, jdt), jnp.asarray(dp)]
    j += [jnp.asarray(w, jdt) if i in mats else jnp.asarray(w) for i, w in enumerate(weights)]
    tdt = torch.bfloat16 if jdt == jnp.bfloat16 else torch.float32
    t = [torch.from_numpy(x).to(tdt), torch.from_numpy(pos).to(tdt), torch.from_numpy(dp)]
    t += [torch.from_numpy(w).to(tdt) if i in mats else torch.from_numpy(w)
          for i, w in enumerate(weights)]
    return j, t


def _close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(float(np.max(np.abs(want))), 1.0)
    assert np.max(np.abs(got - want)) <= tol * scale, np.max(np.abs(got - want)) / scale


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_block_plain_matches_pallas(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    j, t = _split(*_args(np.random.RandomState(0)), jdt)
    want = _block_pallas(*j, heads=H, interpret=True)
    got = fused_vit_block(*t, H)
    assert got.dtype == tdt and tuple(got.shape) == (B, L, C)
    _close(got.float().numpy(), want, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_block_readout_plain_matches_pallas(dtype):
    jdt, _, tol = DTYPES[dtype]
    rng = np.random.RandomState(1)
    j, t = _split(*_args(rng), jdt)
    lnf = [(1 + 0.1 * rng.randn(C)).astype(np.float32), (0.1 * rng.randn(C)).astype(np.float32)]
    want = _block_readout_pallas(*j, *map(jnp.asarray, lnf), heads=H, interpret=True)
    got = fused_vit_block_readout(*t, *map(torch.from_numpy, lnf), H)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, 8, C)
    _close(got.numpy(), want, tol)
    assert torch.all(got[:, 2:] == 0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_vitblock_module_matches_flax(dtype, monkeypatch):
    from ppt_tpu.nn.pointbert import VitBlock as JaxBlock

    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.RandomState(2)
    x = rng.randn(B, L, C).astype(np.float32)
    pos = rng.randn(B, L, C).astype(np.float32)
    jblock = JaxBlock(H, dtype=jdt)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(np.float32),
        jblock.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]))["params"])
    monkeypatch.setenv("PPT_FUSED_BLOCK", "1")
    want = jblock.apply({"params": params}, jnp.asarray(x, jdt), True, jnp.asarray(pos, jdt))

    tblock = VitBlock(C, H, dtype=tdt)
    tblock.load_state_dict(from_jax(params, {}, tblock))
    with torch.no_grad():
        got = tblock(torch.from_numpy(x).to(tdt), torch.from_numpy(pos).to(tdt),
                     torch.ones(B, 2))
    _close(got.float().numpy(), want, tol)


@pytest.mark.parametrize("dtype,C,heads,match", [
    (torch.bfloat16, 96, 2, "bf16 needs head dim"),  # head dim 48: no tensor-core variant
    (torch.bfloat16, 96, 4, "bf16 needs head dim"),  # head dim 24
    (torch.float32, 96, 5, "must split into"),
])
def test_block_kernel_path_rejects_what_it_does_not_take(dtype, C, heads, match):
    """A tensor off the CPU takes the kernel path, whose shape checks run
    before any build or launch (meta tensors carry shapes only)."""
    def m(*s, dt=torch.float32):
        return torch.empty(*s, dtype=dt, device="meta")

    x = m(1, 17, C, dt=dtype)
    weights = [m(C), m(C), m(C, 3 * C, dt=dtype), m(C, C, dt=dtype), m(C), m(C), m(C),
               m(C, 4 * C, dt=dtype), m(4 * C), m(4 * C, C, dt=dtype), m(C)]
    with pytest.raises(ValueError, match=match):
        fused_vit_block(x, x, m(1, 2), *weights, heads)
