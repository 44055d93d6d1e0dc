"""Port vs reference: the train-mode BN2 statistics (``mini_stats``).

``mini_stats_sweep_plain`` (the sweep the bf16 and f32 kernels are held to
on the card) is held against ``_stats_kernel`` itself, run through
``_stats_pallas``'s pallas_call in interpret mode: m2, the group sums and
the group maxes at the tolerances below.

``mini_stats_plain`` repeats ``_stats_pallas`` step by step, so it is
held against the Pallas kernel in interpret mode: f32 rel 1e-5 (same
algebra, f32 summation order only), bf16 rel 2e-2 (x2 is rounded to bf16
on both sides, eps 7.8e-3, and a different f32 summation order can flip
one rounding). Against ``_stats_twin``, which forms per-point h, f32 rel
1e-4: the closed form cancels terms the twin never forms. The gradient
of the port's function (recomputation of the plain version) against
``jax.grad`` of the twin, f32 rel 1e-4 of each gradient's max. All
relative to the output's max magnitude.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ppt_tpu.kernels.mini import _pick_gm_blk, _stats_kernel, _stats_pallas, _stats_twin, _wspecs
from ppt_torch.kernels.mini import (_mini_stats_cuda, mini_stats, mini_stats_plain,
                                    mini_stats_sweep_plain)

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
SHAPES = [(2, 8, 8), (1, 16, 32)]  # B, G, M
# the sweep: ragged (G not a multiple of the bf16 kernel's 4 groups a tile,
# M < 32) and one whole tile of 4 groups x 32 points
SWEEP_SHAPES = [(1, 7, 20), (2, 5, 12), (1, 4, 32)]


def _weights(rng):
    f = lambda *s, sc=0.1: (rng.randn(*s) * sc).astype(np.float32)
    # fw1, fb1, w2, b2, wg, wl, bsplit
    return [f(3, 128, sc=0.5), f(128), f(128, 256), f(256), f(256, 512), f(256, 512), f(512)]


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / max(float(np.max(np.abs(want))), 1e-30))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,G,M", SHAPES)
def test_mini_stats_plain_matches_pallas(dtype, B, G, M):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.RandomState(G * M)
    x = (rng.rand(B, G * M, 3) - 0.5).astype(np.float32)
    w = _weights(rng)
    got = mini_stats(M, tdt, torch.from_numpy(x), *map(torch.from_numpy, w))
    want = _stats_pallas(jnp.asarray(x), *map(jnp.asarray, w), m_size=M, dtype=jdt,
                         interpret=True)
    for g, t, name in zip(got, want, ("sum_h", "sumsq_h")):
        assert g.dtype == torch.float32 and tuple(g.shape) == (512,)
        assert _rel(g.numpy(), t) <= tol, (name, _rel(g.numpy(), t))


@pytest.mark.parametrize("B,G,M", SHAPES)
def test_mini_stats_plain_matches_twin_f32(B, G, M):
    rng = np.random.RandomState(B + M)
    x = (rng.rand(B, G * M, 3) - 0.5).astype(np.float32)
    w = _weights(rng)
    got = mini_stats_plain(M, torch.float32, torch.from_numpy(x), *map(torch.from_numpy, w))
    want = _stats_twin(jnp.asarray(x).reshape(-1, 3), M, *map(jnp.asarray, w), jnp.float32)
    for g, t in zip(got, want):
        assert _rel(g.numpy(), t) <= 1e-4, _rel(g.numpy(), t)


def test_mini_stats_gradient_matches_jax_grad_of_twin():
    B, G, M = 2, 8, 8
    rng = np.random.RandomState(5)
    x = (rng.rand(B, G * M, 3) - 0.5).astype(np.float32)
    w = _weights(rng)
    ca, cb = rng.randn(512).astype(np.float32), rng.randn(512).astype(np.float32)

    def jloss(*wj):
        s, ss = _stats_twin(jnp.asarray(x).reshape(-1, 3), M, *wj, jnp.float32)
        return jnp.sum(s * ca) + jnp.sum(ss * cb)

    want = jax.grad(jloss, argnums=tuple(range(7)))(*map(jnp.asarray, w))
    tw = [torch.from_numpy(t).requires_grad_(True) for t in w]
    s, ss = mini_stats(M, torch.float32, torch.from_numpy(x), *tw)
    assert s.requires_grad and ss.requires_grad
    (torch.sum(s * torch.from_numpy(ca)) + torch.sum(ss * torch.from_numpy(cb))).backward()
    for t, g in zip(tw, want):
        assert _rel(t.grad.numpy(), g) <= 1e-4, _rel(t.grad.numpy(), g)


def test_mini_stats_records_no_graph_for_frozen_inputs():
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.rand(1, 64, 3).astype(np.float32))
    s, ss = mini_stats(8, torch.float32, x, *map(torch.from_numpy, _weights(rng)))
    assert not s.requires_grad and s.grad_fn is None and ss.grad_fn is None


@pytest.mark.parametrize("M,shape,match", [(8, (128, 64), "PointBERT's widths"),
                                           (64, (128, 256), "M <= 32")])
def test_mini_stats_kernel_path_rejects_what_it_does_not_take(M, shape, match):
    """The kernel path (the op's CUDA implementation) runs its shape checks
    before any build or launch (meta tensors carry shapes only)."""
    c1, c2 = shape
    shapes = [(3, c1), (c1,), (c1, c2), (c2,), (c2, 512), (c2, 512), (512,)]
    w = [torch.empty(s, device="meta") for s in shapes]
    with pytest.raises(ValueError, match=match):
        _mini_stats_cuda(M, torch.bfloat16, torch.empty(1, 2 * M, 3, device="meta"), *w)


def _pallas_sweep(x, fw1, fb1, w2, b2, m_size, jdt):
    """(m2, sg, gmax) of ``_stats_kernel``, through the pallas_call that
    ``_stats_pallas`` makes (interpret mode), sg and gmax as [B*G, C2]."""
    B, GM, _ = x.shape
    G = GM // m_size
    gm_blk = _pick_gm_blk(G, m_size)
    g_blk, tiles, cs = gm_blk // m_size, GM // gm_blk, w2.shape[1]
    fb1, b2 = fb1.reshape(1, -1), b2.reshape(1, -1)
    xspec = pl.BlockSpec((1, 3, gm_blk), lambda b, t: (b, 0, t), memory_space=pltpu.VMEM)
    gspec = pl.BlockSpec((1, g_blk, cs), lambda b, t: (b * tiles + t, 0, 0),
                         memory_space=pltpu.VMEM)
    m2, sg, gmax = pl.pallas_call(
        functools.partial(_stats_kernel, m_size, jdt),
        grid=(B, tiles),
        in_specs=[xspec, *_wspecs([fw1.shape, fb1.shape, w2.shape, b2.shape])],
        out_specs=[pl.BlockSpec((cs, cs), lambda b, t: (0, 0), memory_space=pltpu.VMEM),
                   gspec, gspec],
        out_shape=[jax.ShapeDtypeStruct((cs, cs), jnp.float32),
                   jax.ShapeDtypeStruct((B * tiles, g_blk, cs), jnp.float32),
                   jax.ShapeDtypeStruct((B * tiles, g_blk, cs), jnp.float32)],
        interpret=True,
    )(jnp.swapaxes(x, 1, 2), fw1, fb1, w2, b2)
    return m2, sg.reshape(B * G, cs), gmax.reshape(B * G, cs)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,G,M", SWEEP_SHAPES)
def test_mini_stats_sweep_plain_matches_stats_kernel(dtype, B, G, M):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.RandomState(100 + G * M)
    x = (rng.rand(B, G * M, 3) - 0.5).astype(np.float32)
    w = _weights(rng)[:4]  # fw1, fb1, w2, b2
    got = mini_stats_sweep_plain(M, tdt, torch.from_numpy(x), *map(torch.from_numpy, w))
    want = _pallas_sweep(jnp.asarray(x), *map(jnp.asarray, w), M, jdt)
    for g, t, name, shape in zip(got, want, ("m2", "sg", "gmax"),
                                 ((256, 256), (B * G, 256), (B * G, 256))):
        assert g.dtype == torch.float32 and tuple(g.shape) == shape, name
        assert _rel(g.numpy(), t) <= tol, (name, _rel(g.numpy(), t))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,G,M", SWEEP_SHAPES)
def test_mini_stats_sweep_plain_m2_is_symmetric(dtype, B, G, M):
    """The kernels mirror m2's upper triangle, so their m2 is exactly
    symmetric; the plain version they are held to is too."""
    rng = np.random.RandomState(200 + G * M)
    x = torch.from_numpy((rng.rand(B, G * M, 3) - 0.5).astype(np.float32))
    m2, _, _ = mini_stats_sweep_plain(M, DTYPES[dtype][1], x,
                                      *map(torch.from_numpy, _weights(rng)[:4]))
    assert torch.equal(m2, m2.t())


def test_mini_stats_kernel_path_refuses_what_tma_cannot_load():
    """The bf16 kernel loads w2 by TMA: a w2 whose base is not 16-byte
    aligned is refused by name before any build or launch."""
    shapes = [(3, 128), (128,), (128, 256), (256,), (256, 512), (256, 512), (512,)]
    w = [torch.empty(s, device="meta") for s in shapes]
    flat = torch.empty(128 * 256 + 1, dtype=torch.bfloat16, device="meta")
    w[2] = flat[1:].view(128, 256)  # 2 bytes past an aligned base
    with pytest.raises(ValueError, match="16-byte aligned bases; w2 is not"):
        _mini_stats_cuda(32, torch.bfloat16, torch.empty(1, 64, 3, device="meta"), *w)
