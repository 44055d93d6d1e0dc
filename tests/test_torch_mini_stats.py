"""Port vs reference: the train-mode BN2 statistics (``mini_stats``).

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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppt_tpu.kernels.mini import _stats_pallas, _stats_twin
from ppt_torch.kernels.mini import mini_stats, mini_stats_plain

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
SHAPES = [(2, 8, 8), (1, 16, 32)]  # B, G, M


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
    """A tensor off the CPU takes the kernel path, whose shape checks run
    before any build or launch (meta tensors carry shapes only)."""
    c1, c2 = shape
    shapes = [(3, c1), (c1,), (c1, c2), (c2,), (c2, 512), (c2, 512), (512,)]
    w = [torch.empty(s, device="meta") for s in shapes]
    with pytest.raises(ValueError, match=match):
        mini_stats(M, torch.bfloat16, torch.empty(1, 2 * M, 3, device="meta"), *w)
