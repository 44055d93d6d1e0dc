"""Port vs reference: the reconstruction losses and their two kernels.

- ``nn_dists_plain`` (the CPU twin of the Chamfer kernel) against the
  reference's Pallas ``_nn_dists`` interpreted: rtol 1e-6, atol 1e-7 (the
  same exact-difference form, f32); at N not a multiple of 8 against the
  XLA minima of the expanded form, atol 1e-5 on unit-cube data;
- ``chamfer``'s value and gradient against ``chamfer_pallas``'s pieces
  (``_nn_dists`` interpreted, ``jax.grad(chamfer_l2)``), and the five
  Chamfer variants against ``ops/losses3d.py``: rtol 1e-5;
- ``approx_match_plain`` against the reference's XLA ``approx_match`` and
  ``approx_match_pallas`` interpreted: rtol 1e-3, atol 1e-4, as
  ``tests/test_emd_kernel.py`` holds those two to each other;
- the match cost's value (rtol 1e-4) and its closed-form gradient (within
  1e-3 of the largest entry: the match itself is held at 1e-4) against
  ``jax.vjp`` of ``emd_matchcost_pallas``; ``earth_mover_distance`` and
  the Sinkhorn ``emd_distance`` on the CPU; ``PPT_FORCE_XLA_EMD`` read as
  the reference reads it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppt_torch.kernels import _build
from ppt_torch.kernels import chamfer as kchamfer
from ppt_torch.kernels import emd as kemd
from ppt_torch.ops import losses3d as plosses

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores


def clouds(b, n, m, seed=0, scale=1.0):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, n, 3).astype(np.float32) * scale,
            rng.rand(b, m, 3).astype(np.float32) * scale)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("b,n,m", [(2, 128, 200), (3, 40, 50), (1, 8, 1)])
def test_nn_dists_plain_matches_the_pallas_kernel(b, n, m):
    from ppt_tpu.kernels.chamfer import _nn_dists

    q, x = clouds(b, n, m, seed=n + m, scale=2.0)
    want = np.asarray(_nn_dists(jnp.asarray(q), jnp.asarray(x), interpret=True))
    got = kchamfer.nn_dists_plain(t(q), t(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (b, n)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n", [40, 37])
def test_nn_dists_takes_any_n(n):
    """The reference kernel asserts N % 8 == 0 (a TPU layout limit); the
    port's takes any N: held to the XLA minima of the expanded form."""
    from ppt_tpu.ops.losses3d import chamfer_distance_split

    q, x = clouds(2, n, 53, seed=n)
    want, _ = chamfer_distance_split(jnp.asarray(q), jnp.asarray(x))
    got = kchamfer.nn_dists(t(q), t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_nn_dists_plain_chunks_give_the_same_minima(monkeypatch):
    q, x = clouds(2, 300, 70, seed=5)
    whole = kchamfer.nn_dists_plain(t(q), t(x))
    monkeypatch.setattr(kchamfer, "_CHUNK_PAIRS", 2 * 70 * 7)  # 7 queries a chunk
    assert torch.equal(kchamfer.nn_dists_plain(t(q), t(x)), whole)


def test_chamfer_value_and_gradient_match_the_reference():
    from ppt_tpu.kernels.chamfer import _nn_dists
    from ppt_tpu.ops.losses3d import chamfer_l2

    a, b = clouds(2, 64, 48, seed=1)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    want = float(jnp.mean(_nn_dists(ja, jb, interpret=True))
                 + jnp.mean(_nn_dists(jb, ja, interpret=True)))
    wa, wb = jax.grad(chamfer_l2, argnums=(0, 1))(ja, jb)
    xa, xb = t(a).requires_grad_(), t(b).requires_grad_()
    got = kchamfer.chamfer(xa, xb)
    ga, gb = torch.autograd.grad(3.0 * got, [xa, xb])
    assert abs(float(got.detach()) - want) <= 1e-5 * want
    assert abs(float(kchamfer.chamfer_plain(t(a), t(b))) - want) <= 1e-5 * want
    np.testing.assert_allclose(ga.numpy(), 3.0 * np.asarray(wa), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(gb.numpy(), 3.0 * np.asarray(wb), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["chamfer_distance_split", "chamfer_l2", "chamfer_l2_split",
                                  "chamfer_l1", "chamfer_l1_split"])
def test_chamfer_variants_match_the_reference(name):
    from ppt_tpu.ops import losses3d as jlosses

    a, b = clouds(3, 50, 33, seed=2)
    a[0, 0] = b[0, 0]  # an exact match: the L1 forms' sqrt of ~0
    want = getattr(jlosses, name)(jnp.asarray(a), jnp.asarray(b))
    got = getattr(plosses, name)(t(a), t(b))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("b,n,m,seed", [(3, 64, 64, 0), (2, 128, 32, 1), (2, 32, 128, 1),
                                        (2, 40, 50, 3)])
def test_approx_match_plain_matches_the_reference(b, n, m, seed):
    from ppt_tpu.kernels.emd import approx_match_pallas
    from ppt_tpu.ops.losses3d import approx_match

    x1, x2 = clouds(b, n, m, seed=seed)
    want = np.asarray(approx_match(jnp.asarray(x1), jnp.asarray(x2)))
    want_pallas = np.asarray(approx_match_pallas(jnp.asarray(x1), jnp.asarray(x2),
                                                 interpret=True))
    got = kemd.approx_match_plain(t(x1), t(x2))
    assert got.shape == (b, n, m) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), want_pallas, rtol=1e-3, atol=1e-4)
    assert torch.equal(kemd.approx_match(t(x1), t(x2)), got)  # the CPU wrapper is the plain version
    assert torch.equal(plosses.approx_match(t(x1), t(x2)), got)


def test_approx_match_conserves_mass():
    """Every left point ships its full supply; with N = 2M each right point
    absorbs about multi_r = 2 units (the reference's own checks)."""
    x1, x2 = clouds(2, 48, 48, seed=2)
    np.testing.assert_allclose(kemd.approx_match_plain(t(x1), t(x2)).sum(2).numpy(), 1.0,
                               atol=1e-3)
    rng = np.random.RandomState(0)
    a, b = rng.randn(1, 32, 3).astype(np.float32), rng.randn(1, 16, 3).astype(np.float32)
    assert kemd.supplies(32, 16) == (1.0, 2.0) and kemd.supplies(8, 32) == (4.0, 1.0)
    np.testing.assert_allclose(kemd.approx_match_plain(t(a), t(b)).sum(1).numpy(), 2.0,
                               atol=6e-2)


def test_emd_matchcost_value_and_closed_form_gradient():
    from ppt_tpu.kernels.emd import emd_matchcost_pallas

    x1, x2 = clouds(2, 32, 24, seed=4)
    cot = np.array([0.7, -1.3], np.float32)
    want, vjp = jax.vjp(emd_matchcost_pallas, jnp.asarray(x1), jnp.asarray(x2))
    w1, w2 = vjp(jnp.asarray(cot))
    a, b = t(x1).requires_grad_(), t(x2).requires_grad_()
    got = kemd.emd_matchcost(a, b)
    g1, g2 = torch.autograd.grad(got, [a, b], t(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4)
    for g, w in ((g1, w1), (g2, w2)):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-3 * np.abs(w).max()
    # the plain form (autograd through the distances, match detached) agrees
    a2, b2 = t(x1).requires_grad_(), t(x2).requires_grad_()
    p1, p2 = torch.autograd.grad(plosses.emd_matchcost(a2, b2), [a2, b2], t(cot))
    torch.testing.assert_close(p1, g1, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(p2, g2, rtol=1e-5, atol=1e-6)


def test_earth_mover_distance_on_the_cpu():
    from ppt_tpu.ops.losses3d import earth_mover_distance

    x1, x2 = clouds(4, 32, 32, seed=6)
    want, grad = jax.value_and_grad(earth_mover_distance)(jnp.asarray(x1), jnp.asarray(x2))
    a = t(x1).requires_grad_()
    got = plosses.earth_mover_distance(a, t(x2))
    (g,) = torch.autograd.grad(got, [a])
    assert got.dim() == 0 and abs(float(got.detach()) - float(want)) <= 1e-4 * float(want)
    assert np.abs(g.numpy() - np.asarray(grad)).max() <= 1e-3 * np.abs(np.asarray(grad)).max()


def test_emd_distance_matches_the_reference():
    from ppt_tpu.ops.losses3d import emd_distance

    x1, x2 = clouds(2, 24, 16, seed=7)
    want = np.asarray(emd_distance(jnp.asarray(x1), jnp.asarray(x2), iters=30))
    got = plosses.emd_distance(t(x1), t(x2), iters=30)
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)


@pytest.mark.parametrize("value,kernel", [(None, True), ("1", False), ("0", False)])
def test_force_xla_emd_is_read_as_the_reference_reads_it(monkeypatch, value, kernel):
    """Any value of ``PPT_FORCE_XLA_EMD`` (even "0") sends a CUDA tensor to
    the plain version; a CPU tensor always goes there."""
    if value is None:
        monkeypatch.delenv("PPT_FORCE_XLA_EMD", raising=False)
    else:
        monkeypatch.setenv("PPT_FORCE_XLA_EMD", value)
    assert plosses.emd_uses_kernel(torch.device("cuda")) is kernel
    assert plosses.emd_uses_kernel(torch.device("cpu")) is False


def test_emd_fits_pallas_is_the_reference_bound():
    from ppt_tpu.kernels.emd import emd_fits_pallas

    for n, m in [(8, 32), (1024, 768), (2048, 2048), (4096, 200), (7000, 100)]:
        assert kemd.emd_fits_pallas(n, m) == emd_fits_pallas(n, m)


def test_the_wrappers_launch_nothing_on_the_cpu():
    _build.reset_launches()
    x1, x2 = clouds(2, 16, 8)
    kchamfer.nn_dists(t(x1), t(x2))
    kchamfer.chamfer(t(x1), t(x2))
    kemd.approx_match(t(x1), t(x2))
    plosses.earth_mover_distance(t(x1), t(x2))
    assert sum(_build.LAUNCHES.values()) == 0
