"""Port vs reference: ``flash_mha``'s backward.

- ``flash_mha``'s gradients on CPU tensors (autograd of ``flash_plain``)
  against ``jax.vjp`` of the reference's ``flash_mha``, which off the TPU is
  ``jax.nn.dot_product_attention``, past ``FLASH_MIN_SEQ`` (L = 1025: one
  valid key in the last 64-key tile; L = 1030: a ragged six);
- ``flash_bwd_plain`` (what the CUDA backward kernels are held to on the
  card) against autograd of ``flash_plain`` on the same inputs, and
  ``flash_lse_plain`` against the log-sum-exp of the scores;
- the backward kernel path's checks, which run before any build.

Tolerances, relative to the reference gradient's max magnitude: f32 1e-5
(the same function, summation order only); bf16 2e-2 (P and dS are
rounded to bf16 at their products on both sides, eps 7.8e-3, and an f32
sum in another order can move one rounding by one step; ``flash_bwd_plain``
also takes di from the rounded output where autograd takes rowsum(p dP)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ppt_tpu.kernels.attention as A
from ppt_torch.kernels import attention as kattn

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _arrays(seed, shape, n=4):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.max(np.abs(want)))
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * scale, err / scale


@pytest.mark.parametrize("L", [1025, 1030])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_mha_grads_match_jax_vjp(L, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v, cot = _arrays(L, (1, L, 2, 16))
    out, vjp = jax.vjp(A.flash_mha, *(jnp.asarray(a, jdt) for a in (q, k, v)))
    want = vjp(jnp.asarray(cot, jdt))
    ts = [torch.from_numpy(a).to(tdt).requires_grad_(True) for a in (q, k, v)]
    got_out = kattn.flash_mha(*ts)
    got = torch.autograd.grad(got_out, ts, torch.from_numpy(cot).to(tdt))
    _close(got_out.detach().float().numpy(), out, tol)
    for g, w in zip(got, want):
        assert g.dtype == tdt and tuple(g.shape) == (1, L, 2, 16)
        _close(g.float().numpy(), w, tol)


@pytest.mark.parametrize("shape", [(2, 70, 3, 16), (1, 1025, 2, 32)], ids=["L70", "L1025"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_bwd_plain_matches_autograd_of_flash_plain(shape, dtype):
    _, tdt, tol = DTYPES[dtype]
    q, k, v, cot = (torch.from_numpy(a).to(tdt) for a in _arrays(7, shape))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = kattn.flash_plain(*leaves)
    want = torch.autograd.grad(out, leaves, cot)
    got = kattn.flash_bwd_plain(q, k, v, out.detach(), kattn.flash_lse_plain(q, k), cot)
    for g, w in zip(got, want):
        assert g.dtype == tdt and g.shape == w.shape
        _close(g.float().numpy(), w.float().numpy(), tol)


def test_flash_lse_plain_is_the_scores_log_sum_exp():
    q, k, _ = (torch.from_numpy(a) for a in _arrays(8, (2, 1030, 2, 16), 3))
    s = torch.einsum("blhd,bchd->bhlc", q.double(), k.double()) / 4.0
    np.testing.assert_allclose(kattn.flash_lse_plain(q, k).numpy(),
                               torch.logsumexp(s, -1).numpy(), rtol=1e-6, atol=1e-6)


def test_flash_mha_saves_nothing_without_a_gradient(monkeypatch):
    """No input requiring a gradient (the frozen blocks of prompt tuning,
    or ``no_grad``): the serving kernel route, no lse, no graph."""
    runs = []
    orig = kattn._flash_run
    monkeypatch.setattr(kattn, "_flash_run", lambda *a: runs.append(1) or orig(*a))
    q, k, v = (torch.from_numpy(a) for a in _arrays(9, (1, 1025, 2, 8), 3))
    out = kattn.flash_mha(q, k, v)
    assert runs == [1] and out.grad_fn is None
    with torch.no_grad():
        out = kattn.flash_mha(*(t.clone().requires_grad_(True) for t in (q, k, v)))
    assert runs == [1, 1] and out.grad_fn is None


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_backward_tiles_fit_shared_memory(dt):
    assert kattn.bwd_smem_bytes(dt, 128) <= kattn._SMEM_LIMIT


@pytest.mark.parametrize("D,want", [(32, 52296), (64, 101448), (128, 199752)])
def test_bf16_backward_tiles_follow_the_kernel(D, want):
    """The dK/dV CTA (``csrc/attention.cu:dkv_smem_bytes``): two consumers'
    64-key K and V tiles, four stages of 64-query Q and dO tiles with their
    di and lse rows, nine mbarriers and 1024 bytes of alignment slack."""
    assert kattn.bwd_smem_bytes(torch.bfloat16, D) == want


@pytest.mark.parametrize("dt,L,want", [(torch.bfloat16, 1025, (2, 3, 2, 1088)),
                                       (torch.bfloat16, 64, (2, 3, 2, 64)),
                                       (torch.float32, 1025, (2, 3, 1025))])
def test_backward_scratch_pads_rows_for_the_bulk_copies(dt, L, want):
    """bf16 keeps di and the lse side by side with rows padded to 64, so
    that each 64-query tile's pair arrives by two 256-byte bulk copies; f32
    keeps di alone."""
    assert kattn.bwd_scratch_shape(dt, 2, L, 3) == want


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("D,dtype,o_dtype,lse_shape,match", [
    (16, torch.bfloat16, torch.bfloat16, (1, 2, 1100), "bf16 needs head dim"),
    (136, torch.float32, torch.float32, (1, 2, 1100), "multiple of 8"),
    (64, torch.bfloat16, torch.float32, (1, 2, 1100), "q's dtype"),
    (64, torch.float32, torch.float32, (1, 1100, 2), "do not fit"),
])
def test_backward_kernel_path_rejects_what_it_does_not_take(D, dtype, o_dtype, lse_shape, match):
    """A tensor off the CPU takes the kernel path, whose checks run before
    any build or launch (meta tensors carry shapes only)."""
    q = _meta(1, 1100, 2, D, dtype=dtype)
    o = _meta(1, 1100, 2, D, dtype=o_dtype)
    with pytest.raises((ValueError, TypeError), match=match):
        kattn._flash_bwd(q, q, q, o, _meta(*lse_shape), q)
