"""Port vs reference: the attention kernels' plain versions and wrappers.

``mha_plain`` (what ``fused_mha`` runs on CPU tensors and what its CUDA
kernel is held to on the card) against the reference's Pallas kernel in
interpret mode; ``fused_mha``'s gradient against ``jax.grad`` of the
reference's ``fused_mha`` (whose VJP differentiates ``_mha_reference``);
``flash_plain`` against ``flash_mha(force_xla=True)``, i.e.
``jax.nn.dot_product_attention``, past ``FLASH_MIN_SEQ`` with a ragged
last key tile; the routing of ``flash_mha`` by length and its backward
(``tests/test_torch_flash_bwd.py`` holds that backward to the reference);
the kernel paths' shape checks.

Tolerances, relative to the reference output's max magnitude: f32 1e-5
(same arithmetic, summation order only); bf16 2e-2 (P and the output are
rounded to bf16, eps 7.8e-3, at the same points on both sides; an f32 sum
in another order can move one rounding by one step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ppt_tpu.kernels.attention as A
from ppt_torch.kernels import attention as kattn

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _qkv(rng, shape, scale=1.0):
    return [(rng.randn(*shape) * scale).astype(np.float32) for _ in range(3)]


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.max(np.abs(want)))
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * scale, err / scale


@pytest.mark.parametrize("dtype,shape", [("float32", (2, 33, 2, 16)),
                                         ("bfloat16", (2, 100, 6, 64)),
                                         ("bfloat16", (1, 513, 6, 64))])
def test_mha_plain_matches_pallas(dtype, shape):
    jdt, tdt, tol = DTYPES[dtype]
    arrs = _qkv(np.random.RandomState(0), shape)
    want = A._mha_pallas(*(jnp.asarray(a, jdt) for a in arrs), interpret=True)
    got = kattn.fused_mha(*(torch.from_numpy(a).to(tdt) for a in arrs))
    assert got.dtype == tdt and tuple(got.shape) == shape
    _close(got.float().numpy(), want, tol)


def test_mha_plain_on_views_of_one_qkv_product():
    """q, k, v as ``VitAttention`` hands them over: strided views of one
    [B, L, 3C] tensor, no copies; the result is the contiguous one's."""
    rng = np.random.RandomState(1)
    B, L, H, D = 2, 17, 3, 8
    qkv = torch.from_numpy(rng.randn(B, L, 3 * H * D).astype(np.float32))
    q, k, v = (t.reshape(B, L, H, D) for t in qkv.split(H * D, dim=-1))
    assert q.data_ptr() == qkv.data_ptr() and not q.is_contiguous()
    got = kattn.fused_mha(q, k, v)
    want = kattn.fused_mha(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(got, want)


def test_fused_mha_grad_matches_reference(monkeypatch):
    """The gradient is ``_mha_reference``'s, as the reference's VJP has it
    (its forward patched to interpret mode, as the reference's own test)."""
    rng = np.random.RandomState(2)
    arrs = _qkv(rng, (1, 33, 2, 16))
    cot = rng.randn(1, 33, 2, 16).astype(np.float32)
    orig = A._mha_pallas
    monkeypatch.setattr(A, "_mha_pallas",
                        lambda q, k, v, interpret=False: orig(q, k, v, interpret=True))
    want = jax.grad(lambda q, k, v: jnp.sum(A.fused_mha(q, k, v) * cot),
                    argnums=(0, 1, 2))(*map(jnp.asarray, arrs))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    (kattn.fused_mha(*ts) * torch.from_numpy(cot)).sum().backward()
    for t, w in zip(ts, want):
        _close(t.grad.numpy(), w, 1e-5)


@pytest.mark.parametrize("L", [1025, 1100])
@pytest.mark.parametrize("H,D", [(6, 64), (12, 32)], ids=["D64", "D32"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_plain_matches_dot_product_attention(L, H, D, dtype):
    """Past FLASH_MIN_SEQ: L = 1025 leaves one valid key in the last
    64-key tile, L = 1100 a ragged 12; PPT-Base's width as 6 heads of 64
    and as 12 of 32."""
    jdt, tdt, tol = DTYPES[dtype]
    arrs = _qkv(np.random.RandomState(L), (1, L, H, D))
    want = A.flash_mha(*(jnp.asarray(a, jdt) for a in arrs), force_xla=True)
    got = kattn.flash_mha(*(torch.from_numpy(a).to(tdt) for a in arrs))
    assert got.dtype == tdt and tuple(got.shape) == (1, L, H, D)
    _close(got.float().numpy(), want, tol)


def test_flash_mha_routes_by_length_and_its_backward_raises(monkeypatch):
    """Below FLASH_MIN_SEQ the plain path, differentiable; from it on the
    kernel's route (the plain version on CPU tensors), whose backward no
    longer raises: it runs and gives autograd of ``flash_plain``, the
    function the reference differentiates off the TPU."""
    runs = []
    orig = kattn._flash_run
    monkeypatch.setattr(kattn, "_flash_run", lambda *a: runs.append(a[0].shape[1]) or orig(*a))
    rng = np.random.RandomState(3)
    short = [torch.from_numpy(a).requires_grad_(True) for a in _qkv(rng, (1, 64, 2, 8))]
    kattn.flash_mha(*short).sum().backward()
    assert short[0].grad is not None and runs == []
    long_ = [torch.from_numpy(a) for a in _qkv(rng, (1, kattn.FLASH_MIN_SEQ, 2, 8))]
    out = kattn.flash_mha(*long_)
    assert runs == [kattn.FLASH_MIN_SEQ] and torch.equal(out, kattn.flash_plain(*long_))
    grads = [t.clone().requires_grad_(True) for t in long_]
    kattn.flash_mha(*grads).sum().backward()
    assert runs == [kattn.FLASH_MIN_SEQ] * 2
    plain = [t.clone().requires_grad_(True) for t in long_]
    kattn.flash_plain(*plain).sum().backward()
    for g, w in zip(grads, plain):
        assert torch.isfinite(g.grad).all() and float(g.grad.abs().max()) > 0
        _close(g.grad.numpy(), w.grad.numpy(), 1e-6)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _flash_cuda_serving(q, k, v):
    """The flash operator's CUDA implementation, serving (no lse): a meta
    tensor through the operator takes its fake."""
    return kattn._flash_cuda(q, k, v, False)[0]


@pytest.mark.parametrize("fn,dtype,D,match", [
    (kattn._mha_run, torch.bfloat16, 48, "bf16 needs head dim"),
    (kattn._mha_run, torch.float32, 12, "multiple of 8"),
    (_flash_cuda_serving, torch.bfloat16, 16, "bf16 needs head dim"),
    (_flash_cuda_serving, torch.float32, 136, "multiple of 8"),
])
def test_kernel_paths_reject_what_they_do_not_take(fn, dtype, D, match):
    """A tensor off the CPU takes the kernel path, whose checks run before
    any build or launch (meta tensors carry shapes only)."""
    q = _meta(1, 1100, 2, D, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        fn(q, q, q)


@pytest.mark.parametrize("strides,offset,match", [
    ((2304, 1152, 60), 0, "multiples of 16 bytes"),  # a head stride of 60 bf16 elements
    ((2304, 1156, 64), 0, "multiples of 16 bytes"),
    ((2304, 1152, 64), 1, "16-byte aligned"),  # a base 2 bytes past a boundary
])
def test_tma_guard_refuses_strides_and_bases_it_cannot_load(strides, offset, match):
    """The bf16 kernels load their tiles by TMA, which takes strides in
    multiples of 16 bytes and 16-byte aligned bases; ``_views`` copies
    what does not qualify, and the guard in front of the C call refuses it
    by name."""
    t = torch.empty(4096, dtype=torch.bfloat16)[offset:]
    for name in ("fused_mha", "flash_mha"):
        with pytest.raises(ValueError, match=f"{name}: .*{match}"):
            kattn._check_tma(name, torch.bfloat16, strides, t, t, t)
        kattn._check_tma(name, torch.float32, strides, t, t, t)  # f32 takes no TMA


@pytest.mark.parametrize("fn,name", [(kattn._mha_run, "fused_mha"),
                                     (_flash_cuda_serving, "flash_mha")])
def test_kernel_paths_apply_the_tma_guard(fn, name, monkeypatch):
    """Both bf16 entry points put the guard in front of the C call: with
    _views letting a head stride of 60 elements through, the launch is
    refused by name before any build (meta tensors carry shapes only)."""
    q = _meta(1, 1100, 2, 64, dtype=torch.bfloat16)
    monkeypatch.setattr(kattn, "_views", lambda name, q, k, v: (q, k, v, (2304, 1152, 60)))
    with pytest.raises(ValueError, match=f"{name}: TMA needs strides"):
        fn(q, q, q)


def test_whole_row_kernel_path_refuses_a_row_too_long_for_shared_memory():
    q = _meta(1, 2048, 2, 64)
    with pytest.raises(ValueError, match="too long"):
        kattn._mha_run(q, q, q)
