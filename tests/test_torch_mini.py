"""Port vs reference: the MiniPointNet group encoder (eval mode).

The bf16 kernel path takes the output widths 128 (the masked-point
autoencoder's tokens) and 256 (PointBERT's) and refuses others by name.

The port's plain ``mini_forward`` against the Pallas kernel in interpret
mode on the same folded weights, and the port's ``MiniPointNet`` against
the flax module (fused path forced, as on the reference's chip) with
weights through ``ppt_torch.convert.from_jax``.

Tolerances: f32 1e-5 (same arithmetic, f32 summation order only). bf16:
2e-2 relative to the output's scale — both sides round every dot
product and bias add to bf16 (8-bit mantissa, eps 7.8e-3), and a
different f32 summation order can flip one rounding step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppt_tpu.kernels.mini import _forward_pallas
from ppt_torch.convert import from_jax
from ppt_torch.kernels.mini import _mini_forward_cuda, mini_forward
from ppt_torch.nn.pointbert import MiniPointNet

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _weights(rng, co=256):
    f = lambda *s, sc=0.1: (rng.randn(*s) * sc).astype(np.float32)
    return [f(3, 128, sc=0.5), f(128), f(128, 256), f(256), f(256, 512), f(256, 512), f(512),
            f(512, co), f(co)]


def _close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(float(np.max(np.abs(want))), 1.0)
    assert np.max(np.abs(got - want)) <= tol * scale, np.max(np.abs(got - want)) / scale


# (1, 7, 20) and (2, 9, 32): the last tile of the card's kernel holds fewer
# groups than a tile, and M < 32 pads every group's rows; co = 128 is the
# masked-point autoencoder's tokens, which the bf16 kernel also takes
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,G,M,co", [(2, 8, 8, 256), (1, 16, 32, 64), (1, 7, 20, 256),
                                      (2, 9, 32, 256), (2, 8, 32, 128), (1, 7, 20, 128)])
def test_mini_forward_plain_matches_pallas(dtype, B, G, M, co):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.RandomState(G * M + co)
    x = rng.rand(B, G * M, 3).astype(np.float32)
    w = _weights(rng, co)
    got = mini_forward(M, tdt, torch.from_numpy(x), *map(torch.from_numpy, w))
    want = _forward_pallas(jnp.asarray(x), *map(jnp.asarray, w), m_size=M, dtype=jdt,
                           interpret=True)
    assert tuple(got.shape) == (B, G, co) and got.dtype == tdt
    _close(got.float().numpy(), want, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_minipointnet_eval_matches_flax(dtype, monkeypatch):
    from ppt_tpu.nn.pointbert import MiniPointNet as JaxMini

    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.RandomState(1)
    groups = rng.rand(2, 8, 8, 3).astype(np.float32)
    jmini = JaxMini(64, dtype=jdt)
    variables = jmini.init(jax.random.PRNGKey(0), jnp.asarray(groups[:1]))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    for bn in ("bn1", "bn2"):  # non-trivial BN state so the fold is exercised
        n = params[bn]["scale"].shape[0]
        params[bn] = {"scale": (1 + 0.1 * rng.randn(n)).astype(np.float32),
                      "bias": (0.1 * rng.randn(n)).astype(np.float32)}
        stats[bn] = {"mean": (0.1 * rng.randn(n)).astype(np.float32),
                     "var": (0.5 + rng.rand(n)).astype(np.float32)}
    monkeypatch.setenv("PPT_FORCE_FUSED_MINI", "1")
    want = jmini.apply({"params": params, "batch_stats": stats}, jnp.asarray(groups))

    tmini = MiniPointNet(64, dtype=tdt)
    tmini.load_state_dict(from_jax(params, stats, tmini))
    with torch.no_grad():
        got = tmini(torch.from_numpy(groups))
    assert got.dtype == tdt and tuple(got.shape) == (2, 8, 64)
    _close(got.float().numpy(), want, tol)


@pytest.mark.parametrize("M,co,match", [(32, 64, "bf16 takes"), (32, 512, "bf16 takes"),
                                        (64, 256, "M <= 32")])
def test_mini_forward_kernel_path_rejects_what_it_does_not_take(M, co, match):
    """The kernel path (the op's CUDA implementation) runs its shape checks
    before any build or launch (meta tensors carry shapes only)."""
    shapes = [(3, 128), (128,), (128, 256), (256,), (256, 512), (256, 512), (512,), (512, co),
              (co,)]
    w = [torch.empty(s, device="meta") for s in shapes]
    x = torch.empty(1, 2 * M, 3, device="meta")
    with pytest.raises(ValueError, match=match):
        _mini_forward_cuda(M, torch.bfloat16, x, *w)


class Loaded(Exception):
    """Raised in place of loading the library: the checks before it passed."""


@pytest.mark.parametrize("co", [128, 256])
def test_mini_forward_kernel_path_takes_both_bf16_widths(co, monkeypatch):
    """In bf16 the kernel path takes CO = 128 (MAE's tokens) and 256
    (PointBERT's): its checks pass and it goes on to load the library."""
    from ppt_torch.kernels import _build

    def load(name):
        raise Loaded(name)

    monkeypatch.setattr(_build, "load", load)
    shapes = [(3, 128), (128,), (128, 256), (256,), (256, 512), (256, 512), (512,), (512, co),
              (co,)]
    w = [torch.empty(s, device="meta") for s in shapes]
    with pytest.raises(Loaded, match="mini"):
        _mini_forward_cuda(32, torch.bfloat16, torch.empty(1, 64, 3, device="meta"), *w)


@pytest.mark.parametrize("name", ["w2", "fwg", "fwl", "w3"])
def test_mini_forward_kernel_path_refuses_what_tma_cannot_load(name):
    """The bf16 kernel streams w2, fwg, fwl and w3 by TMA: a matrix whose
    base is not 16-byte aligned is refused by name before any build."""
    shapes = dict(fw1=(3, 128), fb1=(128,), w2=(128, 256), b2=(256,), fwg=(256, 512),
                  fwl=(256, 512), fbs=(512,), w3=(512, 256), b3=(256,))
    w = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    rows, cols = shapes[name]
    flat = torch.empty(rows * cols + 1, dtype=torch.bfloat16, device="meta")
    w[name] = flat[1:].view(rows, cols)  # 2 bytes past an aligned base
    x = torch.empty(1, 64, 3, device="meta")
    with pytest.raises(ValueError, match=f"16-byte aligned bases; {name} is not"):
        _mini_forward_cuda(32, torch.bfloat16, x, *w.values())
