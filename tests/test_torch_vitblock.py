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

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores

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


def _gemm_constants():
    """GM_BM, GM_BN, GM_BK and GM_SMEM as csrc/gemm.cuh declares them."""
    import pathlib
    import re

    from ppt_torch.kernels import _build

    text = (pathlib.Path(_build.__file__).parent.parent / "csrc" / "gemm.cuh").read_text()
    return {k: int(re.search(rf"\b{k} = (\d+)", text).group(1))
            for k in ("GM_BM", "GM_BN", "GM_BK", "GM_SMEM")}


def test_gemm_ring_fits_shared_memory():
    """The wgmma GEMM's one tile (csrc/gemm.cuh:GemmTile): 128 x 128 output
    tiles, 64-deep ring stages of an A tile and a W tile (32 KB), the bf16
    output tile (32 KB), 1024 bytes of alignment slack and 16 bytes of
    mbarriers a stage plus 24: six stages, 230,520 bytes, within the
    232,448 an SM gives one CTA, and deep enough to hold the whole K = 384
    of qkv, proj and fc1 (the header's static_assert pins the same)."""
    k = _gemm_constants()
    assert (k["GM_BM"], k["GM_BN"], k["GM_BK"], k["GM_SMEM"]) == (128, 128, 64, 232448)
    stage, out_tile, stages = 32768, 32768, 6
    assert stage == 2 * k["GM_BK"] * (k["GM_BM"] + k["GM_BN"])
    assert out_tile == 2 * k["GM_BM"] * k["GM_BN"]
    smem = 1024 + out_tile + stages * (stage + 16) + 24
    assert smem == 230520 <= k["GM_SMEM"] < smem + stage + 16
    assert stages * k["GM_BK"] >= 384


@pytest.mark.parametrize("bn,stages,smem", [(64, 8, 214168), (128, 6, 230520)])
def test_gemm_ring_at_every_tile_width(bn, stages, smem):
    """GemmTile<BN> at the two widths gemm_tile_n chooses from: a stage is
    an A tile [128][64] and a W tile [64][BN], the bf16 output tile is
    [128][BN]; the ring takes what is left of the SM's shared memory (the
    header's static_assert pins the same)."""
    k = _gemm_constants()
    stage, out_tile = 2 * k["GM_BK"] * (k["GM_BM"] + bn), 2 * k["GM_BM"] * bn
    got = (k["GM_SMEM"] - 1024 - out_tile - 24) // (stage + 16)
    assert got == stages
    assert 1024 + out_tile + stages * (stage + 16) + 24 == smem
    assert smem <= k["GM_SMEM"] < smem + stage + 16


# Every GEMM the port launches through the block kernels, as (tag, M, N, K,
# tiles, grid): PPT-Base at B = 32 (recognition, MPM's block route) and 30
# (the train step), MPM at B = 8 (its step against the plain path), the
# probe's C = 96 with heads of 16 (B = 2, L = 17 and 33), and the depth-3
# tower's C = 64. tiles is the count of 128 x 128 output tiles, grid the
# persistent CTAs on the H100's 132 SMs.
GEMM_SHAPES = [
    ("pptbase-b32-qkv", 16416, 1152, 384, 1161, 132),
    ("pptbase-b32-proj", 16416, 384, 384, 387, 132),
    ("pptbase-b32-fc1", 16416, 1536, 384, 1548, 132),
    ("pptbase-b32-fc2", 16416, 384, 1536, 387, 132),
    ("train-b30-qkv", 15390, 1152, 384, 1089, 132),
    ("train-b30-proj", 15390, 384, 384, 363, 132),
    ("train-b30-fc1", 15390, 1536, 384, 1452, 132),
    ("train-b30-fc2", 15390, 384, 1536, 363, 132),
    ("mpm-b8-qkv", 4104, 1152, 384, 297, 132),
    ("mpm-b8-proj", 4104, 384, 384, 99, 99),
    ("mpm-b8-fc1", 4104, 1536, 384, 396, 132),
    ("mpm-b8-fc2", 4104, 384, 1536, 99, 99),
    ("probe-c96-qkv", 34, 288, 96, 3, 3),
    ("probe-c96-proj", 34, 96, 96, 1, 1),
    ("probe-c96-fc1", 34, 384, 96, 3, 3),
    ("probe-c96-fc2", 34, 96, 384, 1, 1),
    ("probe-c96-l33-qkv", 66, 288, 96, 3, 3),
    ("probe-c96-l33-proj", 66, 96, 96, 1, 1),
    ("probe-c96-l33-fc1", 66, 384, 96, 3, 3),
    ("probe-c96-l33-fc2", 66, 96, 384, 1, 1),
    ("tower-c64-qkv", 66, 192, 64, 2, 2),
    ("tower-c64-proj", 66, 64, 64, 1, 1),
    ("tower-c64-fc1", 66, 256, 64, 2, 2),
    ("tower-c64-fc2", 66, 64, 256, 1, 1),
]


@pytest.mark.parametrize("tag,M,N,K,tiles,grid", GEMM_SHAPES, ids=[s[0] for s in GEMM_SHAPES])
def test_gemm_launch_at_every_shape(tag, M, N, K, tiles, grid):
    """The launch vitblock.cu:gemm makes of each shape: TMA loads rows of K
    and N bf16 elements (multiples of 16 bytes), the header's tile gives
    the tile count, and the persistent grid is min(tiles, SMs)."""
    k = _gemm_constants()
    assert K % 8 == 0 and N % 8 == 0
    assert -(-M // k["GM_BM"]) * -(-N // k["GM_BN"]) == tiles
    assert min(tiles, 132) == grid


def _misaligned(*shape, dt=torch.bfloat16):
    """A contiguous tensor whose base sits 2 bytes past a 16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 8, dtype=dt)[1:n + 1].view(*shape)


@pytest.mark.parametrize("which,match", [
    ("wqkv", "aligned bases; wqkv"), ("wfc2", "aligned bases; wfc2"), ("x", None),
])
def test_block_operands_refuse_what_tma_cannot_load(which, match):
    """block_operands refuses by name, before any launch, a bf16 weight
    whose base TMA cannot load (16-byte alignment). x is read by plain
    loads and passes misaligned; f32 takes no TMA."""
    from ppt_torch.kernels import vitblock as kvit

    rng = np.random.RandomState(5)
    x, pos, dp, weights = _args(rng)
    _, t = _split(x, pos, dp, weights, jnp.bfloat16)
    idx = {"x": 0, "wqkv": 5, "wfc2": 12}[which]
    t[idx] = _misaligned(*t[idx].shape).copy_(t[idx])
    assert t[idx].data_ptr() % 16 and t[idx].is_contiguous()
    if match is None:
        args, _ = kvit.block_operands("fused_vit_block", t[0], t[1], t[2], t[3:], H)
        assert args[0].data_ptr() % 16
    else:
        with pytest.raises(ValueError, match=match):
            kvit.block_operands("fused_vit_block", t[0], t[1], t[2], t[3:], H)
    _, f = _split(x, pos, dp, weights, jnp.float32)
    f[idx] = _misaligned(*f[idx].shape, dt=torch.float32).copy_(f[idx])
    args, _ = kvit.block_operands("fused_vit_block", f[0], f[1], f[2], f[3:], H)
    assert len(args) == 14


def test_tma_guard_refuses_rows_it_cannot_load():
    from ppt_torch.kernels import vitblock as kvit

    with pytest.raises(ValueError, match="rows a multiple of 16 bytes; wproj has 12"):
        kvit.check_tma("fused_vit_tower", wproj=torch.zeros(4, 12, dtype=torch.bfloat16))
    kvit.check_tma("fused_vit_tower", wproj=torch.zeros(4, 12))  # f32: no TMA
