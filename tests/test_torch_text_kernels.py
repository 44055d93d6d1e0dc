"""Port vs reference: the fused text block, the fused text tower and the
tower's hand-written backward.

The same numpy-seeded inputs go through the reference's Pallas kernels
(in interpret mode, as its own tests run them off the TPU), through its
XLA twins, and through the port's plain PyTorch versions, which are what
the port's wrappers run for a tensor on the CPU. Small sizes: 10 classes
(not a multiple of the reference's chunk of 8), L = 16, an odd L = 13 and
CLIP's full context L = 77 (which the card's bf16 attention pads to 80),
width 128, 2 layers, 4 heads.

Tolerances, of the reference value's max: block f32 1e-5, bf16 2e-2; tower
output f32 2e-4, bf16 3e-2 (the reference's own bounds); backward f32
1e-4, bf16 5e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppt_tpu.kernels import textblock as jblock
from ppt_tpu.kernels import texttower as jtower
from ppt_torch.kernels import textblock, texttower
from ppt_torch.kernels.texttower import WEIGHT_NAMES

C, D, HEADS, DEPTH, E = 10, 128, 4, 2, 128
MATRICES = ("win", "wout", "wfc", "wproj")
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def make_weights(seed=0, depth=DEPTH, width=D, embed=E):
    """The tower's 15 weights as f32 numpy arrays, stacked on depth."""
    rng = np.random.RandomState(seed)
    hid = 4 * width
    shapes = {"ln1s": (width,), "ln1b": (width,), "win": (width, 3 * width),
              "bin": (3 * width,), "wout": (width, width), "bout": (width,),
              "ln2s": (width,), "ln2b": (width,), "wfc": (width, hid), "bfc": (hid,),
              "wproj": (hid, width), "bproj": (width,)}
    out = {}
    for name, shape in shapes.items():
        if name in MATRICES:
            arr = rng.randn(depth, *shape) / np.sqrt(shape[0])
        elif name.endswith("s"):
            arr = 1.0 + 0.1 * rng.randn(depth, *shape)
        else:
            arr = 0.1 * rng.randn(depth, *shape)
        out[name] = arr.astype(np.float32)
    out["lnfs"] = (1.0 + 0.1 * rng.randn(width)).astype(np.float32)
    out["lnfb"] = (0.1 * rng.randn(width)).astype(np.float32)
    out["tproj"] = (rng.randn(width, embed) / np.sqrt(width)).astype(np.float32)
    return out


def make_inputs(L, seed=1):
    rng = np.random.RandomState(seed)
    x0 = rng.randn(C, L, D).astype(np.float32)
    eot = rng.randint(1, L, C)
    onehot = (np.arange(L)[None, :] == eot[:, None]).astype(np.float32)
    g = rng.randn(C, E).astype(np.float32)
    return x0, onehot, g


def jax_weights(w, kind, layer=None):
    names = WEIGHT_NAMES[:12] if layer is not None else WEIGHT_NAMES
    out = []
    for n in names:
        a = jnp.asarray(w[n] if layer is None else w[n][layer])
        out.append(a.astype(JDT[kind]) if n in MATRICES else a)
    return out


def torch_weights(w, kind, layer=None):
    names = WEIGHT_NAMES[:12] if layer is not None else WEIGHT_NAMES
    out = []
    for n in names:
        t = torch.from_numpy(w[n] if layer is None else w[n][layer])
        out.append(t.to(TDT[kind]) if n in MATRICES else t)
    return out


def as_np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a.astype(jnp.float32))


def rel_err(got, want):
    want = as_np(want)
    return float(np.max(np.abs(as_np(got) - want)) / (np.max(np.abs(want)) or 1.0))


def causal(L):
    m = np.zeros((L, L), np.float32)
    m[np.triu_indices(L, k=1)] = -np.inf
    return jnp.asarray(m)


def unchunk_blocks(xs, L):
    """The reference's ``xs [n_chunks, depth, 8 * Lp, D]`` as the port's
    ``[depth, C * L, D]``: unpadded classes and rows only."""
    xs = np.asarray(xs.astype(jnp.float32))
    n_chunks, depth, rc, width = xs.shape
    lp = rc // jtower.CHUNK
    xs = xs.reshape(n_chunks, depth, jtower.CHUNK, lp, width).transpose(1, 0, 2, 3, 4)
    return xs.reshape(depth, n_chunks * jtower.CHUNK, lp, width)[:, :C, :L].reshape(
        depth, C * L, width)


def jax_residual_forward(x0, onehot, weights):
    xp, mask8, eot_chunks, _, _ = jtower._pad_and_chunk(x0, onehot)
    out, xs = jtower._tower_pallas_res(xp, mask8, eot_chunks, *weights, heads=HEADS,
                                       interpret=True)
    return out[:C], xs, (xp, mask8, eot_chunks)


@pytest.mark.parametrize("L", [16, 13])
@pytest.mark.parametrize("kind,tol", [("f32", 1e-5), ("bf16", 2e-2)])
def test_text_block_plain_matches_kernel_and_twin(kind, tol, L):
    w = make_weights()
    x_np = make_inputs(L)[0]
    jx = jnp.asarray(x_np).astype(JDT[kind])
    jw = jax_weights(w, kind, layer=0)
    want_kernel = jblock._text_pallas(jx, *jw, heads=HEADS, interpret=True)
    want_twin = jblock._text_twin(jx, *jw, heads=HEADS)
    x = torch.from_numpy(x_np).to(TDT[kind])
    tw = torch_weights(w, kind, layer=0)
    got = textblock.text_block_plain(x, *tw, HEADS)
    assert got.dtype == TDT[kind] and tuple(got.shape) == (C, L, D)
    assert rel_err(got, want_kernel) <= tol
    assert rel_err(got, want_twin) <= tol
    # the public wrapper runs the plain version for a CPU tensor
    assert torch.equal(textblock.fused_text_block(x, *tw, HEADS), got)


def test_fused_text_block_gradient_is_the_twins():
    w = make_weights()
    x_np = make_inputs(16)[0]
    jw = jax_weights(w, "f32", layer=0)
    want = jax.grad(lambda xx: jnp.sum(jnp.sin(jblock.fused_text_block(xx, *jw, HEADS))))(
        jnp.asarray(x_np))
    x = torch.from_numpy(x_np).requires_grad_(True)
    tw = torch_weights(w, "f32", layer=0)
    tw[2].requires_grad_(True)
    out = textblock.fused_text_block(x, *tw, HEADS)
    gx, gw = torch.autograd.grad(out.sin().sum(), [x, tw[2]])
    assert rel_err(gx, want) <= 1e-4
    assert float(gw.abs().max()) > 0


@pytest.mark.parametrize("L", [16, 13, 77])
@pytest.mark.parametrize("kind,tol", [("f32", 2e-4), ("bf16", 3e-2)])
def test_text_tower_plain_matches_kernel_and_twin(kind, tol, L):
    w = make_weights()
    x_np, onehot, _ = make_inputs(L)
    jx = jnp.asarray(x_np).astype(JDT[kind])
    jw = jax_weights(w, kind)
    want_kernel = jtower.fused_text_tower(jx, jnp.asarray(onehot), *jw, HEADS)
    want_twin = jtower._tower_twin(jx, causal(L), jnp.asarray(onehot), *jw, heads=HEADS)
    want_res, xs, _ = jax_residual_forward(jx, jnp.asarray(onehot), jw)

    x = torch.from_numpy(x_np).to(TDT[kind])
    tw = torch_weights(w, kind)
    got, blocks = texttower.text_tower_plain(x, torch.from_numpy(onehot), *tw, HEADS,
                                             return_blocks=True)
    assert got.dtype == torch.float32 and tuple(got.shape) == (C, E)
    assert tuple(blocks.shape) == (DEPTH, C * L, D) and blocks.dtype == TDT[kind]
    assert rel_err(got, want_kernel) <= tol
    assert rel_err(got, want_twin) <= tol
    assert rel_err(got, want_res) <= tol
    want_blocks = unchunk_blocks(xs, L)
    assert np.max(np.abs(as_np(blocks) - want_blocks)) <= tol * np.max(np.abs(want_blocks))
    assert torch.equal(texttower.text_tower_plain(x, torch.from_numpy(onehot), *tw, HEADS), got)


@pytest.mark.parametrize("L", [16, 13, 77])
@pytest.mark.parametrize("kind,tol", [("f32", 1e-4), ("bf16", 5e-2)])
def test_text_tower_bwd_plain_matches_backward_kernel(kind, tol, L):
    w = make_weights()
    x_np, onehot, g_np = make_inputs(L)
    jx = jnp.asarray(x_np).astype(JDT[kind])
    jw = jax_weights(w, kind)
    _, xs, (xp, mask8, eot_chunks) = jax_residual_forward(jx, jnp.asarray(onehot), jw)
    gp = jnp.pad(jnp.asarray(g_np), ((0, xp.shape[0] - C), (0, 0)))
    want = jtower._tower_bwd_pallas(gp, xp, xs, mask8, eot_chunks, *jw, heads=HEADS,
                                    interpret=True)[:C, :L]

    x = torch.from_numpy(x_np).to(TDT[kind])
    tw = torch_weights(w, kind)
    # the same residuals: the reference's block outputs in the port's layout
    blocks = torch.from_numpy(unchunk_blocks(xs, L)).to(TDT[kind])
    got = texttower.text_tower_bwd_plain(torch.from_numpy(g_np), x, blocks,
                                         torch.from_numpy(onehot), *tw, HEADS)
    assert got.dtype == TDT[kind] and tuple(got.shape) == (C, L, D)
    assert rel_err(got, want) <= tol


@pytest.mark.parametrize("L", [16, 13])
def test_text_tower_bwd_plain_matches_autograd_f32(L):
    w = make_weights()
    x_np, onehot, g_np = make_inputs(L)
    tw = torch_weights(w, "f32")
    eot, g = torch.from_numpy(onehot), torch.from_numpy(g_np)
    x = torch.from_numpy(x_np).requires_grad_(True)
    out = texttower.text_tower_plain(x, eot, *tw, HEADS)
    (want,) = torch.autograd.grad(out, x, g)
    with torch.no_grad():
        _, blocks = texttower.text_tower_plain(x, eot, *tw, HEADS, return_blocks=True)
        got = texttower.text_tower_bwd_plain(g, x.detach(), blocks, eot, *tw, HEADS)
    assert rel_err(got, want) <= 1e-4


def test_fused_text_tower_function_input_and_weight_gradients():
    w = make_weights()
    x_np, onehot, _ = make_inputs(13)
    eot = torch.from_numpy(onehot)

    def grads(fn):
        x = torch.from_numpy(x_np).requires_grad_(True)
        tw = [t.requires_grad_(True) for t in torch_weights(w, "f32")]
        out = fn(x, eot, *tw, HEADS)
        return torch.autograd.grad(out.sin().sum(), [x, *tw])

    want = grads(texttower.text_tower_plain)
    got = grads(texttower.fused_text_tower)
    assert rel_err(got[0], want[0]) <= 1e-4
    for name, a, b in zip(WEIGHT_NAMES, got[1:], want[1:]):
        assert a is not None and float(b.abs().max()) > 0, name
        assert rel_err(a, b) <= 1e-4, name

    # the reference's weight cotangents (its twin's) are the same numbers
    jw = jax_weights(w, "f32")
    jg = jax.grad(lambda ws: jnp.sum(jnp.sin(jtower.fused_text_tower(
        jnp.asarray(x_np), jnp.asarray(onehot), *ws, HEADS))))(jw)
    for name, a, b in zip(WEIGHT_NAMES, got[1:], jg):
        assert rel_err(a, b) <= 1e-4, name


def test_fused_text_tower_saves_nothing_without_gradients(monkeypatch):
    w = make_weights()
    x_np, onehot, _ = make_inputs(16)
    tw = torch_weights(w, "f32")
    calls = []
    real = texttower.tower_forward

    def spy(x0, eot, weights, heads, want_blocks=False):
        calls.append(want_blocks)
        return real(x0, eot, weights, heads, want_blocks=want_blocks)

    monkeypatch.setattr(texttower, "tower_forward", spy)
    x = torch.from_numpy(x_np).requires_grad_(True)
    with torch.no_grad():
        out = texttower.fused_text_tower(x, torch.from_numpy(onehot), *tw, HEADS)
    assert not out.requires_grad
    out = texttower.fused_text_tower(x.detach(), torch.from_numpy(onehot), *tw, HEADS)
    assert not out.requires_grad
    out = texttower.fused_text_tower(x, torch.from_numpy(onehot), *tw, HEADS)
    assert out.requires_grad
    assert calls == [False, False, True]  # only a wanted d_x0 takes the residual variant


@pytest.mark.parametrize("launch,kernel", [
    (lambda x, w: textblock._launch(x, [t[0] for t in w[:12]], 3), "fused_text_block"),
    (lambda x, w: texttower._launch_forward(x, torch.zeros(C, x.shape[1]), w, 3, False),
     "fused_text_tower"),
    (lambda x, w: texttower._launch_backward(torch.zeros(C, E), x, torch.zeros(0), x[..., 0],
                                             w, 3), "fused_text_tower_bwd"),
])
def test_kernels_refuse_shapes_by_name(launch, kernel):
    tw = torch_weights(make_weights(), "f32")
    x = torch.zeros(C, 16, D)
    with pytest.raises(ValueError, match=kernel + ".*head count"):
        launch(x, tw)  # 128 wide does not split into 3 heads


def test_kernels_refuse_long_rows_and_other_dtypes():
    with pytest.raises(ValueError, match="fused_text_tower_bwd: L=200"):
        textblock.check_text_shapes("fused_text_tower_bwd", 200, 512, 8, 2048, torch.float32,
                                    backward=True)
    with pytest.raises(ValueError, match="head dim 256"):
        textblock.check_text_shapes("fused_text_block", 16, 512, 2, 2048, torch.float32)
    with pytest.raises(ValueError, match="head dim 40 must be a multiple of 16"):
        textblock.check_text_shapes("fused_text_block", 16, 80, 2, 320, torch.bfloat16)
    textblock.check_text_shapes("fused_text_tower_bwd", 77, 512, 8, 2048, torch.bfloat16,
                                backward=True)  # the published tower at full context
    tw = torch_weights(make_weights(), "f32")
    with pytest.raises(TypeError, match="fused_text_tower"):
        texttower._launch_forward(torch.zeros(C, 16, D, dtype=torch.float16),
                                  torch.zeros(C, 16), tw, HEADS, False)


@pytest.mark.parametrize("D,heads,hid,match", [
    (128, 4, 324, "hidden 324 must be a multiple of 8"),
    (96, 4, 384, "head dim 24 must be a multiple of 16"),
], ids=["hidden", "head-dim"])
def test_bf16_kernels_refuse_what_tma_and_the_mma_cannot_take(D, heads, hid, match):
    """bf16 only: the GEMMs load rows by TMA (16-byte rows), the attention's
    products step 16 deep; f32 takes both shapes."""
    with pytest.raises(ValueError, match="fused_text_tower: .*" + match):
        textblock.check_text_shapes("fused_text_tower", 16, D, heads, hid, torch.bfloat16)
    textblock.check_text_shapes("fused_text_tower", 16, D, heads, hid, torch.float32)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [100, 1032])
def test_kernels_refuse_widths_the_layernorm_cannot_take(D, dt):
    """Both dtypes: the LayerNorm kernels take a row a warp, at most 1024
    wide, the backward in 16-byte chunks."""
    with pytest.raises(ValueError, match=f"fused_text_block: width {D} must be a multiple of 8"):
        textblock.check_text_shapes("fused_text_block", 16, D, 4, 4 * D, dt)


@pytest.mark.parametrize("backward", [False, True])
def test_bf16_attention_takes_at_most_128_positions(backward):
    """The bf16 attention keeps a class's scores in registers, 8 key tiles of
    16: L = 128 passes, L = 129 is refused by name; f32 is bounded by its
    shared memory alone (its backward's two score matrices pass 227 KB at
    L = 129)."""
    name = "fused_text_tower_bwd" if backward else "fused_text_tower"
    textblock.check_text_shapes(name, 128, 512, 8, 2048, torch.bfloat16, backward=backward)
    with pytest.raises(ValueError, match=name + ": L=129 exceeds the bf16 attention's 128"):
        textblock.check_text_shapes(name, 129, 512, 8, 2048, torch.bfloat16, backward=backward)
    if backward:
        with pytest.raises(ValueError, match=name + ": L=129 .* bytes of shared memory"):
            textblock.check_text_shapes(name, 129, 512, 8, 2048, torch.float32, backward=True)
    else:
        textblock.check_text_shapes(name, 129, 512, 8, 2048, torch.float32)


def test_bf16_attention_shared_memory_mirrors_the_kernels():
    """attention_smem against csrc/text.cu's layout: bf16 [Lp][d + 8] tiles
    (3 forward, 4 backward) and, backward, T(P) and T(dS) as [Lp][Lp + 8],
    Lp = L padded to 16; ATT_MAX_L as the source declares it. At CLIP's
    full context and head dim 64 one block takes 34,560 / 74,240 bytes
    (the f32 kernels 84,084 / 127,820), and at the bf16 limit, head dim
    128, 208,896: every L the bf16 attention takes fits."""
    import pathlib
    import re

    src = (pathlib.Path(textblock.__file__).parent.parent / "csrc" / "text.cu").read_text()
    assert int(re.search(r"constexpr int ATT_MAX_L = (\d+);", src).group(1)) == \
        textblock.ATT_MAX_L
    bf16, f32 = torch.bfloat16, torch.float32
    assert textblock.attention_smem(77, 64, bf16) == 2 * 3 * 80 * 72 == 34560
    assert textblock.attention_smem(77, 64, bf16, True) == 2 * (4 * 80 * 72 + 2 * 80 * 88)
    assert textblock.attention_smem(77, 64, bf16, True) == 74240
    assert textblock.attention_smem(77, 64, f32) == 4 * (3 * 77 * 65 + 77 * 77 + 77) == 84084
    assert textblock.attention_smem(77, 64, f32, True) == 127820
    assert textblock.attention_smem(128, 128, bf16, True) == 208896 <= textblock.SMEM_LIMIT


def _misaligned(*shape, dt=torch.bfloat16):
    """A contiguous tensor whose base sits 2 bytes past a 16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 8, dtype=dt)[1:n + 1].view(*shape)


@pytest.mark.parametrize("which", ["x0", "win", "wproj", "xs"])
def test_tower_refuses_what_tma_cannot_load(which):
    """The bf16 GEMMs read the weights, and the tower input and saved block
    outputs as residuals, by TMA: a base off a 16-byte boundary is refused
    by name before any launch (here on CPU tensors, which reach the check
    only through the launch functions)."""
    L = 16
    tw = torch_weights(make_weights(), "bf16")
    x = torch.zeros(C, L, D, dtype=torch.bfloat16)
    xs = torch.zeros(DEPTH, C * L, D, dtype=torch.bfloat16)
    if which == "x0":
        x = _misaligned(C, L, D)
    elif which == "xs":
        xs = _misaligned(DEPTH, C * L, D)
    else:
        i = WEIGHT_NAMES.index(which)
        tw[i] = _misaligned(*tw[i].shape).copy_(tw[i])
    eot = torch.zeros(C, L)
    with pytest.raises(ValueError, match=f"fused_text_tower_bwd: TMA needs 16-byte aligned "
                                         f"bases; {which}"):
        texttower._launch_backward(torch.zeros(C, E), x, xs, eot, tw, HEADS)
    if which != "xs":
        with pytest.raises(ValueError, match=f"fused_text_tower: TMA needs 16-byte aligned "
                                             f"bases; {which}"):
            texttower._launch_forward(x, eot, tw, HEADS, False)


@pytest.mark.parametrize("dname,which", [("f32", "x0"), ("f32", "xs"), ("f32", "ln1s"),
                                         ("f32", "ln2s"), ("bf16", "ln1s"), ("bf16", "ln2s")])
def test_tower_bwd_refuses_what_the_layernorm_cannot_load(dname, which):
    """The LayerNorm backward reads the tower input, the saved block outputs
    and the f32 LayerNorm scales in 16-byte chunks in either dtype, where
    TMA's check covers only bf16 tensors: a base off a 16-byte boundary is
    refused by name before any launch."""
    L, dt = 16, getattr(torch, {"f32": "float32", "bf16": "bfloat16"}[dname])
    tw = torch_weights(make_weights(), dname)
    x = torch.zeros(C, L, D, dtype=dt)
    xs = torch.zeros(DEPTH, C * L, D, dtype=dt)
    if which == "x0":
        x = _misaligned(C, L, D, dt=dt)
    elif which == "xs":
        xs = _misaligned(DEPTH, C * L, D, dt=dt)
    else:
        i = WEIGHT_NAMES.index(which)
        tw[i] = _misaligned(*tw[i].shape, dt=torch.float32).copy_(tw[i])
    with pytest.raises(ValueError, match=f"fused_text_tower_bwd: the LayerNorm backward loads "
                                         f"16-byte chunks; {which} is not"):
        texttower._launch_backward(torch.zeros(C, E), x, xs, torch.zeros(C, L), tw, HEADS)


# ---------------------------------------------------------------------------
# TextTransformer's three routes, and the slice as a whole
# ---------------------------------------------------------------------------
ROUTE_ENV = {"off": {}, "block": {"PPT_FUSED_TEXT": "1"}, "tower": {"PPT_FUSED_TEXT_TOWER": "1"}}


def _set_route(monkeypatch, route):
    for k in ("PPT_FUSED_TEXT", "PPT_FUSED_TEXT_TOWER", "PPT_FORCE_XLA_ATTN"):
        monkeypatch.delenv(k, raising=False)
    for k, v in ROUTE_ENV[route].items():
        monkeypatch.setenv(k, v)


def _text_pair(route, L=16, layers=2):
    from ppt_tpu.nn.text import TextConfig as JaxTextConfig
    from ppt_tpu.nn.text import TextTransformer as JaxText
    from ppt_torch.convert import from_jax
    from ppt_torch.nn.text import TextConfig, TextTransformer

    kw = dict(vocab_size=512, width=128, layers=layers, heads=4, embed_dim=128)
    rng = np.random.RandomState(3)
    x = rng.randn(C, L, 128).astype(np.float32)
    eot = rng.randint(1, L, C).astype(np.int32)
    jtext = JaxText(JaxTextConfig(**kw))
    tokens = jnp.asarray(rng.randint(0, 512, (C, L)).astype(np.int32))
    params = jax.tree_util.tree_map(
        np.asarray, jtext.init(jax.random.PRNGKey(0), tokens, jnp.asarray(eot),
                               method=lambda m, t, e: m(m.embed(t), e))["params"])
    text = TextTransformer(TextConfig(**kw), fused=route)
    text.load_state_dict(from_jax(params, {}, text))
    return jtext, params, text, x, eot


@pytest.mark.parametrize("route", ["off", "block", "tower"])
def test_text_transformer_routes_match_reference(route, monkeypatch):
    jtext, params, text, x, eot = _text_pair(route)
    _set_route(monkeypatch, route)

    def jloss(xx):
        return jnp.sum(jnp.sin(jtext.apply({"params": params}, xx, jnp.asarray(eot))))

    want = jtext.apply({"params": params}, jnp.asarray(x), jnp.asarray(eot))
    want_grad = jax.grad(jloss)(jnp.asarray(x))

    for p in text.parameters():
        p.requires_grad_(False)
    tx = torch.from_numpy(x).requires_grad_(True)
    got = text(tx, torch.from_numpy(eot))
    (got_grad,) = torch.autograd.grad(got.sin().sum(), tx)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    assert rel_err(got_grad, want_grad) <= 2e-4


def test_text_transformer_rejects_unknown_route():
    from ppt_torch.nn.text import TextTransformer

    with pytest.raises(ValueError, match="text route"):
        TextTransformer(fused="towers")


@pytest.mark.parametrize("route", ["block", "tower"])
def test_cast_weights_are_cached_until_a_source_changes(route):
    _, _, text, x, eot = _text_pair(route)
    for p in text.parameters():
        p.requires_grad_(False)
    tx, teot = torch.from_numpy(x), torch.from_numpy(eot)

    def copies():  # one cache on the tower serves both routes
        return text.stacked_weights()[:12]

    before = text(tx, teot)
    first = copies()
    assert all(a is b for a, b in zip(first, copies()))  # built once, not per call
    assert tuple(first[2].shape) == (2, 128, 384) and not first[2].requires_grad
    assert not hasattr(text.block_0, "_cache")

    state = {k: v.clone() for k, v in text.state_dict().items()}
    state["block_0.c_fc.kernel"] = state["block_0.c_fc.kernel"] * 1.5
    text.load_state_dict(state)
    after = text(tx, teot)
    assert float((after - before).abs().max()) > 1e-4  # the new weight is in use
    assert torch.equal(text.stacked_weights()[8][0], state["block_0.c_fc.kernel"])

    # a weight that trains stays in the autograd graph instead of a cached copy
    text.block_1.c_proj.kernel.requires_grad_(True)
    out = text(tx, teot)
    (gw,) = torch.autograd.grad(out.sum(), text.block_1.c_proj.kernel)
    assert float(gw.abs().max()) > 0


def test_fused_text_block_module_needs_the_mask():
    """A block built with ``fused`` launches its kernel or raises: the kernel
    bakes the causal mask in, so a call without one is refused by name; with
    one, a block on its own casts its weights and agrees with the plain block."""
    from ppt_torch.nn.text import TextBlock, causal_mask

    torch.manual_seed(0)
    plain, fused = TextBlock(128, 4), TextBlock(128, 4, fused=True)
    for p in plain.parameters():
        torch.nn.init.normal_(p, std=0.05)
    fused.load_state_dict(plain.state_dict())
    x = torch.randn(C, 13, 128)
    with pytest.raises(ValueError, match="fused_text_block"):
        fused(x)
    mask = torch.from_numpy(causal_mask(13))
    assert rel_err(fused(x, mask), plain(x, mask)) <= 1e-5
    assert rel_err(plain(x), plain(x, mask)) > 1e-3  # the mask is not a no-op


@pytest.mark.parametrize("env,want", [
    ({}, "off"), ({"PPT_FUSED_TEXT": "0", "PPT_FUSED_TEXT_TOWER": "0"}, "off"),
    ({"PPT_FUSED_TEXT": "1"}, "block"), ({"PPT_FUSED_TEXT_TOWER": "1"}, "tower"),
    ({"PPT_FUSED_TEXT": "1", "PPT_FUSED_TEXT_TOWER": "1"}, "tower"),
    ({"PPT_FUSED_TEXT": "1", "PPT_FUSED_TEXT_TOWER": "0"}, "block"),
    ({"PPT_FUSED_TEXT": "true"}, "off"),
])
def test_entry_point_maps_the_reference_switches(env, want, monkeypatch):
    from ppt_torch.tasks import cls

    _set_route(monkeypatch, "off")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert cls.text_route_from_env() == want


def test_setup_passes_the_route_down(monkeypatch, tmp_path):
    from ppt_torch.nn.pointbert import PointBertConfig
    from ppt_torch.nn.text import TextConfig
    from ppt_torch.tasks import cls
    from ppt_torch.tasks.args import TaskArgs

    def model_for(route):
        _set_route(monkeypatch, route)
        args = TaskArgs(dataset_name="synthetic", npoints=64, batch_size=4, device="cpu",
                        pretrained_dir="", num_learnable_prompt_tokens=4,
                        output_dir=str(tmp_path))
        args.pointbert_config = PointBertConfig(trans_dim=32, depth=1, num_heads=2, group_size=8,
                                                num_group=8, encoder_dims=32)
        args.text_config = TextConfig(vocab_size=49408, width=64, layers=2, heads=4,
                                      embed_dim=64)
        return cls.setup(args)["model"]

    for route in ("off", "block", "tower"):
        text = model_for(route).text
        assert text.fused == route
        assert [text.block_0.fused, text.block_1.fused] == [route == "block"] * 2


def test_ulip_prompt_grads_through_fused_tower(monkeypatch):
    """d loss / d learnable prompt tokens through the fused tower, against
    the reference on the same route."""
    import flax
    import optax

    from ppt_tpu.models import PromptArrays as JaxPrompts
    from ppt_tpu.models import Ulip as JaxUlip
    from ppt_tpu.nn import PointBert as JaxPointBert
    from ppt_tpu.nn import PointBertConfig as JaxBertConfig
    from ppt_tpu.nn import TextConfig as JaxTextConfig
    from ppt_tpu.prompt import build_prompt_spec as jax_spec
    from ppt_torch.convert import from_jax
    from ppt_torch.models.ulip import PromptArrays, build_model
    from ppt_torch.nn.pointbert import PointBertConfig
    from ppt_torch.nn.text import TextConfig
    from ppt_torch.prompt.learner import build_prompt_spec
    from ppt_torch.tasks.args import TaskArgs

    bert = dict(trans_dim=48, depth=1, num_heads=4, group_size=8, num_group=16,
                encoder_dims=32, drop_path_rate=0.0)
    text = dict(width=128, layers=2, heads=4, embed_dim=128)
    names = ["chair", "table", "airplane"]
    _set_route(monkeypatch, "tower")
    jmodel = JaxUlip(point_encoder=JaxPointBert(JaxBertConfig(**bert)), pc_feat_dims=96,
                     n_ctx=4, text_config=JaxTextConfig(**text))
    jprompts = JaxPrompts.from_spec(jax_spec(names, n_ctx=4, class_name_position="middle"))
    pc = np.random.RandomState(0).rand(2, 64, 3).astype(np.float32)
    labels = np.array([0, 2])
    variables = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0), jnp.asarray(pc), jprompts))

    def jloss(ctx):
        params = flax.core.unfreeze(variables["params"])
        params["prompt_learner"]["learnable_tokens"] = ctx
        logits = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              jnp.asarray(pc), jprompts)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean()

    ctx0 = jnp.asarray(variables["params"]["prompt_learner"]["learnable_tokens"])
    l_want, g_want = jax.value_and_grad(jloss)(ctx0)

    args = TaskArgs(num_learnable_prompt_tokens=4, class_name_position="middle")
    args.pointbert_config = PointBertConfig(**bert)
    args.text_config = TextConfig(**text)
    model = build_model("ULIP_PointBERT", args, device="cpu", text_fused="tower").model
    model.load_state_dict(from_jax(variables["params"], variables["batch_stats"], model))
    for p in model.parameters():
        p.requires_grad_(False)
    tokens = model.prompt_learner.learnable_tokens.requires_grad_(True)
    prompts = PromptArrays.from_spec(
        build_prompt_spec(names, n_ctx=4, class_name_position="middle"), device="cpu")
    logits = model(torch.from_numpy(pc), prompts)
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels))
    (g_got,) = torch.autograd.grad(loss, tokens)
    assert abs(float(loss.detach()) - float(l_want)) < 1e-4
    assert rel_err(g_got, g_want) < 1e-3
