"""Port vs reference: the Stratified Transformer.

``ppt_torch.nn.stratified`` against ``ppt_tpu.nn.stratified`` on the same
numpy inputs and the same weights (drawn on the port's module, carried into
the flax tree by the weight bridge's name rule), the JAX side jitted on the
CPU. The clouds lie on a 1/64 lattice, so every kNN and FPS distance is
exact in f32 on both sides and the neighbourhoods are the same.

Exact: the window ids (shifted or not), the member tables with both
overflow cases of the reference's write order, the key tables and their
overflow, the quantised relative indices, the downsampling FPS and the
kernel dispositions. Within 1e-5 of the output's max magnitude (f32): the
eval outputs of ``KPConv``, the window attention (both tables, and each
alone) and the whole model (with and without the KPConv residual stem);
the model's parameter gradients within 1e-4 of their max against
``jax.grad``.
Within 1e-4: a training-mode forward's running statistics and its logits,
and ``window_overflow`` against the reference's ``diagnostics`` (exact,
being a count). The small config's windows hold a few to tens of points
at each layer, and the caps are generous except where a test overflows
them on purpose.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_classic import randomise, variables_from_port
from test_torch_pointnet2 import close, lattice_cloud, np_tree, stats_close

from ppt_torch.convert import from_jax
from ppt_torch.kernels import group as kgroup
from ppt_torch.nn import stratified as ts

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores

# windows of 0.64 m at layer 1 and 1.28 m at layer 2 over unit-cube clouds;
# the stem's ball radius 2.5 x 0.02 x 4 = 0.2 m
STRAT_CFG = dict(depths=(1, 2, 1), channels=(8, 16, 32), num_heads=(2, 4, 4), grid_size=0.02,
                 sigma=4.0, quant_size=0.04, num_classes=5, k=4, fine_cap=32, coarse_cap=64,
                 drop_path_rate=0.0)


def strat(**kw):
    from ppt_tpu.nn.stratified import StratifiedConfig, StratifiedSeg

    cfg = {**STRAT_CFG, **kw}
    return (StratifiedSeg(StratifiedConfig(**cfg)),
            ts.StratifiedSeg(ts.StratifiedConfig(**cfg), feat_channels=3))


def pair_strat(jmod, tmod, *inputs, seed=2, **kw):
    """``test_torch_classic.pair`` for modules that sow ``diagnostics`` or
    hold leaves no Dense holds: the flax parameters and statistics with the
    port's random weights, those leaves drawn too (by the module's
    ``init_leaves_``, else Stratified's for its KPConv weights and relative
    tables)."""
    randomise(tmod, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    if hasattr(tmod, "init_leaves_"):
        tmod.init_leaves_(gen)
    else:
        ts.init_leaves_(tmod, gen)
    shapes = jax.eval_shape(lambda k, *x: jmod.init(k, *x, **kw), jax.random.PRNGKey(0),
                            *[None if x is None else jnp.asarray(x) for x in inputs])
    shapes = {k: v for k, v in shapes.items() if k != "diagnostics"}
    variables = variables_from_port(shapes, tmod)
    tmod.load_state_dict(from_jax(variables["params"], variables.get("batch_stats", {}), tmod))
    return variables, tmod


def inputs(B=2, N=256, seed=1):
    return lattice_cloud(B, N, seed), np.random.RandomState(seed + 1).rand(B, N, 3).astype(
        np.float32)


def packed(B=2, n=128, seed=3, scale=1.0):
    xyz = lattice_cloud(B, n, seed).reshape(B * n, 3) * scale
    offsets = np.arange(1, B + 1, dtype=np.int32) * n
    seg = np.repeat(np.arange(B, dtype=np.int32), n)
    return xyz, offsets, seg


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("size,nw", [(0.25, 256), (0.1, 64), (0.64, 4)])
def test_window_ids_exact(shift, size, nw):
    from ppt_tpu.nn.stratified import window_ids

    xyz, _, seg = packed(scale=2.5)
    want = jax.jit(window_ids, static_argnums=(2, 3, 4))(jnp.asarray(xyz), jnp.asarray(seg),
                                                         size, shift, nw)
    got = ts.window_ids(torch.from_numpy(xyz), torch.from_numpy(seg), size, shift, nw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("win,nw,cap", [
    ([3] * 10 + [1, 1], 4, 4),  # the highest window overflows: its rank cap-1 is lost
    ([0] * 10 + [3] * 4, 4, 4),  # another window overflows: the highest keeps its members
    ("random", 16, 5),
])
def test_member_table_exact_with_the_overflow_rule(win, nw, cap):
    from ppt_tpu.nn.stratified import member_table

    if win == "random":
        win = np.random.RandomState(0).randint(0, nw, 120)
    win = np.asarray(win, np.int32)
    wm, wv = jax.jit(member_table, static_argnums=(1, 2))(jnp.asarray(win), nw, cap)
    gm, gv = ts.member_table(torch.from_numpy(win).long(), nw, cap)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    if win.tolist() == [3] * 10 + [1, 1]:
        assert gm[3].tolist() == [0, 1, 2, 12]
    if win.tolist() == [0] * 10 + [3] * 4:
        assert gm[3].tolist() == [10, 11, 12, 13]


@pytest.mark.parametrize("shift,window,fine_cap,coarse_cap", [
    (False, 0.35, 32, 64), (True, 0.35, 32, 64), (False, 0.5, 6, 9)])
def test_stratified_keys_exact(shift, window, fine_cap, coarse_cap):
    """Index and valid tables and the overflow, the last case truncated."""
    from ppt_tpu.nn.stratified import stratified_keys
    from ppt_tpu.ops.ragged import farthest_point_sample_packed

    xyz, offsets, seg = packed()
    ji, jv, jo = jax.jit(stratified_keys, static_argnums=(3, 4, 5, 6, 7))(
        jnp.asarray(xyz), jnp.asarray(seg), jnp.asarray(offsets), window, shift, fine_cap,
        coarse_cap, 16)
    ti, tv, to = ts.stratified_keys(torch.from_numpy(xyz), torch.from_numpy(seg), (128, 256),
                                    window, shift, fine_cap, coarse_cap, 16)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert to.dim() == 0 and int(to) == int(jo)
    assert (int(to) > 0) == (fine_cap == 6)
    ds, _ = ts.downsample_flags(torch.from_numpy(xyz), (128, 256), 16)
    np.testing.assert_array_equal(ds.numpy(), np.asarray(farthest_point_sample_packed(
        jnp.asarray(xyz), jnp.asarray(offsets), 16)))


@pytest.mark.parametrize("cloud", ["lattice", "random"])
def test_relative_index_exact(cloud):
    """The quantised offsets against the reference's expression
    (``ppt_tpu/nn/stratified.py:159-165``), jitted."""
    window, quant = 0.64, 0.08
    L = ts.table_size(window, quant)
    if cloud == "lattice":
        xyz = lattice_cloud(1, 300, 5)[0]
    else:
        xyz = (np.random.RandomState(5).rand(300, 3) * 1.1).astype(np.float32)
    safe = np.random.RandomState(6).randint(0, 300, (300, 40))

    def ref(xyz, safe):
        rel = xyz[:, None, :] - xyz[safe]
        rel = jnp.round(rel * 100000) / 100000
        ridx = jnp.floor((rel + 2 * window - 0.0001) / quant).astype(jnp.int32)
        return jnp.clip(ridx, 0, 2 * L - 1)

    want = np.asarray(jax.jit(ref)(jnp.asarray(xyz), jnp.asarray(safe)))
    got = ts.relative_index(torch.from_numpy(xyz), torch.from_numpy(safe), window, quant)
    np.testing.assert_array_equal(got.numpy(), want)
    assert L == 16 and 0 < want.min() and want.max() < 2 * L - 1  # no clip hides a difference


def test_kernel_dispositions_exact():
    from ppt_tpu.nn.stratified import kernel_dispositions

    for n in (15, 8):
        np.testing.assert_array_equal(ts.kernel_dispositions(n), kernel_dispositions(n))


def _keys_inputs():
    xyz, offsets, seg = packed()
    keys = ts.stratified_keys(torch.from_numpy(xyz), torch.from_numpy(seg), (128, 256), 0.35,
                              False, 32, 64, 16)
    return xyz, keys


def test_kpconv_matches_flax():
    from ppt_tpu.nn.stratified import KPConv

    xyz, _, _ = packed()
    feats = np.random.RandomState(4).randn(256, 6).astype(np.float32)
    nbr, d2 = (np.asarray(t) for t in ts.ragged.knn_query_packed(
        8, torch.from_numpy(xyz), (128, 256), torch.from_numpy(xyz), (128, 256)))
    valid = d2 <= 0.2 * 0.2
    jmod, tmod = KPConv(10, 0.08), ts.KPConv(6, 10, 0.08)
    args = (xyz, feats, nbr, valid)
    variables, tmod = pair_strat(jmod, tmod, *args)
    want = jax.jit(jmod.apply)(variables, *[jnp.asarray(a) for a in args])
    with torch.no_grad():
        got = tmod(*[torch.from_numpy(a) for a in args])
    close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("rel_query,rel_key", [(True, True), (True, False), (False, True)])
def test_window_attention_matches_flax(rel_query, rel_key):
    from ppt_tpu.nn.stratified import StratifiedWindowAttention

    xyz, (kidx, kvalid, _) = _keys_inputs()
    feats = np.random.RandomState(7).randn(256, 16).astype(np.float32)
    jmod = StratifiedWindowAttention(16, 4, 0.35, 0.05, rel_query=rel_query, rel_key=rel_key)
    tmod = ts.StratifiedWindowAttention(16, 4, 0.35, 0.05, rel_query=rel_query,
                                        rel_key=rel_key)
    args = (feats, xyz, kidx.numpy(), kvalid.numpy())
    variables, tmod = pair_strat(jmod, tmod, *args)
    want = jax.jit(jmod.apply)(variables, *[jnp.asarray(a) for a in args])
    with torch.no_grad():
        got = tmod(*[torch.from_numpy(a) for a in args])
    close(got.numpy(), want, 1e-5)


def test_stratified_seg_eval_matches_flax_without_the_residual_stem():
    """(The default stem is held by the gradients' test.)"""
    jmod, tmod = strat(stem_transformer=True)
    xs = inputs()
    variables, tmod = pair_strat(jmod, tmod, *xs)
    want, mut = jax.jit(lambda v, *a: jmod.apply(v, *a, mutable=["diagnostics"]))(
        variables, *[jnp.asarray(x) for x in xs])
    with torch.no_grad():
        got = tmod(*[torch.from_numpy(x) for x in xs])
    close(got.numpy(), want, 1e-5)
    assert int(tmod.window_overflow) == int(mut["diagnostics"]["window_overflow"])


def test_stratified_seg_training_mode_and_overflow_match_flax():
    """Running statistics within 1e-4 after a training-mode forward, whose
    windows overflow their caps (fine 4, coarse 6): ``window_overflow``
    equals the reference's sown maximum, and the truncated key sets give
    the same logits."""
    jmod, tmod = strat(fine_cap=4, coarse_cap=6)
    xs = inputs(seed=5)
    variables, tmod = pair_strat(jmod, tmod, *xs)
    want, mut = jax.jit(lambda v, *a: jmod.apply(v, *a, train=True,
                                                 mutable=["batch_stats", "diagnostics"]))(
        variables, *[jnp.asarray(x) for x in xs])
    with torch.no_grad():
        got = tmod(*[torch.from_numpy(x) for x in xs], train=True)
    close(got.numpy(), want, 1e-4)
    stats_close(tmod, np_tree(mut["batch_stats"]), variables["batch_stats"], atol=1e-4)
    overflow = int(mut["diagnostics"]["window_overflow"])
    assert overflow > 0 and int(tmod.window_overflow) == overflow


def gradients_match_jax(jmod, tmod, xs, tol=1e-4):
    """The eval output within 1e-5, and d/dparams of ``sum(out * R)`` (R
    fixed) for every parameter within ``tol`` of the gradients' max
    magnitude, against ``jax.grad`` of the same functional."""
    from ppt_torch.convert import _port_key

    variables, tmod = pair_strat(jmod, tmod, *xs)
    jin = [jnp.asarray(x) for x in xs]
    tin = [torch.from_numpy(x) for x in xs]
    with torch.no_grad():
        shape = tmod(*tin).shape
    r = np.random.RandomState(9).randn(*shape).astype(np.float32)

    def jloss(params):
        out = jmod.apply({**variables, "params": params}, *jin)
        return jnp.sum(out * r), out

    jgrads, jout = jax.jit(jax.grad(jloss, has_aux=True))(variables["params"])
    out = tmod(*tin)
    close(out.detach().numpy(), jout, 1e-5)
    (out * torch.from_numpy(r)).sum().backward()
    grads = {k: p.grad for k, p in tmod.named_parameters()}
    want = jax.tree_util.tree_leaves_with_path(jgrads)
    scale = max(float(np.max(np.abs(np.asarray(g)))) for _, g in want)
    assert len(want) == len(grads)
    for path, g in want:
        key = _port_key(tuple(p.key for p in path), False)
        worst = float(np.max(np.abs(grads[key].numpy() - np.asarray(g))))
        assert worst <= tol * scale, (key, worst / scale)


def test_stratified_seg_gradients_match_jax():
    """The eval logits, and the gradients through the factored relative
    bias, the key gathers (padding read from the query's own row) and the
    KPConv residual stem."""
    gradients_match_jax(*strat(), inputs(seed=7))


def test_fps_launches_a_forward(monkeypatch):
    """One FPS for the stem's transition and one a layer, the layer's shared
    with the transition after it."""
    seen = []
    real = kgroup.fps_batched
    monkeypatch.setattr(kgroup, "fps_batched",
                        lambda x, n: seen.append((tuple(x.shape), n)) or real(x, n))
    _, tmod = strat()
    randomise(tmod, 2)
    with torch.no_grad():
        tmod(*[torch.from_numpy(x) for x in inputs()])
    assert seen == [((2, 256, 3), 64), ((2, 64, 3), 16), ((2, 16, 3), 4)]


def test_drop_path_drops_whole_points():
    """In training each packed point's branch is dropped or kept whole, the
    kept ones scaled by 1 / keep."""
    h = torch.ones(400, 6)
    out = ts._drop_path(h, 0.5, True, torch.Generator().manual_seed(0))
    rows = set(map(tuple, out.tolist()))
    assert rows == {(0.0,) * 6, (2.0,) * 6}
    assert torch.equal(ts._drop_path(h, 0.5, False, None), h)
