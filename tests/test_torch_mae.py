"""Port vs reference: the masked-point autoencoder (``MaskedPointMAE``).

``ppt_torch.nn.mae`` against ``ppt_tpu.nn.mae`` at ``tests/test_mae.py``'s
config (16 groups of 8, 32 / 48 wide, depth 2, decoder depth 1, 4 heads),
f32, on clouds on a 1/64 lattice so that FPS and kNN pick alike. The
weights are drawn on the port's module (Dense kernels lecun-normal, biases,
LayerNorm and BatchNorm affine and statistics non-trivial, the mask token
normal(0.02)) and carried into the flax tree, whose shapes come from
``jax.eval_shape`` of its init, by the weight bridge's name rule; the
reference's masking noise, the ``jax.random.uniform`` draw inside its
``random_patch_masking``, is read out of the jitted call and handed to the
port. The reference's MiniPointNet runs its Pallas kernels interpreted
(as on its chip); its ``VitBlock`` runs unfused on the CPU, the port's on
route "block", whose plain version serves CPU tensors. The reference's
eval forward and training step are one program, jitted once for the file
(its compile is most of the time).

- ``random_patch_masking``: ids and mask equal to the reference's, exactly;
- the eval forward's loss and ``pred`` within 1e-5 of their max;
- the training forward's loss within 1e-4 (relative) and its BatchNorm
  running statistics within 1e-4;
- every parameter's gradient of the training loss within 1e-4 of the
  largest gradient, against ``jax.grad``;
- three Adam(1e-3) steps' losses against ``optax.adam(1e-3)``'s within 1e-4
  (relative): a gradient of rounding noise (a Dense bias before a
  train-mode BatchNorm) moves its weight by up to lr with either sign
  under Adam, which the batch statistics then cancel in the loss;
- ``from_jax`` carries the whole tree with no leaf left over;
- a training forward calls each kernel wrapper as the card's step launches
  it: one grouping, one ``mini_stats``, one ``mini_forward``, one block
  kernel a block.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_classic import randomise, variables_from_port
from test_torch_pointnet2 import close, lattice_cloud, np_tree, stats_close

from ppt_torch.convert import _port_key, from_jax
from ppt_torch.nn import mae as tmae
from ppt_torch.nn import pointbert as tpb

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores

CFG = dict(num_group=16, group_size=8, mask_ratio=0.5, encoder_dims=32, trans_dim=48, depth=2,
           decoder_depth=1, num_heads=4)
B, N = 2, 128


@pytest.fixture
def fused_mini(monkeypatch):
    """The reference's fused MiniPointNet forced, as on its chip (read when
    its programs are traced, on first use)."""
    monkeypatch.setenv("PPT_FORCE_FUSED_MINI", "1")


def with_noise(fn):
    """``fn`` tracing the reference with its masking draw read out: while
    it traces, ``random_patch_masking`` also hands over the [B, L]
    ``jax.random.uniform`` draw it makes, and ``fn(box, *a)`` returns it."""
    from ppt_tpu.nn import mae as jmae

    def traced(*a):
        real, box = jmae.random_patch_masking, []

        def spy(key, num_group, mask_ratio, batch):
            box.append(jax.random.uniform(key, (batch, num_group)))
            return real(key, num_group, mask_ratio, batch)

        jmae.random_patch_masking = spy
        try:
            return fn(box, *a)
        finally:
            jmae.random_patch_masking = real

    return traced


@functools.lru_cache(maxsize=None)
def reference():
    """(the flax variables' shapes, the reference's one jitted program
    ``(params, stats, pts, key) -> ((eval loss, pred, noise), (training
    loss, new stats, noise, grads))``), built once: the eval forward and
    the training step on the same masking draw."""
    from ppt_tpu.nn.mae import MaeConfig, MaskedPointMAE

    jm = MaskedPointMAE(MaeConfig(**CFG))
    shapes = jax.eval_shape(lambda k, x: jm.init({"params": k, "masking": k}, x),
                            jax.random.PRNGKey(0), jnp.zeros((B, N, 3)))

    def rngs(key):
        return {"masking": key, "dropout": key, "droppath": key}

    def train_loss(box, params, stats, pts, key):
        (loss, _), mut = jm.apply({"params": params, "batch_stats": stats}, pts, train=True,
                                  mutable=["batch_stats"], rngs=rngs(key))
        return loss, (loss, mut["batch_stats"], box[-1])

    def program(box, params, stats, pts, key):
        loss, pred = jm.apply({"params": params, "batch_stats": stats}, pts, rngs=rngs(key))
        evaluated = (loss, pred, box[0])
        grads, aux = jax.grad(lambda p: train_loss(box, p, stats, pts, key), has_aux=True)(params)
        return evaluated, (*aux, grads)

    return shapes, jax.jit(with_noise(program))


def pair(seed=0):
    """(the reference's variables, the port's module with the same weights)."""
    shapes = reference()[0]
    tm = tmae.MaskedPointMAE(tmae.MaeConfig(**CFG))
    randomise(tm, seed)
    with torch.no_grad():
        tm.mask_token.copy_(0.02 * torch.randn(tm.mask_token.shape,
                                               generator=torch.Generator().manual_seed(seed)))
    v = variables_from_port(shapes, tm)
    tm.load_state_dict(from_jax(v["params"], v["batch_stats"], tm))
    return v, tm


@pytest.mark.parametrize("num_group,ratio,batch", [(64, 0.6, 3), (16, 0.75, 3), (16, 0.5, 2),
                                                   (7, 0.3, 4)])
def test_random_patch_masking_matches_reference(num_group, ratio, batch):
    from ppt_tpu.nn.mae import random_patch_masking as jax_masking

    key = jax.random.PRNGKey(num_group + batch)
    want = [np.asarray(t) for t in jax.jit(jax_masking, static_argnums=(1, 2, 3))(
        key, num_group, ratio, batch)]
    noise = np.array(jax.random.uniform(key, (batch, num_group)))
    got = [t.numpy() for t in tmae.random_patch_masking(torch.from_numpy(noise), ratio)]
    assert got[0].shape == (batch, int(num_group * (1 - ratio)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[2].dtype == np.float32
    if (num_group, ratio) == (64, 0.6):
        assert got[0].shape[1] == 25  # int(64 * 0.4): the float expression as written


def test_masking_noise_is_drawn_from_the_generator():
    a = tmae.masking_noise(torch.Generator().manual_seed(3), 2, 16)
    b = tmae.masking_noise(torch.Generator().manual_seed(3), 2, 16)
    assert a.shape == (2, 16) and a.dtype == torch.float32 and torch.equal(a, b)
    ids_keep, ids_restore, mask = tmae.random_patch_masking(a, 0.5)
    for r in range(2):  # the kept ids are the mask's zeros; restore inverts the shuffle
        assert set(ids_keep[r].tolist()) == set(torch.nonzero(mask[r] == 0)[:, 0].tolist())
        assert sorted(ids_restore[r].tolist()) == list(range(16))


def test_from_jax_carries_the_whole_tree():
    v, tm = pair()
    leaves = [k for k, _ in jax.tree_util.tree_flatten_with_path(v["params"])[0]]
    stats = [k for k, _ in jax.tree_util.tree_flatten_with_path(v["batch_stats"])[0]]
    assert len(leaves) + len(stats) == len(tm.state_dict())
    assert {"mask_token", "pos_enc1.kernel", "pos_dec2.bias", "enc_norm.weight",
            "dec_block_0.attn.qkv.kernel", "head.kernel", "encoder.conv2b.kernel",
            "encoder.bn2.running_var"} <= set(tm.state_dict())


def test_eval_forward_matches_flax(fused_mini):
    v, tm = pair()
    pts = lattice_cloud(B, N, 3)
    (loss, pred, noise), _ = reference()[1](v["params"], v["batch_stats"], jnp.asarray(pts),
                                            jax.random.PRNGKey(2))
    with torch.no_grad():
        tloss, tpred = tm(torch.from_numpy(pts), torch.from_numpy(np.array(noise)))
    assert tpred.shape == (B, 16, 8, 3) and tpred.dtype == torch.float32
    close(tpred.numpy(), pred, 1e-5)
    close(tloss.numpy(), loss, 1e-5)


def test_training_forward_matches_flax(fused_mini):
    v, tm = pair(seed=1)
    pts = lattice_cloud(B, N, 4)
    _, (loss, stats, noise, _) = reference()[1](v["params"], v["batch_stats"], jnp.asarray(pts),
                                                jax.random.PRNGKey(5))
    with torch.no_grad():
        tloss, _ = tm(torch.from_numpy(pts), torch.from_numpy(np.array(noise)), train=True)
    close(tloss.numpy(), loss, 1e-4)
    stats_close(tm, np_tree(stats), v["batch_stats"], atol=1e-4)


def test_training_gradients_match_jax(fused_mini):
    """d loss / d params of the training forward, every leaf within 1e-4 of
    the largest gradient."""
    v, tm = pair(seed=2)
    pts = lattice_cloud(B, N, 6)
    _, (jl, _, noise, jgrads) = reference()[1](v["params"], v["batch_stats"], jnp.asarray(pts),
                                               jax.random.PRNGKey(7))
    loss, _ = tm(torch.from_numpy(pts), torch.from_numpy(np.array(noise)), train=True)
    close(loss.detach().numpy(), jl, 1e-4)
    loss.backward()
    grads = {k: p.grad for k, p in tm.named_parameters()}
    want = jax.tree_util.tree_leaves_with_path(jgrads)
    scale = max(float(np.max(np.abs(np.asarray(g)))) for _, g in want)
    assert len(want) == len(grads)
    for path, g in want:
        key = _port_key(tuple(p.key for p in path), False)
        worst = float(np.max(np.abs(grads[key].numpy() - np.asarray(g))))
        assert worst <= 1e-4 * scale, (key, worst / scale)


def test_adam_steps_match_optax(fused_mini):
    """Three Adam(1e-3) training steps in lockstep with ``optax.adam(1e-3)``,
    each step's masking drawn anew (the reference's draw, handed over)."""
    v, tm = pair(seed=3)
    pts = [lattice_cloud(B, N, 10 + i) for i in range(3)]
    opt = optax.adam(1e-3)
    update = jax.jit(lambda g, state, params: (lambda up, st: (optax.apply_updates(params, up),
                                                               st))(*opt.update(g, state)))
    params, bs = v["params"], v["batch_stats"]
    state = opt.init(params)
    topt = torch.optim.Adam(tm.parameters(), lr=1e-3)
    for i in range(3):
        _, (want, bs, noise, g) = reference()[1](params, bs, jnp.asarray(pts[i]),
                                                 jax.random.PRNGKey(20 + i))
        params, state = update(g, state, params)
        topt.zero_grad()
        loss, _ = tm(torch.from_numpy(pts[i]), torch.from_numpy(np.array(noise)), train=True)
        loss.backward()
        topt.step()
        got = float(loss.detach())
        assert np.isfinite(got)
        assert abs(got - float(want)) <= 1e-4 * abs(float(want)), (i, got, float(want))


def test_a_training_forward_calls_each_kernel_wrapper(monkeypatch):
    """The calls a step's launches follow: one grouping (``fps_batched``
    and ``knn_gather``), ``mini_stats`` once (training only), ``mini_forward``
    once, and one ``fused_vit_block`` a block, the encoder's on the kept
    tokens."""
    calls = []

    def spy(name, real):
        def f(*a, **kw):
            calls.append((name, tuple(a[0].shape) if name == "fused_vit_block" else None))
            return real(*a, **kw)
        return f

    for name in ("fused_group", "mini_stats", "mini_forward", "fused_vit_block"):
        monkeypatch.setattr(tpb, name, spy(name, getattr(tpb, name)))
    cfg = tmae.MaeConfig(**CFG)
    tm = tmae.init_mae(tmae.MaskedPointMAE(cfg), 0)
    noise = tmae.masking_noise(torch.Generator().manual_seed(0), B, 16)
    for train in (True, False):
        calls.clear()
        loss, pred = tm(torch.from_numpy(lattice_cloud(B, N, 8)), noise, train=train)
        assert torch.isfinite(loss) and torch.isfinite(pred).all()
        names = [c[0] for c in calls]
        assert names.count("fused_group") == 1 and names.count("mini_forward") == 1
        assert names.count("mini_stats") == (1 if train else 0)
        blocks = [c[1] for c in calls if c[0] == "fused_vit_block"]
        assert blocks == [(B, 8, 48)] * 2 + [(B, 16, 48)]


def test_bf16_forward_runs_at_the_compute_dtype():
    """The bf16 model on the CPU (every wrapper's plain version): finite, the
    prediction f32, within bf16's reach of the f32 model's loss."""
    cfg = tmae.MaeConfig(**CFG)
    t32 = tmae.init_mae(tmae.MaskedPointMAE(cfg), 4)
    t16 = tmae.MaskedPointMAE(cfg, dtype=torch.bfloat16)
    t16.load_state_dict(t32.state_dict())
    pts = torch.from_numpy(lattice_cloud(B, N, 9))
    noise = tmae.masking_noise(torch.Generator().manual_seed(1), B, 16)
    with torch.no_grad():
        l32, p32 = t32(pts, noise)
        l16, p16 = t16(pts, noise)
    assert p16.dtype == torch.float32 and torch.isfinite(p16).all()
    assert abs(float(l16) - float(l32)) <= 5e-2 * float(l32)
