"""Port vs reference: PointBERT's dVAE tokenizer and its pretraining driver.

At the reference's own ``TINY`` config (``tests/test_dvae.py:10-13``) and
B=2, with the flax weights carried by ``convert.from_jax``:

- ``GroupNorm`` and ``leaky_relu`` against flax's, on 3-D and 4-D inputs
  and on near-constant groups of two values (one summation order on both
  sides, so the same statistics) whose fast variance rounds below zero;
- ``EdgeConvStack``, ``FoldingDecoder`` (eval and train, with the
  BatchNorm update) and ``DiscreteVAE``'s forward (eval, and train with the
  reference's own Gumbel uniforms: ``make_rng("gumbel")`` on the root module
  with the same rngs, handed to the port's forward): f32, each output within
  1e-5 of its largest entry;
- the straight-through ``hard=True`` path: loss and codebook gradient;
- ``dvae_loss`` with both reconstruction terms (rel 1e-5 Chamfer, 1e-4 EMD);
- one ``make_dvae_step`` in lockstep with the reference's (its Gumbel
  draw, its MiniPointNet kernels interpreted as on its chip): loss rel
  1e-4; each gradient (AdamW's first moment after one step, 0.1 g) within
  1e-4 of its leaf's largest entry plus 1e-4 of the largest gradient
  anywhere (a Dense bias just before a train-mode BatchNorm has a gradient
  of rounding noise), the group encoder within 1e-2 (its max-pools route
  a group's gradient to one of its points, which near-ties move: PR 6's
  limit); the updated weights within 1e-5 where the gradient is settled;
  BatchNorm buffers within 1e-4;
- one epoch of ``dvae_pretrain.main`` on the CPU with its checkpoint read
  back, the temperature anneal, and the refusals.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppt_torch.convert import from_jax
from ppt_torch.nn import dvae as pdvae
from ppt_torch.nn.layers import GroupNorm, leaky_relu
from ppt_torch.tasks import dvae_pretrain
from ppt_torch.tasks.args import TaskArgs, parse_args

TINY_KW = dict(group_size=8, num_group=16, encoder_dims=32, tokens_dims=32, decoder_dims=32,
               num_tokens=64)
TINY = pdvae.DvaeConfig(**TINY_KW)
SCHED = dict(final_lr=1e-5, warmup_epochs=0, warmup_start_lr=1e-6)
OPT = dict(weight_decay=0.1, betas=(0.9, 0.98), eps=1e-8)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def port_name(path):
    *mods, leaf = path
    return ".".join(list(mods) + [{"scale": "weight", "mean": "running_mean",
                                   "var": "running_var"}.get(leaf, leaf)])


def close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30)


def gumbel_uniforms(jmodel, variables, key, shape):
    """The uniforms the reference's forward draws from ``make_rng("gumbel")``
    in its root module, for the same rngs."""
    return np.array(jmodel.apply(
        variables, method=lambda m: jax.random.uniform(m.make_rng("gumbel"), shape,
                                                       minval=1e-20, maxval=1.0),
        rngs={"gumbel": key}))


@pytest.fixture(scope="module")
def ref():
    """The reference dVAE at TINY, its variables (numpy) and two clouds."""
    from ppt_tpu.nn.dvae import DiscreteVAE, DvaeConfig

    pts = np.random.RandomState(0).rand(2, 64, 3).astype(np.float32)
    jmodel = DiscreteVAE(DvaeConfig(**TINY_KW))
    variables = np_tree(jmodel.init({"params": jax.random.PRNGKey(0),
                                     "gumbel": jax.random.PRNGKey(1)}, jnp.asarray(pts),
                                    train=True))
    return jmodel, variables, pts


def port_dvae(variables, dtype=torch.float32):
    model = pdvae.DiscreteVAE(TINY, dtype=dtype)
    model.load_state_dict(from_jax(variables["params"], variables["batch_stats"], model))
    return model


@pytest.mark.parametrize("shape", [(2, 16, 64), (2, 16, 4, 64)], ids=["3d", "4d"])
def test_group_norm_matches_flax(shape):
    rng = np.random.RandomState(len(shape))
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    w, b = (1 + 0.1 * rng.randn(64)).astype(np.float32), (0.1 * rng.randn(64)).astype(np.float32)
    want = fnn.GroupNorm(num_groups=4, dtype=jnp.float32).apply(
        {"params": {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}}, jnp.asarray(x))
    gn = GroupNorm(64)
    gn.weight.data, gn.bias.data = torch.from_numpy(w), torch.from_numpy(b)
    with torch.no_grad():
        got = gn(torch.from_numpy(x).bfloat16() if len(shape) == 4 else torch.from_numpy(x))
    assert got.dtype == torch.float32
    if len(shape) == 4:  # a bf16 input: f32 statistics of the bf16 values, f32 out
        want = fnn.GroupNorm(num_groups=4, dtype=jnp.float32).apply(
            {"params": {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}},
            jnp.asarray(x).astype(jnp.bfloat16))
    close(got.numpy(), want, 1e-5)


def test_group_norm_clamps_a_near_constant_group():
    """Groups of two values (8 channels in 4 groups, one position: one
    summation order on both sides) near 300-3000, where E[x^2] - E[x]^2
    rounds below zero: clamped at 0 as flax's ``_compute_stats`` does."""
    rng = np.random.RandomState(9)
    x = (rng.uniform(300, 3000, (256, 1, 4, 1)) + 1e-3 * rng.randn(256, 1, 4, 2)).astype(
        np.float32).reshape(256, 1, 8)
    w, b = (1 + 0.1 * rng.randn(8)).astype(np.float32), (0.1 * rng.randn(8)).astype(np.float32)
    want = np.asarray(fnn.GroupNorm(num_groups=4, dtype=jnp.float32).apply(
        {"params": {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}}, jnp.asarray(x)))
    gn = GroupNorm(8)
    gn.weight.data, gn.bias.data = torch.from_numpy(w), torch.from_numpy(b)
    with torch.no_grad():
        got = gn(torch.from_numpy(x)).numpy()
    pairs = x.reshape(256, 4, 2)
    fast_var = (pairs * pairs).mean(-1) - pairs.mean(-1) ** 2
    assert (fast_var < 0).sum() >= 64  # the groups that take the clamp
    assert np.isfinite(got).all()
    close(got, want, 1e-5)


def test_leaky_relu_matches_flax():
    x = np.random.RandomState(1).randn(4, 50).astype(np.float32)
    x[0, :3] = [0.0, -0.0, -1e-30]
    np.testing.assert_array_equal(leaky_relu(torch.from_numpy(x), 0.2).numpy(),
                                  np.asarray(fnn.leaky_relu(jnp.asarray(x), 0.2)))


def test_edgeconv_stack_matches_flax():
    from ppt_tpu.nn.dvae import EdgeConvStack

    rng = np.random.RandomState(2)
    f = rng.randn(2, 16, 32).astype(np.float32)
    coor = rng.rand(2, 16, 3).astype(np.float32)
    jm = EdgeConvStack(48)
    v = np_tree(jm.init(jax.random.PRNGKey(3), jnp.asarray(f), jnp.asarray(coor)))
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(f), jnp.asarray(coor)))
    m = pdvae.EdgeConvStack(32, 48)
    m.load_state_dict(from_jax(v["params"], {}, m))
    with torch.no_grad():
        got = m(torch.from_numpy(f), torch.from_numpy(coor))
    assert got.dtype == torch.float32 and got.shape == (2, 16, 48)
    close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_folding_decoder_matches_flax(train):
    from ppt_tpu.nn.dvae import FoldingDecoder

    rng = np.random.RandomState(4)
    feat = rng.randn(2, 16, 32).astype(np.float32)
    jm = FoldingDecoder(8)
    v = np_tree(jm.init(jax.random.PRNGKey(5), jnp.asarray(feat)))
    v["batch_stats"] = jax.tree_util.tree_map(  # running statistics away from their init
        lambda a: (np.abs(a + rng.randn(*a.shape)) + 0.5).astype(np.float32), v["batch_stats"])
    (coarse, fine), mut = jm.apply(v, jnp.asarray(feat), train, mutable=["batch_stats"])
    m = pdvae.FoldingDecoder(32, 8)
    m.load_state_dict(from_jax(v["params"], v["batch_stats"], m))
    with torch.no_grad():
        got_c, got_f = m(torch.from_numpy(feat), train)
    close(got_c.numpy(), coarse, 1e-5)
    close(got_f.numpy(), fine, 1e-5)
    stats = dict(m.named_buffers())
    for path, want in flat(np_tree(mut["batch_stats"])).items():
        np.testing.assert_allclose(stats[port_name(path)].numpy(), want, rtol=1e-5, atol=1e-6)


def test_from_jax_carries_every_dvae_leaf(ref):
    _, variables, _ = ref
    model = port_dvae(variables)
    names = {k for k, _ in model.named_parameters()} | {
        k for k, _ in model.named_buffers() if k.endswith(("running_mean", "running_var"))}
    assert names == {port_name(p) for p in flat(variables["params"])} | {
        port_name(p) for p in flat(variables["batch_stats"])}
    for key in ("codebook", "dgcnn_1.gn5.weight", "dgcnn_2.layer5.kernel",
                "decoder.fbn2.running_var", "encoder.bn1.running_mean"):
        assert key in names
    assert "decoder.seed" not in model.state_dict()  # the folding grid is no weight


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train_gumbel"])
def test_dvae_forward_matches_flax(ref, train):
    jmodel, variables, pts = ref
    key = jax.random.PRNGKey(7)
    want, _ = jmodel.apply(variables, jnp.asarray(pts), temperature=0.7, train=train,
                           rngs={"gumbel": key}, mutable=["batch_stats"])
    u = gumbel_uniforms(jmodel, variables, key, (2, 16, 64)) if train else None
    model = port_dvae(variables)
    with torch.no_grad():
        got = model(torch.from_numpy(pts), temperature=0.7, train=train,
                    uniforms=None if u is None else torch.from_numpy(u))
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k].numpy(), want[k], 1e-5)


def test_tokenize_is_the_argmax_of_the_eval_logits(ref):
    from ppt_tpu.nn.pointbert import group_points

    jmodel, variables, pts = ref
    nb, ct = group_points(jnp.asarray(pts), 16, 8)
    want = np.asarray(jmodel.apply(variables, nb, ct, method=jmodel.tokenize))
    with torch.no_grad():
        got = port_dvae(variables).tokenize(torch.from_numpy(np.asarray(nb)),
                                            torch.from_numpy(np.asarray(ct)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_hard_mode_is_straight_through(ref):
    """``hard=True``: the one-hot forward, the soft gradient; it reaches
    the codebook, as the reference's does."""
    from ppt_tpu.nn.dvae import dvae_loss as jax_loss

    jmodel, variables, pts = ref
    key = jax.random.PRNGKey(2)

    def loss_fn(params):
        ret, _ = jmodel.apply({**variables, "params": params}, jnp.asarray(pts),
                              temperature=0.5, hard=True, train=True, rngs={"gumbel": key},
                              mutable=["batch_stats"])
        recon, klv = jax_loss(ret, 64)
        return recon + klv

    want, wgrad = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    model = port_dvae(variables)
    u = gumbel_uniforms(jmodel, variables, key, (2, 16, 64))
    ret = model(torch.from_numpy(pts), temperature=0.5, hard=True, train=True,
                uniforms=torch.from_numpy(u))
    recon, klv = pdvae.dvae_loss(ret, 64)
    (g,) = torch.autograd.grad(recon + klv, [model.codebook])
    assert abs(float((recon + klv).detach()) - float(want)) <= 1e-5 * abs(float(want))
    assert torch.isfinite(g).all() and float(g.abs().sum()) > 0
    close(g.numpy(), wgrad["codebook"], 1e-4)


@pytest.mark.parametrize("recon", ["chamfer", "emd"])
def test_dvae_loss_matches_reference(recon):
    from ppt_tpu.nn.dvae import dvae_loss as jax_loss

    rng = np.random.RandomState(3)
    ret = {"coarse": rng.rand(2, 4, 2, 3), "fine": rng.rand(2, 4, 8, 3),
           "neighborhood": rng.rand(2, 4, 8, 3), "logits": rng.randn(2, 4, 16) * 2}
    ret = {k: v.astype(np.float32) for k, v in ret.items()}
    want = jax_loss({k: jnp.asarray(v) for k, v in ret.items()}, 16, recon=recon)
    got = pdvae.dvae_loss({k: torch.from_numpy(v) for k, v in ret.items()}, 16, recon=recon)
    assert abs(float(got[0]) - float(want[0])) <= (1e-4 if recon == "emd" else 1e-5) * float(
        want[0])
    assert abs(float(got[1]) - float(want[1])) <= 1e-5 * abs(float(want[1])) + 1e-7
    with pytest.raises(ValueError, match="recon"):
        pdvae.dvae_loss({k: torch.from_numpy(v) for k, v in ret.items()}, 16, recon="l2")


def test_dvae_step_matches_reference(ref, monkeypatch):
    from ppt_tpu.tasks.dvae_pretrain import make_dvae_step as jax_make_step
    from ppt_tpu.train.optim import build_optimizer as jax_optimizer
    from ppt_tpu.train.optim import build_schedule as jax_schedule
    from ppt_tpu.train.trainer import TrainState as JaxState

    from ppt_torch.train.optim import build_optimizer, build_schedule
    from ppt_torch.train.trainer import create_train_state

    monkeypatch.setenv("PPT_FORCE_FUSED_MINI", "1")  # the reference's kernels, as on its chip
    jmodel, variables, _ = ref
    pc = np.random.RandomState(11).rand(4, 64, 3).astype(np.float32)
    opt = jax_optimizer("adamw", jax_schedule("cosine", 3e-3, 2, 4, **SCHED), **OPT)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = JaxState(step=jnp.zeros((), jnp.int32), trainable=params, frozen={},
                      batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                      opt_state=opt.init(params), rng=jax.random.PRNGKey(3))
    gumbel_key = jax.random.split(jstate.rng, 3)[1]
    u = gumbel_uniforms(jmodel, variables, gumbel_key, (4, 16, 64))

    model = port_dvae(variables)
    sched = build_schedule("cosine", 3e-3, 2, 4, **SCHED)
    state = create_train_state(model, {k: True for k, _ in model.named_parameters()},
                               lambda tr: build_optimizer("adamw", tr.items(), sched, **OPT),
                               seed=1)
    step = dvae_pretrain.make_dvae_step(model, state.optimizer)
    jstate, jm = jax_make_step(jmodel, opt)(jstate, {"pc": jnp.asarray(pc)}, 0.8)
    state, m = step(state, {"pc": torch.from_numpy(pc)}, 0.8, uniforms=torch.from_numpy(u))
    for k in ("loss", "recon", "kl"):
        assert abs(float(m[k]) - float(jm[k])) <= 1e-4 * abs(float(jm[k])), k
    assert state.step == 1 == int(jstate.step)

    mus = flat(np_tree(jstate.opt_state[0].mu))
    assert set(state.optimizer.mu) == {port_name(p) for p in mus}
    top = max(float(np.abs(v).max()) for v in mus.values())
    tols = {}
    for path, want_mu in mus.items():
        rel = 1e-2 if path[0] == "encoder" else 1e-4
        tols[path] = rel * float(np.abs(want_mu).max()) + 1e-4 * top
        got_mu = state.optimizer.mu[port_name(path)].numpy()
        assert np.abs(got_mu - want_mu).max() <= tols[path], path
    for path, want_p in flat(np_tree(jstate.trainable)).items():
        diff = np.abs(state.trainable[port_name(path)].detach().numpy() - want_p)
        sure = np.abs(mus[path]) > tols[path]
        assert np.max(diff[sure], initial=0.0) <= 1e-5, path
        assert diff.max() <= 2 * 3e-3, path  # AdamW's first step: about lr sign(g)
    stats = dict(state.model.named_buffers())
    for path, want_s in flat(np_tree(jstate.batch_stats)).items():
        got_s = stats[port_name(path)].numpy()
        assert np.abs(got_s - want_s).max() <= 1e-4 * max(np.abs(want_s).max(), 1.0), path


def test_temperature_anneals_as_the_reference():
    assert dvae_pretrain.temperature_at(0, 40) == 1.0
    assert dvae_pretrain.temperature_at(40, 40) == 0.0625
    for s in (1, 13, 39):
        assert dvae_pretrain.temperature_at(s, 40) == float(1.0 * (0.0625 / 1.0) ** (s / 40))


def test_dvae_pretrain_main_one_epoch_on_the_cpu(tmp_path):
    from ppt_torch.train.checkpoint import load_checkpoint
    from ppt_torch.train.optim import build_optimizer
    from ppt_torch.train.trainer import create_train_state

    args = parse_args(["--dataset_name", "synthetic", "--npoints", "64", "--batch_size", "8",
                       "--epochs", "1", "--warmup_epochs", "0", "--lr", "1e-3", "--device",
                       "cpu", "--output_dir", str(tmp_path)])
    args.num_classes, args.samples_per_class = 2, 8
    out = dvae_pretrain.main(args, config=TINY)
    (entry,) = out["history"]
    assert entry["epoch"] == 0 and np.isfinite(entry["recon"]) and entry["recon"] > 0
    assert np.isfinite(entry["kl"]) and entry["temperature"] == dvae_pretrain.temperature_at(1, 2)
    state = out["state"]
    assert state.step == 2 and len(state.trainable) == len(list(state.model.parameters()))
    fresh = create_train_state(pdvae.DiscreteVAE(TINY), {k: True for k in state.trainable},
                               lambda tr: build_optimizer("adamw", tr.items(), lambda s: 0.0),
                               seed=0)
    load_checkpoint(str(tmp_path / "dvae"), fresh)
    for k, v in state.trainable.items():
        assert torch.equal(fresh.trainable[k], v), k
    for k, v in state.batch_stats().items():
        assert torch.equal(fresh.batch_stats()[k], v), k
    assert (tmp_path / "dvae" / "checkpoint_best.json").exists()


def test_dvae_pretrain_refuses_by_name(monkeypatch):
    # adahessian is threaded into the step now, as the reference's
    # (tasks/dvae_pretrain.py:39-60); its Hessian-vector product would
    # differentiate the encoder's MiniPointNet kernel twice, which the
    # reference's kernel route refuses too (jax.jvp through a custom_vjp),
    # so the step refuses by the kernel's name
    with pytest.raises(NotImplementedError, match="mini_forward.*adahessian"):
        dvae_pretrain.main(TaskArgs(dataset_name="synthetic", optim="adahessian", device="cpu",
                                    npoints=64), config=TINY)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dvae_pretrain.main(["--dataset_name", "synthetic", "--npoints", "64"], config=TINY)
