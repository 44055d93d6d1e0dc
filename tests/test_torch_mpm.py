"""Port vs reference: PointBERT's masked point modeling (pretraining stage 2).

- ``sample_group_mask`` masks exactly ``max(int(G * ratio), 1)`` groups a
  row, as many as the reference's;
- ``mpm_loss`` against the reference's (rel 1e-6), only masked positions
  counting, a perfect prediction;
- ``PointBertMPM``'s logits against flax's at depth 2 over 4 groups,
  DropPath 0, on each trunk route under the reference's matching switch:
  f32, within 1e-5 of the largest logit;
- one ``make_mpm_step`` in lockstep with the reference's, with the
  reference's own mask and the same frozen dVAE (the reference's block and
  MiniPointNet kernels interpreted, as on its chip): loss rel 1e-4, the
  masked accuracy equal; each gradient (AdamW's first moment after one
  step, 0.1 g) within 1e-4 of its leaf's largest entry plus 1e-4 of the
  largest gradient anywhere (a Dense bias just before a train-mode
  BatchNorm has a gradient of rounding noise), the group encoder within
  1e-2 (its max-pools route a group's gradient to near-tied points: PR 6's
  limit); updated weights within 1e-5 where the gradient is settled;
  BatchNorm buffers within 1e-4;
- ``mpm_pretrain.main`` for one epoch on the CPU, reading the dVAE
  checkpoint that ``dvae_pretrain.main`` wrote (and warning without one).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppt_torch.convert import from_jax
from ppt_torch.nn import dvae as pdvae
from ppt_torch.nn import mpm as pmpm
from ppt_torch.nn.pointbert import PointBertConfig
from ppt_torch.tasks import dvae_pretrain, mpm_pretrain
from ppt_torch.tasks.args import TaskArgs

DVAE_KW = dict(group_size=8, num_group=16, encoder_dims=32, tokens_dims=32, decoder_dims=32,
               num_tokens=64)
STUDENT_KW = dict(trans_dim=48, depth=2, drop_path_rate=0.0, num_heads=4, group_size=8,
                  num_group=16, encoder_dims=32)
SCHED = dict(final_lr=1e-5, warmup_epochs=0, warmup_start_lr=1e-6)
OPT = dict(weight_decay=0.1, betas=(0.9, 0.98), eps=1e-8)
SWITCHES = {"block": {"PPT_FUSED_BLOCK": "1"}, "unfused": {"PPT_FUSED_BLOCK": "0"},
            "plain": {"PPT_FORCE_XLA_ATTN": "1"}}


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


def set_switches(monkeypatch, route):
    for k in ("PPT_FUSED_BLOCK", "PPT_FORCE_XLA_ATTN", "PPT_FUSED_VIT_TOWER"):
        monkeypatch.delenv(k, raising=False)
    for k, v in SWITCHES[route].items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("g,ratio,k", [(64, 0.4, 25), (512, 0.4, 204), (16, 0.01, 1)])
def test_sample_group_mask_counts(g, ratio, k):
    from ppt_tpu.nn.mpm import sample_group_mask as jax_mask

    gen = torch.Generator().manual_seed(g)
    mask = pmpm.sample_group_mask(gen, 5, g, ratio)
    assert mask.dtype == torch.bool and mask.shape == (5, g)
    assert mask.sum(1).tolist() == [k] * 5
    np.testing.assert_array_equal(np.asarray(jax_mask(jax.random.PRNGKey(0), 5, g, ratio)).sum(1),
                                  k)
    assert not torch.equal(mask[0], mask[1])  # drawn per row


def test_mpm_loss_matches_reference():
    from ppt_tpu.nn.mpm import mpm_loss as jax_loss

    rng = np.random.RandomState(0)
    logits = rng.randn(3, 10, 16).astype(np.float32) * 3
    targets = rng.randint(0, 16, (3, 10))
    mask = rng.rand(3, 10) < 0.4
    want = jax_loss(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(mask))
    got = pmpm.mpm_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                        torch.from_numpy(mask))
    assert abs(float(got[0]) - float(want[0])) <= 1e-6 * float(want[0])
    assert float(got[1]) == pytest.approx(float(want[1]), abs=1e-7)
    none = pmpm.mpm_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                         torch.zeros(3, 10, dtype=torch.bool))
    assert float(none[0]) == 0.0 and float(none[1]) == 0.0  # the denominator floors at 1


def test_mpm_loss_counts_only_masked_positions():
    rng = np.random.RandomState(1)
    logits = torch.from_numpy(rng.randn(2, 8, 16).astype(np.float32))
    targets = torch.from_numpy(rng.randint(0, 16, (2, 8)))
    mask = torch.zeros(2, 8, dtype=torch.bool)
    mask[:, 0] = True
    perfect = torch.nn.functional.one_hot(targets, 16).float() * 100.0
    mixed = torch.where(mask[..., None], logits, perfect)
    l1, a1 = pmpm.mpm_loss(mixed, targets, mask)
    l2, a2 = pmpm.mpm_loss(logits, targets, mask)
    assert abs(float(l1) - float(l2)) < 1e-6 and float(a1) == float(a2)


def test_mpm_loss_of_a_perfect_prediction():
    targets = torch.from_numpy(np.random.RandomState(2).randint(0, 16, (2, 8)))
    loss, acc = pmpm.mpm_loss(torch.nn.functional.one_hot(targets, 16).float() * 100.0, targets,
                              torch.ones(2, 8, dtype=torch.bool))
    assert float(loss) < 1e-4 and float(acc) == 1.0


def _groups(b, npoints, g, m, seed):
    from ppt_tpu.nn.pointbert import group_points

    pts = np.random.RandomState(seed).rand(b, npoints, 3).astype(np.float32)
    nb, ct = group_points(jnp.asarray(pts), g, m)
    return pts, np.array(nb), np.array(ct)


@pytest.mark.parametrize("route", ["block", "unfused", "plain"])
def test_pointbert_mpm_logits_match_flax(route, monkeypatch):
    from ppt_tpu.nn.mpm import PointBertMPM as JaxMPM
    from ppt_tpu.nn.pointbert import PointBertConfig as JaxConfig

    kw = dict(STUDENT_KW, num_group=4)
    _, nb, ct = _groups(2, 32, 4, 8, seed=3)
    mask = np.array([[True, False, False, True], [False, True, False, False]])
    jm = JaxMPM(JaxConfig(**kw), num_tokens=64)
    v = np_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(nb), jnp.asarray(ct),
                        jnp.asarray(mask)))
    set_switches(monkeypatch, route)
    want = np.asarray(jm.apply(v, jnp.asarray(nb), jnp.asarray(ct), jnp.asarray(mask)))
    model = pmpm.PointBertMPM(PointBertConfig(**kw), num_tokens=64, route=route)
    model.load_state_dict(from_jax(v["params"], v["batch_stats"], model))
    assert {"mask_token", "cls_pos", "lm_head.kernel", "norm.weight"} <= set(model.state_dict())
    with torch.no_grad():
        got = model(torch.from_numpy(nb), torch.from_numpy(ct), torch.from_numpy(mask))
    assert got.shape == (2, 4, 64) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_masked_groups_see_only_the_mask_token():
    """A masked group's own points do not reach the logits (eval mode: the
    group encoder's statistics are the running ones)."""
    kw = dict(STUDENT_KW, num_group=4)
    model = pmpm.init_mpm(pmpm.PointBertMPM(PointBertConfig(**kw), num_tokens=64), 0)
    _, nb, ct = _groups(2, 32, 4, 8, seed=4)
    mask = torch.tensor([[True, False, True, False], [False, False, False, True]])
    nb2 = nb.copy()
    nb2[0, 0] += 0.3
    nb2[1, 3] -= 0.2
    with torch.no_grad():
        a = model(torch.from_numpy(nb), torch.from_numpy(ct), mask)
        b = model(torch.from_numpy(nb2), torch.from_numpy(ct), mask)
        c = model(torch.from_numpy(nb2), torch.from_numpy(ct), torch.zeros_like(mask))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="tower"):
        pmpm.PointBertMPM(PointBertConfig(**kw), route="tower")


def test_mpm_step_matches_reference(monkeypatch):
    from ppt_tpu.nn.dvae import DiscreteVAE as JaxDvae
    from ppt_tpu.nn.dvae import DvaeConfig as JaxDvaeConfig
    from ppt_tpu.nn.mpm import PointBertMPM as JaxMPM
    from ppt_tpu.nn.mpm import sample_group_mask as jax_mask
    from ppt_tpu.nn.pointbert import PointBertConfig as JaxConfig
    from ppt_tpu.tasks.mpm_pretrain import make_mpm_step as jax_make_step
    from ppt_tpu.train.optim import build_optimizer as jax_optimizer
    from ppt_tpu.train.optim import build_schedule as jax_schedule
    from ppt_tpu.train.trainer import TrainState as JaxState

    from ppt_torch.train.optim import build_optimizer, build_schedule
    from ppt_torch.train.trainer import create_train_state

    monkeypatch.setenv("PPT_FORCE_FUSED_MINI", "1")  # the reference's kernels, as on its chip
    set_switches(monkeypatch, "block")
    pts, nb, ct = _groups(4, 64, 16, 8, seed=5)
    jdvae = JaxDvae(JaxDvaeConfig(**DVAE_KW))
    dvars = np_tree(jdvae.init({"params": jax.random.PRNGKey(10), "gumbel": jax.random.PRNGKey(0)},
                               jnp.asarray(pts[:2]), train=False))
    jm = JaxMPM(JaxConfig(**STUDENT_KW), num_tokens=64)
    mask0 = jnp.zeros((4, 16), bool)
    v = np_tree(jm.init(jax.random.PRNGKey(1), jnp.asarray(nb), jnp.asarray(ct), mask0))
    opt = jax_optimizer("adamw", jax_schedule("cosine", 3e-3, 2, 4, **SCHED), **OPT)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    jstate = JaxState(step=jnp.zeros((), jnp.int32), trainable=params, frozen={},
                      batch_stats=jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]),
                      opt_state=opt.init(params), rng=jax.random.PRNGKey(2))
    mask = np.array(jax_mask(jax.random.split(jstate.rng, 4)[1], 4, 16, 0.4))

    dvae = pdvae.DiscreteVAE(pdvae.DvaeConfig(**DVAE_KW))
    dvae.load_state_dict(from_jax(dvars["params"], dvars["batch_stats"], dvae))
    dvae.requires_grad_(False)
    student = pmpm.PointBertMPM(PointBertConfig(**STUDENT_KW), num_tokens=64)
    student.load_state_dict(from_jax(v["params"], v["batch_stats"], student))
    sched = build_schedule("cosine", 3e-3, 2, 4, **SCHED)
    state = create_train_state(student, {k: True for k, _ in student.named_parameters()},
                               lambda tr: build_optimizer("adamw", tr.items(), sched, **OPT),
                               seed=1)
    step = mpm_pretrain.make_mpm_step(student, dvae, state.optimizer, 0.4, 16, 8)
    jstate, jmet = jax_make_step(jm, jdvae, jax.tree_util.tree_map(jnp.asarray, dvars), opt, 0.4,
                                 16, 8)(jstate, {"pc": jnp.asarray(pts)})
    dvae0 = {k: p.clone() for k, p in dvae.state_dict().items()}
    state, met = step(state, {"pc": torch.from_numpy(pts)}, mask=torch.from_numpy(mask))
    assert abs(float(met["loss"]) - float(jmet["loss"])) <= 1e-4 * float(jmet["loss"])
    assert float(met["masked_acc"]) == pytest.approx(float(jmet["masked_acc"]), abs=1e-4)
    assert state.step == 1 == int(jstate.step)
    assert all(torch.equal(p, dvae0[k]) for k, p in dvae.state_dict().items())  # frozen

    mus = flat(np_tree(jstate.opt_state[0].mu))
    assert set(state.optimizer.mu) == {port_name(p) for p in mus}
    top = max(float(np.abs(x).max()) for x in mus.values())
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
        assert diff.max() <= 2 * 3e-3, path
    stats = dict(state.model.named_buffers())
    for path, want_s in flat(np_tree(jstate.batch_stats)).items():
        got_s = stats[port_name(path)].numpy()
        assert np.abs(got_s - want_s).max() <= 1e-4 * max(np.abs(want_s).max(), 1.0), path


def _args(tmp_path, epochs=1):
    args = TaskArgs(dataset_name="synthetic", npoints=64, batch_size=8, epochs=epochs,
                    warmup_epochs=0, lr=1e-3, output_dir=str(tmp_path), device="cpu")
    args.num_classes, args.samples_per_class = 2, 8
    return args


def test_mpm_pretrain_main_reads_the_dvae_checkpoint(tmp_path, caplog, monkeypatch):
    set_switches(monkeypatch, "block")
    monkeypatch.setenv("PPT_FUSED_VIT_TOWER", "1")  # a readout kernel: MPM keeps the block route
    dcfg = pdvae.DvaeConfig(**DVAE_KW)
    dvae_pretrain.main(_args(tmp_path), config=dcfg)
    payload = torch.load(tmp_path / "dvae" / "checkpoint_best.pt", weights_only=True)
    seen = {}
    real_load = mpm_pretrain.load_dvae
    monkeypatch.setattr(mpm_pretrain, "load_dvae",
                        lambda dvae, path: seen.setdefault("dvae", real_load(dvae, path)))
    with caplog.at_level(logging.INFO, logger="ppt_torch.tasks.mpm_pretrain"):
        out = mpm_pretrain.main(_args(tmp_path), config=PointBertConfig(**STUDENT_KW),
                                dvae_config=dcfg)
    assert "loaded frozen dVAE" in caplog.text
    for k, v in payload["trainable"].items():
        assert torch.equal(seen["dvae"].state_dict()[k], v), k
    assert not any(p.requires_grad for p in seen["dvae"].parameters())
    (entry,) = out["history"]
    assert np.isfinite(entry["loss"]) and 0.0 <= entry["masked_acc"] <= 100.0
    assert out["state"].step == 2 and out["state"].model.route == "block"
    assert (tmp_path / "mpm" / "checkpoint_best.pt").exists()


def test_mpm_pretrain_warns_without_a_dvae(tmp_path, caplog):
    with caplog.at_level(logging.WARNING, logger="ppt_torch.tasks.mpm_pretrain"):
        out = mpm_pretrain.main(_args(tmp_path), config=PointBertConfig(**STUDENT_KW),
                                dvae_config=pdvae.DvaeConfig(**DVAE_KW))
    assert "using random tokenizer" in caplog.text
    assert np.isfinite(out["history"][0]["loss"])
