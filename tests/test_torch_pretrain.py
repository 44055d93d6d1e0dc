"""Port vs reference: ULIP contrastive pretraining.

- ``ulip_contrastive_loss`` and its retrieval accuracies against the
  reference's, with and without the image term;
- ``build_caption_bank``'s token ids against the reference's, for the
  synthetic set's class names and some of ShapeNet-55's;
- ``load_shapenet55`` against the reference's on a small tree written here;
- one ``make_pretrain_step`` of a narrow ULIP-PointBERT against
  ``ppt_tpu.tasks.pretrain.make_pretrain_step`` from the same weights (the
  reference's full ``Ulip`` init, through ``convert.from_jax``) on the same
  clouds and captions, on the default trunk (the reference's block and
  MiniPointNet kernels interpreted, as on its chip) and on a 1025-token
  trunk (every block on ``flash_mha``, its gradient on the CPU);
- ``pretrain.main`` for one epoch on the synthetic set on the CPU.

Tolerances (f32 on both sides, other summation order): loss and accuracy
rel 1e-4; each gradient (AdamW's first moment after one step, 0.1 g)
within 1e-3 of its leaf's largest entry plus 1e-4 of the largest gradient
anywhere, which covers the leaves whose gradient is rounding noise (a
Dense bias just before a train-mode BatchNorm: its batch mean cancels it,
and over the long trunk's 32768 rows the reference's unfused BatchNorm
leaves noise of 5e-5 of the largest gradient); the updated leaves abs
1e-5 where the gradient is larger than that tolerance, and within the
step's 2 lr elsewhere (AdamW's
first step moves an entry by lr g / (|g| + 1e-8), about lr sign(g), so a
gradient that is rounding noise on both sides may move either way);
running statistics abs 1e-5. DropPath is 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppt_torch.convert import from_jax
from ppt_torch.data import datasets as pdata
from ppt_torch.models.losses import ulip_contrastive_loss
from ppt_torch.models.ulip import build_model, trainable_mask
from ppt_torch.nn.pointbert import PointBertConfig
from ppt_torch.nn.text import TextConfig
from ppt_torch.tasks import pretrain
from ppt_torch.tasks.args import TaskArgs, parse_args
from ppt_torch.train.optim import build_optimizer, build_schedule
from ppt_torch.train.trainer import create_train_state

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores

TEXT = dict(width=64, layers=2, heads=4, embed_dim=64)
SCHED = dict(final_lr=1e-5, warmup_epochs=0, warmup_start_lr=1e-6)
OPT = dict(weight_decay=0.1, betas=(0.9, 0.98), eps=1e-8)
SHAPENET_NAMES = ["airplane", "trash bin", "bag", "cellular telephone", "washer", "bookshelf",
                  "motorbike", "remote control"]


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


@pytest.mark.parametrize("with_image", [False, True], ids=["text", "text+image"])
def test_contrastive_loss_matches_reference(with_image):
    from ppt_tpu.models.losses import ulip_contrastive_loss as jax_loss

    rng = np.random.RandomState(0)
    pc, tx, im = (rng.randn(6, 16).astype(np.float32) * 3 for _ in range(3))
    tx[2] = pc[2]  # a sure hit
    scale = np.float32(np.exp(2.3))
    want = jax_loss(jnp.asarray(pc), jnp.asarray(tx), jnp.asarray(im) if with_image else None,
                    jnp.asarray(scale))
    got = ulip_contrastive_loss(torch.from_numpy(pc), torch.from_numpy(tx),
                                torch.from_numpy(im) if with_image else None,
                                torch.tensor(scale))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-4)


def test_caption_bank_ids_match_reference():
    from ppt_tpu.tasks.pretrain import build_caption_bank as jax_bank

    names = [f"shape {i}" for i in range(40)] + SHAPENET_NAMES
    want = jax_bank(names)
    got = pretrain.build_caption_bank(names)
    assert got.dtype == np.int32 and got.shape == (48, 64, 77) == want.shape
    np.testing.assert_array_equal(got, want)


def _shapenet_tree(root, rng):
    import json

    synsets = [("02691156", "airplane,aeroplane,plane"), ("02747177", "trash bin,ashcan"),
               ("04554684", "washer,automatic washer")]
    (root / "taxonomy.json").write_text(json.dumps(
        [{"synsetId": s, "name": n} for s, n in synsets]))
    (root / "shapenet_pc").mkdir()
    lines = []
    for i, (s, _) in enumerate(synsets * 2):
        name = f"{s}-model{i}.npy"
        np.save(root / "shapenet_pc" / name, rng.randn(40 + 10 * i, 3).astype(np.float32))
        lines.append(name)
    (root / "train.txt").write_text("\n".join(lines[:4]) + "\n")
    (root / "test.txt").write_text("\n".join(lines[4:]) + "\n")


@pytest.mark.parametrize("split", ["train", "test"])
def test_load_shapenet55_matches_reference(split, tmp_path):
    from ppt_tpu.data.datasets import load_shapenet55 as jax_load

    _shapenet_tree(tmp_path, np.random.RandomState(1))
    want = jax_load(str(tmp_path), split, 64)
    got = pdata.load_shapenet55(str(tmp_path), split, 64)
    assert got.classnames == want.classnames and got.name == want.name == "shapenet55"
    assert len(got) == (6 if split == "train" else 2)  # the train split takes test.txt too
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.points, want.points)
    args = TaskArgs(dataset_name="shapenet", data_path=str(tmp_path), npoints=64)
    assert pdata.build_dataset("shapenet", args, split).name == "shapenet55"


def test_shapenet_falls_back_to_synthetic_only_when_allowed(tmp_path):
    args = TaskArgs(dataset_name="shapenet", data_path=str(tmp_path / "none"), npoints=32)
    ds = pdata.build_dataset("shapenet", args, "train")
    assert ds.name == "synthetic" and ds.num_classes == 40
    args.allow_synthetic_fallback = False
    with pytest.raises(FileNotFoundError):
        pdata.build_dataset("shapenet", args, "train")


def _jax_side(cfg_kw, pc, monkeypatch, fused):
    from ppt_tpu.models import PromptArrays as JaxPrompts
    from ppt_tpu.models import Ulip as JaxUlip
    from ppt_tpu.models import trainable_mask as jax_mask
    from ppt_tpu.nn import PointBert as JaxPointBert
    from ppt_tpu.nn import PointBertConfig as JaxBertConfig
    from ppt_tpu.nn import TextConfig as JaxTextConfig
    from ppt_tpu.prompt import build_prompt_spec as jax_spec
    from ppt_tpu.tasks.pretrain import make_pretrain_step as jax_make_step
    from ppt_tpu.train.optim import build_optimizer as jax_optimizer
    from ppt_tpu.train.optim import build_schedule as jax_schedule
    from ppt_tpu.train.trainer import create_train_state as jax_create

    if fused:
        monkeypatch.setenv("PPT_FORCE_FUSED_MINI", "1")
    else:
        monkeypatch.delenv("PPT_FORCE_FUSED_MINI", raising=False)
    monkeypatch.setenv("PPT_FUSED_BLOCK", "1")
    model = JaxUlip(point_encoder=JaxPointBert(JaxBertConfig(**cfg_kw)),
                    pc_feat_dims=2 * cfg_kw["trans_dim"], n_ctx=4,
                    text_config=JaxTextConfig(**TEXT))
    prompts = JaxPrompts.from_spec(jax_spec(["airplane", "chair"], n_ctx=4))
    # the full Ulip init (the pretraining driver's own init has no prompt
    # learner, which the weight bridge would rightly refuse); numpy copies,
    # as the step donates its state's buffers
    variables = np_tree(model.init(jax.random.PRNGKey(0), jnp.asarray(pc[:1]), prompts))
    opt = jax_optimizer("adamw", jax_schedule("cosine", 3e-3, 2, 4, **SCHED), **OPT)
    state = jax_create(jax.tree_util.tree_map(jnp.asarray, variables),
                       jax_mask(variables["params"], task="pretrain"), opt,
                       jax.random.PRNGKey(1))
    return state, jax_make_step(model, opt), variables


def _port_side(cfg_kw, variables):
    args = TaskArgs(num_learnable_prompt_tokens=4)
    args.pointbert_config = PointBertConfig(**cfg_kw)
    args.text_config = TextConfig(**TEXT)
    model = build_model("ULIP_PointBERT", args, device="cpu").model
    model.load_state_dict(from_jax(np_tree(variables["params"]),
                                   np_tree(variables["batch_stats"]), model))
    sched = build_schedule("cosine", 3e-3, 2, 4, **SCHED)
    state = create_train_state(model, trainable_mask(model, task="pretrain"),
                               lambda tr: build_optimizer("adamw", tr.items(), sched, **OPT),
                               seed=1)
    return state, pretrain.make_pretrain_step(model, state.optimizer)


DEFAULT = dict(trans_dim=64, depth=2, drop_path_rate=0.0, num_heads=2, group_size=8,
               num_group=16, encoder_dims=64)
LONG = dict(trans_dim=48, depth=2, drop_path_rate=0.0, num_heads=6, group_size=8,
            num_group=1024, encoder_dims=32)


@pytest.mark.parametrize("cfg_kw,npoints", [(DEFAULT, 128), (LONG, 2048)],
                         ids=["default_trunk", "long_trunk_1025"])
def test_pretrain_step_matches_reference(cfg_kw, npoints, monkeypatch):
    rng = np.random.RandomState(2)
    pc = rng.rand(4, npoints, 3).astype(np.float32)
    jstate, jstep, variables = _jax_side(cfg_kw, pc, monkeypatch,
                                         fused=cfg_kw["num_group"] < 1024)
    state, step = _port_side(cfg_kw, variables)
    assert set(state.trainable) == {port_name(k) for k in flat(np_tree(jstate.trainable))}
    assert "point_encoder.encoder.conv1a.kernel" in state.trainable
    assert not any(k.startswith(("text.", "prompt_learner.")) for k in state.trainable)
    frozen0 = {k: v.detach().clone() for k, v in state.model.named_parameters()
               if k not in state.trainable}
    tokens = pretrain.build_caption_bank(["airplane", "chair", "lamp", "bag"])[
        np.arange(4), rng.randint(0, 64, 4)]

    jstate, jm = jstep(jstate, {"pc": jnp.asarray(pc)}, jnp.asarray(tokens))
    state, m = step(state, {"pc": torch.from_numpy(pc)}, torch.from_numpy(tokens))
    want = float(jm["loss"])
    assert abs(float(m["loss"]) - want) <= 1e-4 * abs(want)
    assert abs(float(m["pc_text_acc"]) - float(jm["pc_text_acc"])) <= 1e-4
    assert state.step == 1 == int(jstate.step)

    mus = flat(np_tree(jstate.opt_state[0].mu))
    top = max(float(np.max(np.abs(v))) for v in mus.values())
    tols = {}
    for path, want_mu in mus.items():
        got_mu = state.optimizer.mu[port_name(path)].numpy()
        tols[path] = 1e-3 * float(np.max(np.abs(want_mu))) + 1e-4 * top
        assert np.max(np.abs(got_mu - want_mu)) <= tols[path], path
    for path, want_p in flat(np_tree(jstate.trainable)).items():
        diff = np.abs(state.trainable[port_name(path)].detach().numpy() - want_p)
        sure = np.abs(mus[path]) > tols[path]
        assert np.max(diff[sure], initial=0.0) <= 1e-5, path
        assert np.max(diff) <= 2 * 3e-3, path
    assert 0.0 <= float(state.trainable["logit_scale"]) <= 4.6052
    stats = dict(state.model.named_buffers())
    for path, want_s in flat(np_tree(jstate.batch_stats)).items():
        assert np.max(np.abs(stats[port_name(path)].numpy() - want_s)) <= 1e-5, path
    for k, v in state.model.named_parameters():
        if k in frozen0:
            assert torch.equal(v, frozen0[k]), k


def test_pretrain_main_one_epoch_on_the_cpu(tmp_path):
    """The driver end to end: dataset forced to shapenet (synthetic
    fallback here), caption bank, cosine schedule, one epoch, a checkpoint
    of the trainable partition that reads back."""
    from ppt_torch.train.checkpoint import load_checkpoint

    args = parse_args(["--dataset_name", "modelnet40", "--data_path", str(tmp_path / "none"),
                       "--npoints", "64", "--batch_size", "32", "--epochs", "1", "--device",
                       "cpu", "--output_dir", str(tmp_path), "--grad_norm_clip", "1.0",
                       "--warmup_epochs", "0"])
    args.pointbert_config = PointBertConfig(trans_dim=32, depth=2, num_heads=2, group_size=8,
                                            num_group=8, encoder_dims=32)
    args.text_config = TextConfig(width=32, layers=1, heads=2, embed_dim=32)
    out = pretrain.main(args)
    assert args.dataset_name == "shapenet" and args.grad_norm_clip == 1.0
    (entry,) = out["history"]
    assert entry["epoch"] == 0 and np.isfinite(entry["loss"]) and 0 <= entry["pc_text_acc"] <= 100
    state = out["state"]
    assert state.step == 320 // 32 and state.optimizer.grad_norm_clip == 1.0
    fresh = create_train_state(
        build_model("ULIP_PointBERT", args, device="cpu").model,
        trainable_mask(state.model, task="pretrain"),
        lambda tr: build_optimizer("adamw", tr.items(), lambda s: 0.0), seed=0)
    load_checkpoint(str(tmp_path / "pretrain"), fresh)
    for k, v in state.trainable.items():
        assert torch.equal(fresh.trainable[k], v), k
    assert fresh.step == state.step


def test_pretrain_rejects_adahessian():
    args = TaskArgs(dataset_name="synthetic", optim="adahessian", device="cpu")
    with pytest.raises(ValueError, match="Hessian"):
        pretrain.main(args)


@pytest.mark.parametrize("route", ["off", "block", "tower"])
def test_encode_captions_matches_reference(route):
    """Raw caption tokens through the text tower, pooled at EOT, L2
    normalised, no prompt learner, on each text route (the kernels' plain
    versions on the CPU): f32 within 1e-5 of the reference's
    ``encode_captions``."""
    from ppt_tpu.models import PromptArrays as JaxPrompts
    from ppt_tpu.models import Ulip as JaxUlip
    from ppt_tpu.nn import PointBert as JaxPointBert
    from ppt_tpu.nn import PointBertConfig as JaxBertConfig
    from ppt_tpu.nn import TextConfig as JaxTextConfig
    from ppt_tpu.prompt import build_prompt_spec as jax_spec

    bank = pretrain.build_caption_bank(["airplane", "night stand", "bag"])
    tokens = bank[:, ::21].reshape(-1, 77)  # 4 templates a class
    jmodel = JaxUlip(point_encoder=JaxPointBert(JaxBertConfig(**DEFAULT)), pc_feat_dims=128,
                     n_ctx=4, text_config=JaxTextConfig(**TEXT))
    pc = np.random.RandomState(3).rand(1, 128, 3).astype(np.float32)
    variables = np_tree(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(pc),
                                    JaxPrompts.from_spec(jax_spec(["airplane"], n_ctx=4))))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(tokens), method=jmodel.encode_captions))

    args = TaskArgs(num_learnable_prompt_tokens=4)
    args.pointbert_config = PointBertConfig(**DEFAULT)
    args.text_config = TextConfig(**TEXT)
    model = build_model("ULIP_PointBERT", args, device="cpu", text_fused=route).model
    model.load_state_dict(from_jax(variables["params"], variables["batch_stats"], model))
    with torch.no_grad():
        got = model.encode_captions(torch.from_numpy(tokens)).numpy()
    assert got.shape == (12, 64)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-6)
    np.testing.assert_allclose(got, want, atol=1e-5)
