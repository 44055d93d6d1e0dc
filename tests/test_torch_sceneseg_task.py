"""Port vs reference: the scene-segmentation driver.

``ppt_torch.tasks.sceneseg`` against ``ppt_tpu.tasks.sceneseg``: one
train step of each backbone (small configs, f32, dropout the identity on
both sides) in lockstep with the reference's ``make_seg_train_step`` and
``optax.adamw`` under the same cosine decay: the loss within 1e-5, the
batch statistics within 1e-5, and the updated parameters within 1e-6
wherever the gradient has settled (AdamW's first update is
``g / (|g| + eps)``: where ``|g|`` sits at the two packages' rounding, its
sign is noise, so those entries are left out). ``whole_scene_eval`` with
one deterministic eval function gives the reference's confusion matrix
exactly, over 997 points and two votes. The port's own ``train_loop`` runs
on the S3DIS fixture of ``tests/test_sceneseg_task.py`` (the reference's
``train_loop`` is not called: its driver tests take minutes here): the
whole-scene matrix counts every labelled raw val point once, resume, the
best checkpoint kept, the missing val split, ``--allow_train_eval``,
``--cm_out`` and the 6-fold tool over it.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_sceneseg_task import _fixture
from test_torch_classic import no_dropout, pair  # noqa: F401 (a fixture)
from test_torch_pointnet2 import lattice_cloud, np_tree, stats_close
from test_torch_sceneseg_models import PT3_CFG, baaf, ptseg, randla

from ppt_torch.nn import baafnet as tbf
from ppt_torch.nn import randlanet as trl
from ppt_torch.tasks import sceneseg as tss
from ppt_torch.tasks.args import TaskArgs
from ppt_torch.train.optim import build_optimizer
from ppt_torch.train.schedules import cosine_with_warmup
from ppt_torch.train.trainer import TrainState

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores

LR, WD, STEPS, SMOOTH = 1e-3, 1e-4, 10, 0.2


@pytest.fixture
def quiet_dropout(no_dropout, monkeypatch):
    for mod in (trl, tbf):
        monkeypatch.setattr(mod, "dropout", lambda x, rate, train, generator: x)


def test_registry_and_the_refusals(tmp_path):
    assert set(tss.SEG_MODELS) == {"ptseg", "randlanet", "baafnet"}
    with pytest.raises(ValueError, match="stratified.*slice has not landed"):
        tss.main(["--model", "stratified", "--dataset_name", "s3dis", "--device", "cpu",
                  "--data_path", str(tmp_path)])
    with pytest.raises(KeyError, match="ULIP_PointBERT"):
        tss.backbone("ULIP_PointBERT")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tss.main(["--dataset_name", "s3dis", "--model", "ptseg"])


@pytest.mark.parametrize("name", ["ptseg", "randlanet", "baafnet"])
def test_one_train_step_in_lockstep(name, quiet_dropout):
    from ppt_tpu.tasks.sceneseg import make_seg_train_step
    from ppt_tpu.train.optim import build_optimizer as jax_optimizer

    jmod, tmod = {"ptseg": lambda: ptseg(PT3_CFG, "PointTransformerBlock"),
                  "randlanet": randla, "baafnet": lambda: baaf(False)}[name]()
    N = 256
    pts = lattice_cloud(2, N, 11)
    feats = np.random.RandomState(12).rand(2, N, 3).astype(np.float32)
    C = {"ptseg": 13, "randlanet": 6, "baafnet": 5}[name]
    labels = np.random.RandomState(13).randint(-1, C, (2, N)).astype(np.int32)
    x = [np.concatenate([pts, feats], -1)] if name == "randlanet" else [pts, feats]
    variables, tmod = pair(jmod, tmod, *x)

    jopt = jax_optimizer("adamw", optax.cosine_decay_schedule(LR, STEPS), weight_decay=WD,
                         betas=(0.9, 0.999))
    step = make_seg_train_step(name, jmod, jopt, C, smoothing=SMOOTH)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jb = {"pts": jnp.asarray(pts), "feats": jnp.asarray(feats), "label": jnp.asarray(labels)}
    new_params, new_bs, _, _, m = step(params, variables["batch_stats"], jopt.init(params),
                                       jax.random.PRNGKey(0), jb)

    probe = copy.deepcopy(tmod)  # the port's gradient, to tell settled entries
    tb = {"pts": torch.from_numpy(pts), "feats": torch.from_numpy(feats),
          "label": torch.from_numpy(labels.astype(np.int64))}
    loss, _ = tss.seg_loss(tss._apply(name, probe, tb["pts"], tb["feats"], True), tb["label"], C,
                           SMOOTH)
    loss.backward()
    grads = {k: p.grad for k, p in probe.named_parameters()}

    before = {k: p.detach().clone() for k, p in tmod.named_parameters()}
    state = TrainState(tmod, build_optimizer("adamw", tmod.named_parameters(),
                                             cosine_with_warmup(LR, 0.0, 1, STEPS), weight_decay=WD,
                                             betas=(0.9, 0.999)), torch.Generator())
    got = tss.make_seg_train_step(name, C, SMOOTH)(state, tb)
    assert abs(float(got["loss"]) - float(m["loss"])) <= 1e-5
    assert abs(float(got["acc"]) - float(m["acc"])) <= 1e-3
    stats_close(tmod, np_tree(new_bs), variables["batch_stats"])

    scale = max(float(g.abs().max()) for g in grads.values())
    settled = moved = 0
    for path, want in jax.tree_util.tree_leaves_with_path(new_params):
        key = tss_key(path)
        g = grads[key]
        mask = (g.abs() > 1e-3 * scale).numpy()
        diff = np.abs(dict(tmod.named_parameters())[key].detach().numpy() - np.asarray(want))
        assert np.all(diff[mask] <= 1e-6), key
        settled += int(mask.sum())
        moved += int((dict(tmod.named_parameters())[key] != before[key]).sum())
    assert settled > 0.3 * sum(g.numel() for g in grads.values())
    assert moved > 0


def tss_key(path):
    from ppt_torch.convert import _port_key

    return _port_key(tuple(p.key for p in path), False)


def _const(pts, feats):
    """A deterministic logit map of the tiles' points and features."""
    w = np.array([[1.0, -0.5, 0.25, 2.0], [0.3, 0.9, -1.2, 0.1], [-0.7, 0.2, 0.6, -0.4]],
                 np.float32)
    out = np.asarray(pts, np.float32) @ w
    if feats is not None:
        out = out + np.asarray(feats, np.float32)[..., :1] * 0.01
    return out


@pytest.mark.parametrize("votes,max_passes,with_feat", [(2, 0, False), (1, 0, True),
                                                        (2, 2, True)])
def test_whole_scene_eval_matches_the_reference(votes, max_passes, with_feat):
    from ppt_tpu.data.scenes import SceneDataset as JaxScenes
    from ppt_tpu.tasks.sceneseg import whole_scene_eval as jax_eval

    from ppt_torch.data.scenes import SceneDataset

    rng = np.random.RandomState(14)
    n = 997  # not a multiple of the tile size
    coord = rng.rand(n, 3).astype(np.float32) * 3
    feat = rng.rand(n, 3).astype(np.float32) * 255 if with_feat else None
    label = rng.randint(-1, 4, n).astype(np.int64)
    kw = dict(npoints=128, num_classes=4, voxel_size=0.05, batch_size=2, num_votes=votes,
              max_passes=max_passes, seed=3)
    want = jax_eval(lambda p, b, batch: _const(batch["pts"], batch.get("feats")), {}, {},
                    JaxScenes([(coord, feat, label)], list("abcd"), "toy"), **kw)
    got = tss.whole_scene_eval(lambda batch: torch.from_numpy(_const(batch["pts"],
                                                                     batch.get("feats"))),
                               SceneDataset([(coord, feat, label)], list("abcd"), "toy"), **kw)
    np.testing.assert_array_equal(got.matrix, want.matrix)
    if votes == 1 and not max_passes:
        assert got.matrix.sum() == (label >= 0).sum()  # every labelled point once


def _args(root, **kw):
    base = dict(dataset_name="s3dis", model="ptseg", npoints=512, voxel_max=512, voxel_size=0.1,
                test_area=5, batch_size=2, epochs=1, lr=1e-3, seed=0,
                allow_synthetic_fallback=False, output_dir=str(root / "out"),
                exp_name="run1", label_smoothing=0.2, device="cpu", data_path=str(root))
    base.update(kw)
    return TaskArgs(**base)


def test_train_loop_scene_eval_covers_every_point_and_feeds_6fold(tmp_path):
    from ppt_torch.data.scenes import load_s3dis
    from ppt_torch.tools.s3dis_6fold import aggregate

    _fixture(str(tmp_path), np.random.RandomState(0))
    out = tss.train_loop(_args(tmp_path, eval_scene=True, cm_out=str(tmp_path / "a5.npz")))
    assert np.isfinite(out["history"][0]["loss"]) and 0.0 <= out["scene_miou"] <= 100.0
    cm = np.load(tmp_path / "a5.npz", allow_pickle=True)
    n_val = sum(int((s[2] >= 0).sum()) for s in load_s3dis(str(tmp_path), "val",
                                                           voxel_size=0.0).scenes)
    assert cm["matrix"].sum() == n_val  # votes 1, every pass: each raw point once
    assert list(cm["classnames"])[0] == "ceiling"
    assert os.path.exists(tmp_path / "out" / "run1" / "checkpoint_best.pt")
    six = aggregate([str(tmp_path / "a5.npz")] * 2)
    assert six["folds"] == 2 and six["miou"] == round(out["scene_miou"], 2)
    # votes and capped passes: fewer or more counts, a well-defined mIoU
    out = tss.train_loop(_args(tmp_path, exp_name="run2", eval_scene=True, votes=2,
                               max_eval_passes=2))
    assert 0.0 <= out["scene_miou"] <= 100.0


def test_train_loop_resume_keeps_the_best(tmp_path):
    _fixture(str(tmp_path), np.random.RandomState(0))
    tss.train_loop(_args(tmp_path, model="randlanet"))
    ckpt = tmp_path / "out" / "run1"
    assert (ckpt / "checkpoint_best.pt").exists() and (ckpt / "metrics.jsonl").exists()
    meta = json.loads((ckpt / "checkpoint_best.json").read_text())
    meta["miou"] = 99.9  # a best no epoch can reach
    (ckpt / "checkpoint_best.json").write_text(json.dumps(meta))
    saved = (ckpt / "checkpoint_best.pt").read_bytes()
    out = tss.train_loop(_args(tmp_path, model="randlanet", resume=str(ckpt), epochs=2))
    assert out["history"][0]["epoch"] == 1  # resumed at the saved epoch + 1
    assert out["best_miou"] == 99.9
    assert (ckpt / "checkpoint_best.pt").read_bytes() == saved


def test_train_loop_missing_val_and_allow_train_eval(tmp_path, monkeypatch):
    raw = tmp_path / "raw"
    os.makedirs(raw)
    rng = np.random.RandomState(1)
    for room in ("a", "b"):  # no Area_5: no val split
        data = np.concatenate([rng.rand(700, 3) * 4, rng.rand(700, 3) * 255,
                               rng.randint(0, 13, (700, 1))], axis=1).astype(np.float32)
        np.save(raw / f"Area_1_{room}.npy", data)
    with pytest.raises(RuntimeError, match="val split"):
        tss.train_loop(_args(tmp_path))
    # BAAF-Net at a small config (its default samples 4096 points), on the train split
    monkeypatch.setitem(tss.SEG_MODELS, "baafnet", lambda nc, ic, dt: tbf.BaafNet(
        tbf.BaafNetConfig(n_points=512, k=4, num_classes=nc, dims=(3, 4, 8, 16, 32)),
        feat_channels=ic - 3, dtype=dt))
    out = tss.train_loop(_args(tmp_path, model="baafnet", allow_train_eval=True,
                               cm_out=str(tmp_path / "crop.npz")))
    assert out["history"]
    lines = (tmp_path / "out" / "run1" / "metrics.jsonl").read_text().splitlines()
    assert "train_miou" in json.loads(lines[0])
    assert np.load(tmp_path / "crop.npz", allow_pickle=True)["matrix"].sum() > 0


def test_optimizer_by_name(tmp_path, monkeypatch):
    """adahessian refused by name; TaskArgs' CLIP betas swapped for the
    seg recipes' (0.9, 0.999); other betas kept."""
    _fixture(str(tmp_path), np.random.RandomState(0))
    with pytest.raises(ValueError, match="adahessian"):
        tss.train_loop(_args(tmp_path, optim="adahessian"))
    seen = []
    real = tss.build_optimizer
    monkeypatch.setattr(tss, "build_optimizer",
                        lambda *a, **kw: seen.append(kw["betas"]) or real(*a, **kw))
    tss.train_loop(_args(tmp_path, model="randlanet", epochs=0))
    tss.train_loop(_args(tmp_path, model="randlanet", epochs=0, betas=(0.8, 0.9)))
    assert seen == [(0.9, 0.999), (0.8, 0.9)]
