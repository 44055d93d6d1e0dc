"""Port vs reference: the recognition task's leftovers.

``topk_accuracy``, ``pointbert_smoothed_ce``, ``soft_target_cross_entropy``
and ``distillation_loss`` against ``ppt_tpu`` on the same numpy inputs,
within ``tests/test_losses.py``'s 1e-5 (f32 on both sides, other
summation order); ``provenance.json``'s ``git_rev``; the wandb fan-out
with a stand-in ``wandb`` module, and the warning without one; the six
``TaskArgs`` fields through ``--config`` / ``--set``.
"""

import json
import os
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppt_torch.models import losses as tl
from ppt_torch.tasks import args as targs
from ppt_torch.utils.logging_utils import ExperimentLogger
from ppt_torch.utils.metrics import topk_accuracy

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("classes,topk", [(10, (1,)), (10, (1, 5)), (40, (1, 3, 5, 40))])
def test_topk_accuracy_matches_the_reference(classes, topk):
    from ppt_tpu.utils.metrics import topk_accuracy as jax_topk

    rng = np.random.RandomState(classes + len(topk))
    logits = rng.randn(64, classes).astype(np.float32)
    labels = rng.randint(0, classes, 64)
    want = jax_topk(jnp.asarray(logits), jnp.asarray(labels), topk)
    got = topk_accuracy(torch.from_numpy(logits), torch.from_numpy(labels), topk)
    assert len(got) == len(topk)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.dim() == 0
        assert abs(float(g) - float(w)) < 1e-5, (float(g), float(w))
    assert float(got[-1]) >= float(got[0])


@pytest.mark.parametrize("eps", [0.0, 0.2, 0.5])
def test_pointbert_smoothed_ce_matches_the_reference(eps):
    from ppt_tpu.models.losses import pointbert_smoothed_ce

    rng = np.random.RandomState(1)
    logits = (3 * rng.randn(16, 10)).astype(np.float32)
    labels = rng.randint(0, 10, 16)
    want = float(pointbert_smoothed_ce(jnp.asarray(logits), jnp.asarray(labels), eps))
    got = float(tl.pointbert_smoothed_ce(torch.from_numpy(logits), torch.from_numpy(labels), eps))
    assert abs(got - want) < 1e-5, (got, want)
    if eps:  # the off-classes take eps / (K - 1), not smoothed_cross_entropy's eps / K
        assert abs(got - float(tl.smoothed_cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(labels), eps))) > 1e-4


def test_soft_target_cross_entropy_matches_the_reference():
    from ppt_tpu.models.losses import soft_target_cross_entropy

    rng = np.random.RandomState(2)
    logits = rng.randn(12, 7).astype(np.float32)
    target = rng.rand(12, 7).astype(np.float32)
    target /= target.sum(-1, keepdims=True)
    want = float(soft_target_cross_entropy(jnp.asarray(logits), jnp.asarray(target)))
    got = float(tl.soft_target_cross_entropy(torch.from_numpy(logits), torch.from_numpy(target)))
    assert abs(got - want) < 1e-5, (got, want)
    onehot = np.eye(7, dtype=np.float32)[rng.randint(0, 7, 12)]
    assert abs(float(tl.soft_target_cross_entropy(torch.from_numpy(logits),
                                                  torch.from_numpy(onehot)))
               - float(tl.smoothed_cross_entropy(torch.from_numpy(logits),
                                                 torch.from_numpy(onehot.argmax(-1))))) < 1e-5


@pytest.mark.parametrize("alpha,temperature", [(0.5, 4.0), (1.0, 2.0), (0.0, 4.0), (0.3, 1.0)])
def test_distillation_loss_matches_the_reference(alpha, temperature):
    from ppt_tpu.models.losses import distillation_loss

    rng = np.random.RandomState(3)
    s = (2 * rng.randn(10, 6)).astype(np.float32)
    t = (2 * rng.randn(10, 6)).astype(np.float32)
    y = rng.randint(0, 6, 10)
    want = float(distillation_loss(jnp.asarray(s), jnp.asarray(t), jnp.asarray(y), alpha,
                                   temperature))
    got = float(tl.distillation_loss(torch.from_numpy(s), torch.from_numpy(t),
                                     torch.from_numpy(y), alpha, temperature))
    assert abs(got - want) < 1e-5, (got, want)
    # the KL term vanishes when the teacher is the student (the 1e-10 aside)
    same = float(tl.distillation_loss(torch.from_numpy(s), torch.from_numpy(s),
                                      torch.from_numpy(y), 1.0, temperature))
    assert abs(same) < 1e-4


def test_provenance_records_the_git_revision(tmp_path):
    args = targs.TaskArgs(output_dir=str(tmp_path), exp_name="run")
    ExperimentLogger(args, "cls").close()
    prov = json.load(open(tmp_path / "run" / "provenance.json"))
    try:  # None outside a git checkout, or without git
        head = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                              text=True).stdout.strip() or None
    except FileNotFoundError:
        head = None
    assert prov["git_rev"] == head
    assert prov["args"]["proj_name"] == "PPT_TPU" and prov["args"]["wandb"] is False


def test_wandb_fan_out(tmp_path, monkeypatch):
    calls = []

    class Run:
        def log(self, metrics, step=None):
            calls.append(("log", metrics, step))

        def finish(self):
            calls.append(("finish",))

    def init(**kw):
        calls.append(("init", kw))
        return Run()

    monkeypatch.setitem(sys.modules, "wandb", types.SimpleNamespace(init=init))
    args = targs.TaskArgs(output_dir=str(tmp_path), exp_name="", wandb=True, proj_name="P")
    logger = ExperimentLogger(args, "cls")
    logger.log({"loss": 1.5, "per_class": [1, 2]}, step=3)
    logger.close()
    (_, kw), log_call, finish = calls
    assert kw["project"] == "P" and kw["name"] == "cls" and kw["config"]["wandb"] is True
    assert log_call == ("log", {"loss": 1.5, "per_class": [1, 2]}, 3) and finish == ("finish",)
    lines = [json.loads(x) for x in open(tmp_path / "cls" / "metrics.jsonl")]
    assert lines == [{"step": 3, "loss": 1.5}]


def test_wandb_missing_warns_and_logs_to_files(tmp_path, monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "wandb", None)  # `import wandb` raises ImportError
    args = targs.TaskArgs(output_dir=str(tmp_path), exp_name="x", wandb=True)
    logger = ExperimentLogger(args)
    logger.log({"loss": 2.0}, step=0)
    logger.close()
    assert "--wandb requested but wandb is not installed" in caplog.text
    assert os.path.exists(tmp_path / "x" / "metrics.jsonl")


def test_the_six_fields_load_from_a_config(tmp_path):
    path = tmp_path / "x.yaml"
    path.write_text("dataset_type: train\ndataset_prompt: scanobjectnn_64\nupdate_freq: 2\n"
                    "print_freq: 50\nproj_name: mine\nwandb: true\n")
    got = targs.parse_args(["--config", str(path)])
    assert (got.dataset_type, got.dataset_prompt, got.update_freq, got.print_freq,
            got.proj_name, got.wandb) == ("train", "scanobjectnn_64", 2, 50, "mine", True)
    got = targs.parse_args(["--config", str(path), "--set", "update_freq=4", "wandb=no"])
    assert got.update_freq == 4 and got.wandb is False
    defaults = targs.TaskArgs()
    from ppt_tpu.tasks.args import TaskArgs as JaxArgs

    ref = JaxArgs()
    for k in ("dataset_type", "dataset_prompt", "update_freq", "print_freq", "proj_name",
              "wandb", "fpath", "topk", "num_step", "num_run"):
        assert getattr(defaults, k) == getattr(ref, k), k
    # the linear probe's four fields, the seven scene keys and the mesh key
    # load too, with the reference's defaults
    got = targs.parse_args(["--config", str(path), "--set", "topk=3", "fpath=x", "num_step=2",
                            "num_run=2"])
    assert (got.topk, got.fpath, got.num_step, got.num_run) == (3, "x", 2, 2)
    scene = ("voxel_size", "voxel_max", "test_area", "eval_scene", "allow_train_eval",
             "max_eval_passes", "cm_out")
    for k in scene:
        assert getattr(defaults, k) == getattr(ref, k), k
    got = targs.parse_args(["--config", str(path), "--set", "voxel_size=0.1", "voxel_max=8",
                            "allow_train_eval=yes", "max_eval_passes=2", "cm_out=x"])
    assert (got.voxel_size, got.voxel_max, got.allow_train_eval, got.max_eval_passes,
            got.cm_out) == (0.1, 8, True, 2, "x")
    assert defaults.mesh_devices == ref.mesh_devices == 0
    assert targs.parse_args(["--config", str(path), "--set", "mesh_devices=2"]).mesh_devices == 2
