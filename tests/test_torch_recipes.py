"""The published recipes through the port's own CLI, on the CPU.

- Config: every ``.yaml`` under ``configs/`` loads equal to
  ``ppt_tpu.utils.config.load_config`` (PyYAML); scalars resolve as
  ``yaml.safe_load`` resolves them (YAML 1.1), and what the port's reader
  refuses raises a ``ValueError`` that names the construct.
- Recipes: each of the four experiment files, bare, with ``--set``
  overrides and with explicit flags, resolves field for field (over the
  port's fields) to what ``ppt_tpu.tasks.args.parse_args`` gives; a key the
  reference has and the port lacks raises by name.
- Driver: ``cls.main`` from ``ppt_base_mn40.yaml`` runs an epoch with
  PyYAML blocked from import, at a shrunk model (PointBERT depth 2, 64 wide,
  G=16, M=8, N=64; text tower 2 layers, 64 wide, as
  ``tests/test_torch_cls_train.py`` shrinks it); ``steps_per_dispatch`` 3
  gives the same loss and trainable leaves as single steps, bit for bit,
  leftovers included; the vote loop's calls, vote 0 untouched;
  ``fewshot.main`` from ``fewshot_mn40.yaml`` for an epoch.
"""

import glob
import math
import os
import sys

import numpy as np
import pytest
import torch
import yaml

from ppt_torch.nn.pointbert import PointBertConfig
from ppt_torch.nn.text import TextConfig
from ppt_torch.tasks import args as targs
from ppt_torch.tasks import cls, fewshot
from ppt_torch.train.trainer import make_train_step as MAKE_STEP
from ppt_torch.utils import config as tconfig

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"), recursive=True))
RECIPES = sorted(glob.glob(os.path.join(ROOT, "configs", "experiments", "*.yaml")))
TINY = dict(trans_dim=64, depth=2, drop_path_rate=0.1, num_heads=2, group_size=8,
            num_group=16, encoder_dims=64)
TEXT = dict(width=64, layers=2, heads=4, embed_dim=64)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, ROOT))
def test_every_config_loads_as_the_reference_loads_it(path):
    from ppt_tpu.utils.config import load_config

    assert tconfig.load_config(path) == load_config(path)


SCALARS = [
    "yes", "Yes", "YES", "no", "No", "NO", "on", "On", "ON", "off", "Off", "OFF", "true",
    "True", "TRUE", "false", "False", "tRue", "y", "n", "~", "null", "Null", "NULL", "nUll",
    "3.0e-3", "1e-3", "1.0e5", "1.0e+5", "1.5e3", "1.", "0.", ".5", "-.5", "+1.5", "-0.25",
    "1_000.5", "0x1f", "-0x1f", "0x_1f", "0o17", "017", "08", "0b101", "+0b1", "1_000", "1__0",
    "+12", "-0", "0", "190:20:30", "190:20:30.15", "12:30", "1:60", "0:59", ".inf", "-.Inf",
    "+.INF", ".NaN", "1.2.3", "hello world", "'quoted: yes'", "'it''s'", '"a\\tb\\u00e9"',
    "[1, 'a', b c, 2.5, [yes, ~]]", "[]", "ULIP_PointBERT", "configs/x.yaml", "a#b",
    "x # comment", "",
]


@pytest.mark.parametrize("text", SCALARS)
def test_scalars_resolve_as_safe_load(text):
    want = yaml.safe_load(text)
    got = tconfig.loads(text)
    if isinstance(want, float) and math.isnan(want):
        assert isinstance(got, float) and math.isnan(got)
    else:
        assert got == want and type(got) is type(want), (text, got, want)


@pytest.mark.parametrize("text,name", [
    ("a: &x 1", "anchor"), ("a: *x", "alias"), ("a: !!str 1", "tag"), ("a: |\n  x", "block scalar"),
    ("a: >\n  x", "block scalar"), ("a: 1\n---\nb: 2", "several documents"),
    ("%YAML 1.1\na: 1", "directive"), ("a: 2024-01-01", "timestamp"),
    ("a: 2001-12-14t21:59:43.10-05:00", "timestamp"), ("a: {b: 1}", "flow mapping"),
    ("<<: 1", "merge key"), ("a: =", "value key"), ("? a\n: b", "complex key"),
    ("a: b\n  c", "multi-line scalar"), ("a:\n\tb: 1", "tab indentation"),
    ("a: 'x", "multi-line quoted scalar"), ("a: [1, 2", "multi-line flow sequence"),
])
def test_constructs_outside_the_subset_raise_by_name(text, name):
    with pytest.raises(ValueError, match=name):
        tconfig.loads(text)


def test_reference_field_names_are_the_reference_dataclass():
    import dataclasses

    from ppt_tpu.tasks.args import TaskArgs

    assert targs.REFERENCE_FIELDS == tuple(
        f.name for f in dataclasses.fields(TaskArgs) if f.name != "classnames")
    assert "yaml" not in vars(targs) and "yaml" not in vars(tconfig)  # no YAML package


def _fields(args):
    import dataclasses

    return {f.name: getattr(args, f.name) for f in dataclasses.fields(targs.TaskArgs)
            if f.name not in ("device", "classnames")}


@pytest.mark.parametrize("recipe", RECIPES, ids=os.path.basename)
@pytest.mark.parametrize("extra", [
    [],
    ["--set", "epochs=3", "lr=1.0e-4", "data_ratio=0.25", "betas=[0.8, 0.9]", "use_height=yes",
     "num_category=10"],
    ["--set", "epochs=3", "batch_size=12", "--epochs", "5", "--votes", "3",
     "--steps_per_dispatch", "2", "--sched", "plateau", "--plateau_patience", "4",
     "--betas", "0.7", "0.8", "--use_height", "--nshots", "4"],
], ids=["bare", "set", "set_and_flags"])
def test_recipes_resolve_field_for_field_as_the_reference(recipe, extra):
    from ppt_tpu.tasks.args import parse_args

    argv = ["--config", recipe] + extra
    want = parse_args(argv)
    got = targs.parse_args(argv)
    for k, v in _fields(got).items():
        assert v == getattr(want, k), (k, v, getattr(want, k))


def test_a_reference_only_key_raises_by_name(tmp_path):
    path = tmp_path / "x.yaml"
    path.write_text("_base_: %s\nmesh_devices: 4\n" % os.path.join(
        ROOT, "configs", "experiments", "ppt_base_mn40.yaml"))
    with pytest.raises(NotImplementedError, match="mesh_devices"):
        targs.parse_args(["--config", str(path)])
    recipe = os.path.join(ROOT, "configs", "experiments", "ppt_base_mn40.yaml")
    # (fpath, topk, num_step and num_run load since the port has the linear
    # probe, the scene keys since it has scene segmentation: mesh_devices
    # is the one reference key left)
    with pytest.raises(NotImplementedError, match="mesh_devices"):
        targs.parse_args(["--config", recipe, "--set", "mesh_devices=2"])
    got = targs.parse_args(["--config", recipe, "--set", "test_area=3", "eval_scene=yes",
                            "cm_out=x", "voxel_size=0.1"])
    assert (got.test_area, got.eval_scene, got.cm_out, got.voxel_size) == (3, True, "x", 0.1)
    got = targs.parse_args(["--config", recipe, "--set", "fpath=x", "topk=3", "num_step=2",
                            "num_run=4"])
    assert (got.fpath, got.topk, got.num_step, got.num_run) == ("x", 3, 2, 4)
    got = targs.parse_args(["--fpath", "y", "--topk", "7", "--num_step", "1", "--num_run", "5"])
    assert (got.fpath, got.topk, got.num_step, got.num_run) == ("y", 7, 1, 5)
    # a key of neither dataclass is skipped, as the reference skips num_category
    path.write_text("epochs: 2\nnot_a_field: 1\nnested:\n  lr: 1.0e-4\n")
    got = targs.parse_args(["--config", str(path)])
    assert got.epochs == 2 and got.lr == 1e-4
    # YAML 1.1 reads 1e-3 as a string: refused for a numeric field, by name
    with pytest.raises(ValueError, match="'lr'"):
        targs.parse_args(["--config", str(path), "--set", "lr=1e-3"])


def _shrink(args):
    args.pointbert_config = PointBertConfig(**TINY)
    args.text_config = TextConfig(**TEXT)
    return args


def _argv(recipe, tmp_path, *extra):
    return ["--config", os.path.join(ROOT, "configs", "experiments", recipe), "--set",
            "epochs=1", "npoints=64", "batch_size=8", "--device", "cpu", "--output_dir",
            str(tmp_path), "--pretrained_dir", "", *extra]


@pytest.mark.parametrize("module,recipe", [(cls, "ppt_base_mn40.yaml"),
                                           (fewshot, "fewshot_mn40.yaml")],
                         ids=["cls", "fewshot"])
def test_driver_runs_an_epoch_from_the_recipe_without_pyyaml(module, recipe, tmp_path,
                                                             monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)  # `import yaml` raises in this process
    with pytest.raises(ImportError):
        import yaml as _  # noqa: F401
    seen = {}
    parse = targs.parse_args

    def parse_and_shrink(argv=None):
        seen["args"] = _shrink(parse(argv))
        return seen["args"]

    monkeypatch.setattr(targs, "parse_args", parse_and_shrink)
    monkeypatch.setattr(module, "parse_args", parse_and_shrink)
    out = module.main(_argv(recipe, tmp_path))
    args = seen["args"]
    assert args.epochs == 1 and args.npoints == 64 and args.batch_size == 8
    if module is fewshot:
        assert args.task == "fewshot" and args.dataset_name == "modelnet40_fs"
        assert args.head_type == 2 and args.nshots == 1 and args.lr == 3e-3
    else:
        assert args.class_name_position == "middle" and args.ulip2 is True
        assert args.data_ratio == 0.4 and args.label_smoothing == 0.2
    (entry,) = out["history"]
    assert math.isfinite(entry["loss"]) and "val_acc1" in entry


def _train(tmp_path, k, monkeypatch, samples_per_class):
    """One epoch of the recipe at ``steps_per_dispatch`` k: (state, the loss
    of every single step in order, the epoch's history entry)."""
    from ppt_torch.train import trainer

    losses = []

    def recording(*a, **kw):
        step = MAKE_STEP(*a, **kw)

        def run(state, batch, prompts):
            state, metrics = step(state, batch, prompts)
            losses.append(float(metrics["loss"]))
            return state, metrics

        return run

    monkeypatch.setattr(cls, "make_train_step", recording)
    monkeypatch.setattr(trainer, "make_train_step", recording)
    args = _shrink(targs.parse_args(_argv("ppt_base_mn40.yaml", tmp_path / f"k{k}",
                                          "--steps_per_dispatch", str(k))))
    args.num_classes, args.samples_per_class = 4, samples_per_class
    args.data_ratio = 1.0
    ctx = cls.setup(args)
    out = cls.train_loop(args, ctx)
    return ctx["state"], losses, out["history"][0]


@pytest.mark.parametrize("samples_per_class,steps", [(13, 6), (14, 7)],
                         ids=["two_dispatches", "leftover"])
def test_steps_per_dispatch_matches_single_steps_bit_for_bit(tmp_path, monkeypatch,
                                                             samples_per_class, steps):
    """4 classes: 52 clouds give 6 batches of 8 (two dispatches of 3), 56
    give 7 (two dispatches and one leftover single step). Every step's loss
    and the trainable leaves and statistics after the epoch are equal; the
    epoch's mean loss agrees to f32 rounding (the meter takes a K-step f32
    mean per dispatch, as the reference's loop does)."""
    one, l1, h1 = _train(tmp_path, 1, monkeypatch, samples_per_class)
    three, l3, h3 = _train(tmp_path, 3, monkeypatch, samples_per_class)
    assert one.step == three.step == steps == len(l1) == len(l3)
    assert l1 == l3
    assert abs(h1["loss"] - h3["loss"]) <= 1e-6 * abs(h1["loss"])
    for k, v in one.trainable.items():
        assert torch.equal(v, three.trainable[k]), k
    for k, v in one.batch_stats().items():
        assert torch.equal(v, three.batch_stats()[k]), k


def test_vote_loop_calls_and_vote_zero_untouched(tmp_path):
    args = _shrink(targs.parse_args(_argv("ppt_base_mn40.yaml", tmp_path, "--votes", "3")))
    args.num_classes, args.samples_per_class = 4, 5  # 20 test clouds: 3 batches of 8
    ctx = cls.setup(args)
    embed, step = cls.make_cached_text_eval(ctx["model"])
    seen = []

    def recording(state, batch, text_embed):
        seen.append(batch["pc"].clone())
        return step(state, batch, text_embed)

    val = cls.validate(ctx["model"], (embed, recording), ctx["test_ds"], ctx["prompts"], args,
                       ctx["device"], votes=3)
    assert len(seen) == 3 * 3 and 0.0 <= val["acc1"] <= 100.0
    pts = ctx["test_ds"].points
    for b in range(3):
        raw = np.zeros((8, 64, 3), np.float32)
        rows = pts[8 * b:8 * b + 8]
        raw[:len(rows)] = rows
        v0, v1, v2 = seen[3 * b:3 * b + 3]
        np.testing.assert_array_equal(v0.numpy()[:len(rows)], raw[:len(rows)])  # vote 0 as is
        for v in (v1, v2):  # votes 1, 2: one scale in [2/3, 3/2] and one shift per cloud axis
            scale = (v[:len(rows)].amax(1) - v[:len(rows)].amin(1)) / torch.from_numpy(
                np.ptp(raw[:len(rows)], axis=1))
            assert float(scale.min()) >= 2 / 3 - 1e-4 and float(scale.max()) <= 1.5 + 1e-4
        assert not torch.equal(v1, v2)
    # a second pass draws the same votes: the generator is seeded from args.seed + 7
    again = []
    cls.validate(ctx["model"], (embed, lambda s, b, t: again.append(b["pc"].clone())
                                or step(s, b, t)),
                 ctx["test_ds"], ctx["prompts"], args, ctx["device"], votes=3)
    assert all(torch.equal(a, b) for a, b in zip(seen, again))
    # the train loop passes votes=args.votes; --evaluate_3d keeps one vote
    calls = []
    real = cls.validate

    def spy(*a, **kw):
        calls.append(kw.get("votes", 1))
        return real(*a, **kw)

    cls.validate = spy
    try:
        cls.train_loop(args, ctx)
        ev = _shrink(targs.parse_args(_argv("ppt_base_mn40.yaml", tmp_path, "--votes", "3",
                                            "--evaluate_3d")))
        ev.num_classes, ev.samples_per_class = 4, 5
        cls.main(ev)
    finally:
        cls.validate = real
    assert calls == [3, 1]
