"""The port's recognition and few-shot tasks, training on the CPU.

``ppt_torch.tasks.cls.main`` at a reduced config (PointBERT depth 2, 64
wide, G=16, M=8, N=128; text tower 2 layers, 64 wide; 4 synthetic
classes) for 2 epochs: history, metrics file and best-only checkpoint are
written; ``--evaluate_3d --test_ckpt_addr`` loads the checkpoint and
reproduces the accuracy; ``--resume`` continues; the few-shot task
delegates; what this slice leaves out raises by name.
"""

import json
import os

import pytest
import torch

from ppt_torch.nn.pointbert import PointBertConfig
from ppt_torch.nn.text import TextConfig
from ppt_torch.tasks import cls, fewshot
from ppt_torch.tasks.args import TaskArgs, parse_args

TINY = dict(trans_dim=64, depth=2, drop_path_rate=0.1, num_heads=2, group_size=8,
            num_group=16, encoder_dims=64)
TEXT = dict(width=64, layers=2, heads=4, embed_dim=64)


def _args(out, **kw):
    base = dict(num_learnable_prompt_tokens=4, class_name_position="middle",
                dataset_name="synthetic", npoints=128, batch_size=8, device="cpu",
                output_dir=str(out), pretrained_dir="", epochs=2, label_smoothing=0.2)
    base.update(kw)
    args = TaskArgs(**base)
    args.pointbert_config = PointBertConfig(**TINY)
    args.text_config = TextConfig(**TEXT)
    args.num_classes = 4
    args.samples_per_class = 6  # 24 train clouds: 3 steps per epoch
    return args


def test_cls_main_trains_evaluates_and_checkpoints(tmp_path):
    result = cls.main(_args(tmp_path))
    hist = result["history"]
    assert [h["epoch"] for h in hist] == [0, 1]
    for h in hist:
        assert set(h) == {"epoch", "loss", "train_acc", "lr", "epoch_time", "val_acc1"}
        assert h["loss"] > 0 and torch.isfinite(torch.tensor(h["loss"]))
        assert 0.0 <= h["val_acc1"] <= 100.0
    assert hist[0]["lr"] > hist[1]["lr"] > 0  # warmup ends at epoch 0's last step, then cosine
    assert result["best_acc"] == max(h["val_acc1"] for h in hist)
    run = tmp_path / "cls"
    assert {"checkpoint_best.pt", "checkpoint_best.json", "metrics.jsonl",
            "provenance.json"} <= set(os.listdir(run))
    meta = json.load(open(run / "checkpoint_best.json"))
    assert meta["epoch"] == result["best_epoch"] and meta["best_acc"] == result["best_acc"]
    assert meta["args"]["label_smoothing"] == 0.2
    lines = [json.loads(x) for x in open(run / "metrics.jsonl")]
    assert [x["step"] for x in lines] == [0, 1] and lines[0]["loss"] == hist[0]["loss"]
    payload = torch.load(run / "checkpoint_best.pt", weights_only=True)
    assert set(payload["trainable"]) == {"prompt_learner.learnable_tokens"}
    assert payload["step"] == 3 * (meta["epoch"] + 1)

    # --evaluate_3d --test_ckpt_addr loads it and reproduces the best accuracy
    ev = cls.main(_args(tmp_path, evaluate_3d=True, test_ckpt_addr=str(run)))
    assert ev["best_epoch"] == -1 and ev["history"] == []
    assert ev["best_acc"] == result["best_acc"]

    # --resume starts after the checkpoint's epoch
    args = _args(tmp_path, resume=str(run), epochs=3, exp_name="resumed")
    resumed = cls.main(args)
    assert args.start_epoch == meta["epoch"] + 1
    assert [h["epoch"] for h in resumed["history"]] == list(range(meta["epoch"] + 1, 3))


def test_data_ratio_breaks_the_epoch_early(tmp_path):
    args = _args(tmp_path, epochs=1, data_ratio=0.4, output_dir="")
    args.output_dir = str(tmp_path)
    ctx = cls.setup(args)
    cls.train_loop(args, ctx)
    # 3 batches per epoch: it / 3 > 0.4 stops before the third
    assert ctx["state"].step == 2


def test_head_type_trains_nothing_extra_without_block_11(tmp_path):
    ctx = cls.setup(_args(tmp_path, head_type=3))
    assert sorted(ctx["state"].trainable) == ["prompt_learner.learnable_tokens"]
    assert ctx["steps_per_epoch"] == 3


def test_fewshot_delegates_to_cls(monkeypatch):
    seen = {}
    monkeypatch.setattr(cls, "main", lambda a: seen.setdefault("args", a) and {"ok": True})
    fewshot.main(TaskArgs(dataset_name="modelnet40", device="cpu"))
    assert seen["args"].task == "fewshot" and seen["args"].dataset_name == "modelnet40_fs"
    seen.clear()
    fewshot.main(["--dataset_name", "synthetic", "--nshots", "4", "--device", "cpu"])
    assert seen["args"].dataset_name == "synthetic" and seen["args"].nshots == 4
    seen.clear()
    fewshot.main(TaskArgs(dataset_name="modelnet40_fs"))
    assert seen["args"].dataset_name == "modelnet40_fs"


def test_fewshot_main_trains_on_cpu(tmp_path):
    result = fewshot.main(_args(tmp_path, epochs=1))
    assert len(result["history"]) == 1 and os.path.exists(tmp_path / "cls" / "checkpoint_best.pt")


def test_training_flags_parse():
    args = parse_args(["--device", "cpu", "--betas", "0.8", "0.9", "--head_type", "2",
                       "--label_smoothing", "0.2", "--lr", "0.001", "--epochs", "3",
                       "--resume", "x", "--output_dir", "o", "--use_height"])
    assert args.betas == (0.8, 0.9) and args.head_type == 2 and args.label_smoothing == 0.2
    assert args.lr == 1e-3 and args.epochs == 3 and args.resume == "x" and args.use_height
    defaults = TaskArgs()
    assert (defaults.optim, defaults.sched, defaults.lr, defaults.wd, defaults.betas,
            defaults.eps, defaults.warmup_epochs, defaults.lr_start, defaults.lr_end) == (
        "adamw", "cosine", 3e-3, 0.1, (0.9, 0.98), 1e-8, 1, 1e-6, 1e-5)


@pytest.mark.parametrize("kw,exc,match", [
    (dict(steps_per_dispatch=4), NotImplementedError, "steps_per_dispatch"),
    (dict(optim="lamb"), NotImplementedError, "lamb"),
    (dict(sched="multistep"), NotImplementedError, "multistep"),
    (dict(task="partseg"), NotImplementedError, "partseg"),
    (dict(model="ULIP_PN_NEXT"), KeyError, "ULIP_PN_NEXT"),
    (dict(use_height=True), NotImplementedError, "use_height"),
])
def test_what_the_slice_leaves_out_raises_by_name(tmp_path, kw, exc, match):
    with pytest.raises(exc, match=match):
        cls.main(_args(tmp_path, epochs=1, **kw))


def test_existing_pretrained_dir_is_not_silently_ignored(tmp_path):
    with pytest.raises(NotImplementedError, match="pretrained"):
        cls.setup(_args(tmp_path, pretrained_dir=str(tmp_path)))
    # evaluation loads no backbone from it: the check is the train branch's
    ctx = cls.setup(_args(tmp_path, pretrained_dir=str(tmp_path), evaluate_3d=True))
    assert ctx["state"].step == 0


def test_non_finite_loss_stops_training(tmp_path):
    args = _args(tmp_path, epochs=1)
    ctx = cls.setup(args)
    with torch.no_grad():
        ctx["model"].logit_scale.fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="non-finite loss at epoch 0"):
        cls.train_loop(args, ctx)
