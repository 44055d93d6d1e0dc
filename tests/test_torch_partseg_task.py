"""Port vs reference: part segmentation's metrics, data, checkpoint file and
driver.

``refine_partseg_logits`` and ``partseg_ious`` against
``ppt_tpu.utils.metrics`` on random logits and predictions (absent parts
and categories without samples included): the refined predictions and the
accuracy exactly equal; the IoU means, f32 sums of up to 50 per-part or
per-sample IoUs, within 1e-6 relative (a few ulps), NaN where the
reference has NaN: XLA's CPU reduction adds in an order that no torch
reduction reproduces (sequential up to 16 elements, another order past
it), so the last bit can differ. ``make_synthetic(partseg=True)``, the loader's partseg
batches and ``load_shapenetpart`` on a tiny directory against
``ppt_tpu.data``: exactly equal. The cls trunk's converted file loads into
the partseg trunk (``backbone_file``) and the heads keep their init. Then
``partseg.main`` on the CPU from the published recipe
(``configs/experiments/partseg_shapenetpart.yaml``, read by the port's own
config reader) at a shrunk model, and one ``--evaluate_3d`` pass that reads
its checkpoint back and reproduces its metrics.
"""

import json
import os

import numpy as np
import pytest
import torch

from ppt_torch.data import datasets as tdata
from ppt_torch.data.loader import Loader
from ppt_torch.models.ulip import build_model
from ppt_torch.nn.pointbert import PointBertConfig
from ppt_torch.nn.text import TextConfig
from ppt_torch.tasks import args as targs
from ppt_torch.tasks import partseg
from ppt_torch.utils.metrics import partseg_ious, refine_partseg_logits

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANGES = tdata.SHAPENETPART_PART_RANGES
TINY = dict(trans_dim=48, depth=12, drop_path_rate=0.0, num_heads=4, group_size=8,
            num_group=16, encoder_dims=32)
TEXT = dict(width=64, layers=2, heads=4, embed_dim=64)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def _jax_metrics():
    from ppt_tpu.utils import metrics as jm

    return jm


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_refined_predictions_equal_reference(seed):
    import jax.numpy as jnp

    rng = np.random.RandomState(seed)
    logits = rng.randn(5, 64, 50).astype(np.float32)
    cats = rng.randint(0, 16, 5)
    want = _jax_metrics().refine_partseg_logits(jnp.asarray(logits), jnp.asarray(cats),
                                                jnp.asarray(RANGES))
    got = refine_partseg_logits(torch.from_numpy(logits), torch.from_numpy(cats),
                                torch.from_numpy(RANGES))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    lo, hi = RANGES[cats, 0][:, None], RANGES[cats, 1][:, None]
    assert ((got.numpy() >= lo) & (got.numpy() < hi)).all()


def _ious_case(case, seed):
    """(preds, labels, cats) [B, N]: random predictions within or across the
    category's range; 'absent' labels use one part of each category only,
    'few_cats' samples three categories (the rest empty: NaN)."""
    rng = np.random.RandomState(seed)
    B, N = 12, 96
    cats = rng.choice([4, 9, 15], B) if case == "few_cats" else rng.randint(0, 16, B)
    lo, hi = RANGES[cats, 0][:, None], RANGES[cats, 1][:, None]
    labels = lo + rng.randint(0, 100, (B, N)) % (hi - lo)
    if case == "absent":
        labels = np.broadcast_to(lo, (B, N)).copy()
    preds = lo + rng.randint(0, 100, (B, N)) % (hi - lo)
    if case == "across":
        preds = rng.randint(0, 50, (B, N))
    return preds.astype(np.int32), labels.astype(np.int32), cats.astype(np.int32)


@pytest.mark.parametrize("case", ["random", "absent", "few_cats", "across"])
@pytest.mark.parametrize("seed", [0, 1])
def test_partseg_ious_equal_reference(case, seed):
    import jax.numpy as jnp

    preds, labels, cats = _ious_case(case, seed)
    want = _jax_metrics().partseg_ious(jnp.asarray(preds), jnp.asarray(labels),
                                       jnp.asarray(cats), jnp.asarray(RANGES), 16)
    got = partseg_ious(torch.from_numpy(preds), torch.from_numpy(labels),
                       torch.from_numpy(cats), torch.from_numpy(RANGES), 16)
    assert float(got["accuracy"]) == float(want["accuracy"])
    for k in ("instance_miou", "category_miou", "category_ious"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=0,
                                   err_msg=k)  # NaN where the reference has NaN
    if case == "few_cats":
        assert np.isnan(got["category_ious"].numpy()).sum() == 13
    if case == "absent":  # the parts no point holds nor predicts count IoU 1
        assert float(got["instance_miou"]) > 0


def test_partseg_ious_unit_cases():
    """The reference's own cases (``tests/test_partseg_task.py``)."""
    r, c = torch.from_numpy(RANGES), torch.tensor([4])
    labels = torch.tensor([[12, 12, 13, 14, 15, 12]])
    ious = partseg_ious(labels, labels, c, r, 16)
    assert float(ious["accuracy"]) == 100.0 and abs(float(ious["instance_miou"]) - 100) < 1e-4
    only12 = torch.tensor([[12, 12, 12, 12]])
    assert abs(float(partseg_ious(only12, only12, c, r, 16)["instance_miou"]) - 100) < 1e-4
    half = partseg_ious(only12, torch.tensor([[12, 12, 13, 13]]), c, r, 16)
    assert abs(float(half["instance_miou"]) - 62.5) < 1e-3 and float(half["accuracy"]) == 50.0
    logits = torch.full((1, 5, 50), -1.0)
    logits[0, :, 10], logits[0, :, 2] = 5.0, 1.0  # part 10 lies outside the Airplane's [0, 4)
    assert (refine_partseg_logits(logits, torch.tensor([0]), r) == 2).all()


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def test_partseg_synthetic_and_batches_equal_reference():
    from ppt_tpu.data import Loader as JaxLoader
    from ppt_tpu.data.datasets import SHAPENETPART_PART_RANGES as JR
    from ppt_tpu.data.datasets import make_synthetic as jax_synthetic

    np.testing.assert_array_equal(RANGES, JR)
    kw = dict(num_classes=40, samples_per_class=3, npoints=32, seed=5, partseg=True)
    ds, jds = tdata.make_synthetic(**kw), jax_synthetic(**kw)
    assert len(ds) == 48 and ds.classnames == jds.classnames == tdata.SHAPENETPART_CATEGORIES
    for key in ("points", "labels", "seg_labels"):
        np.testing.assert_array_equal(getattr(ds, key), getattr(jds, key))
    for shuffle, drop_last in ((True, True), (False, False)):
        got = list(Loader(ds, batch_size=10, shuffle=shuffle, drop_last=drop_last, seed=2))
        want = list(JaxLoader(jds, batch_size=10, shuffle=shuffle, drop_last=drop_last, seed=2,
                              num_processes=1, process_index=0))
        assert len(got) == len(want) == (4 if drop_last else 5)
        for g, w in zip(got, want):
            assert set(g) == set(w) == {"pc", "label", "category", "cls_onehot", "valid"}
            for key in w:
                np.testing.assert_array_equal(g[key], w[key])
                assert g[key].dtype == w[key].dtype, key
    plain = tdata.make_synthetic(num_classes=3, samples_per_class=2, npoints=8)
    assert plain.seg_labels is None and set(next(iter(Loader(plain, 4)))) == {
        "pc", "label", "valid"}


def _write_shapenetpart(root, rng):
    """A tiny ShapeNetPart tree: 16 category folders, three shapes in two of
    them, the split lists."""
    synsets = {name: f"{i:08d}" for i, name in enumerate(tdata.SHAPENETPART_CATEGORIES)}
    with open(os.path.join(root, "synsetoffset2category.txt"), "w") as f:
        for name, syn in synsets.items():
            f.write(f"{name}\t{syn}\n")
            os.makedirs(os.path.join(root, syn))
    shapes = {"train": [(synsets["Airplane"], "a1"), (synsets["Chair"], "c1")],
              "val": [(synsets["Chair"], "c2")], "test": []}
    os.makedirs(os.path.join(root, "train_test_split"))
    for split, items in shapes.items():
        with open(os.path.join(root, "train_test_split", f"shuffled_{split}_file_list.json"),
                  "w") as f:
            json.dump([f"shape_data/{syn}/{sid}" for syn, sid in items], f)
        for syn, sid in items:
            n = 40 + rng.randint(20)
            data = np.concatenate([rng.randn(n, 6), rng.randint(0, 4, (n, 1))], 1)
            np.savetxt(os.path.join(root, syn, sid + ".txt"), data)


def test_load_shapenetpart_equals_reference(tmp_path):
    from ppt_tpu.data.datasets import load_shapenetpart as jax_load

    _write_shapenetpart(str(tmp_path), np.random.RandomState(0))
    for split, n in (("train", 2), ("val", 1), ("trainval", 3)):
        got = tdata.load_shapenetpart(str(tmp_path), split, 64, seed=3)
        want = jax_load(str(tmp_path), split, 64, seed=3)
        assert len(got) == n and got.name == "shapenetpart" and got.num_classes == 16
        for key in ("points", "labels", "seg_labels"):
            np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
    args = targs.TaskArgs(dataset_name="shapenetpart", data_path=str(tmp_path), npoints=64)
    assert len(tdata.build_dataset("shapenetpart", args, "val")) == 1
    args.data_path, args.task = str(tmp_path / "missing"), "partseg"
    fallback = tdata.build_dataset("shapenetpart", args, "train")
    assert fallback.name == "synthetic" and fallback.seg_labels is not None


# ---------------------------------------------------------------------------
# pretrained file, driver
# ---------------------------------------------------------------------------


def _shrink(args):
    args.pointbert_config = PointBertConfig(**TINY)
    args.text_config = TextConfig(**TEXT)
    return args


def test_cls_trunk_file_loads_into_the_partseg_trunk(tmp_path):
    """``ULIP_PointBERT_partseg`` reads ``pointbert.msgpack`` (or
    ``pointbert_ulip2``): every trunk leaf loads, ``pc_projection`` (768
    rows there, 128 here) and the heads keep their init."""
    from ppt_torch.train.checkpoint import backbone_file, load_pretrained_backbones
    from ppt_torch.utils.msgpack import msgpack_serialize

    args = _shrink(targs.TaskArgs(model="ULIP_PointBERT_partseg", num_learnable_prompt_tokens=4,
                                  pretrained_dir=str(tmp_path)))
    assert backbone_file(args) == "pointbert"
    args.ulip2 = True
    assert backbone_file(args) == "pointbert_ulip2"
    cls_args = _shrink(targs.TaskArgs(num_learnable_prompt_tokens=4))
    src = build_model("ULIP_PointBERT", cls_args, device="cpu", seed=5).model
    tree = {"params": {"point_encoder": {}}, "batch_stats": {"point_encoder": {}}}
    for name, t in src.point_encoder.state_dict().items():
        *path, leaf = name.split(".")
        stats = leaf.startswith("running_")
        leaf = {"weight": "scale", "running_mean": "mean", "running_var": "var"}.get(leaf, leaf)
        node = tree["batch_stats" if stats else "params"]["point_encoder"]
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t.numpy()
    tree["params"]["pc_projection"] = src.pc_projection.detach().numpy()
    (tmp_path / "pointbert_ulip2.msgpack").write_bytes(msgpack_serialize(tree))
    model = build_model("ULIP_PointBERT_partseg", args, device="cpu", seed=6).model
    before = {k: v.clone() for k, v in model.state_dict().items()}
    load_pretrained_backbones(args, model)
    sd, want = model.state_dict(), src.point_encoder.state_dict()
    for k, v in sd.items():
        name = k[len("point_encoder."):]
        if name in want:
            assert torch.equal(v, want[name]), k
        else:
            assert torch.equal(v, before[k]), k
    assert torch.equal(sd["pc_projection"], before["pc_projection"])


def test_partseg_main_trains_and_evaluates_from_the_recipe(tmp_path, monkeypatch):
    """One epoch of ``partseg.main`` from the published recipe with
    ``--set`` overrides (synthetic part clouds: ShapeNetPart is not in the
    repository), the best checkpoint written, then ``--evaluate_3d`` reads
    it back into a freshly seeded model and gives the same metrics."""
    import builtins

    real_import = builtins.__import__

    def no_yaml(name, *a, **kw):
        if name == "yaml":
            raise ImportError("PyYAML is blocked here")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_yaml)
    recipe = os.path.join(ROOT, "configs", "experiments", "partseg_shapenetpart.yaml")
    argv = ["--config", recipe, "--set", "epochs=1", "npoints=512", "batch_size=8",
            "--device", "cpu", "--output_dir", str(tmp_path), "--pretrained_dir", "",
            "--num_learnable_prompt_tokens", "4", "--model", "ULIP_PointBERT"]

    def args_of(*extra):
        args = _shrink(targs.parse_args(argv + list(extra)))
        args.num_classes, args.samples_per_class = 4, 2  # 8 train clouds: one step
        return args

    args = args_of()
    assert (args.dataset_name, args.task, args.class_name_position, args.lr) == (
        "shapenetpart", "partseg", "middle", 1e-3)
    result = partseg.main(args)
    assert args.model == "ULIP_PointBERT_partseg"  # forced, as the reference forces it
    assert result["best_epoch"] == 0 and len(result["history"]) == 1
    best = result["best"]
    assert set(best) == {"accuracy", "instance_miou", "category_miou"}
    assert 0 < best["instance_miou"] <= 100 and 0 <= best["accuracy"] <= 100
    assert np.isfinite(result["history"][0]["loss"])
    ckpt = tmp_path / "partseg"
    assert (ckpt / "checkpoint_best.pt").exists()
    meta = json.loads((ckpt / "checkpoint_best.json").read_text())
    assert meta["epoch"] == 0 and meta["instance_miou"] == best["instance_miou"]

    ev = partseg.main(args_of("--evaluate_3d", "--test_ckpt_addr", str(ckpt)))
    assert ev["best_epoch"] == -1 and ev["best"] == best
    fresh = partseg.main(args_of("--evaluate_3d"))  # the seeded init, no checkpoint
    assert fresh["best"] != best
