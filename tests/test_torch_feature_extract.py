"""Port vs reference: frozen-feature extraction and the recognition dump.

``ppt_torch.tasks.feature_extract`` against ``ppt_tpu.tasks.feature_extract``
on the same synthetic split (the two packages' clouds asserted equal first)
with the same weights: a seeded PointBERT and SLIP text tower at the tiny
widths of ``test_torch_ckpt_convert.py``, converted by the port's converter
into a ``--pretrained_dir`` that both packages load, and a learned prompt
restored through ``--test_ckpt_addr`` (the port's ``checkpoint_best.pt``,
the reference's msgpack of the same tokens). Features within 1e-5, labels
equal, logits within 1e-4 of their scale (``test_torch_pretrained.py``'s
limit for this model). Also: the cached-text logits against the per-batch
``model(pc, prompts)`` the reference runs, the padded rows of the last
batch dropped, and both entry points through their argv.
"""

import logging
import os
import runpy
import sys
import warnings

import numpy as np
import pytest
import torch

from test_torch_ckpt_convert import TEXT, TINY_BERT, reference_state_dict, save_pt

from ppt_torch.nn.pointbert import PointBertConfig
from ppt_torch.nn.text import TextConfig
from ppt_torch.tasks import cls, feature_extract
from ppt_torch.tasks.args import TaskArgs
from ppt_torch.tools import ckpt_convert as tconv
from ppt_torch.train.checkpoint import load_checkpoint, save_checkpoint
from ppt_torch.utils.msgpack import msgpack_serialize

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores

N_CTX = 4
CLASSES, PER_CLASS, BATCH = 3, 5, 8  # 15 clouds: the last batch of 8 holds one pad row
FEAT_TOL = 1e-5
LOGIT_TOL = 1e-4  # of the logits' max magnitude


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A --pretrained_dir with the converted PointBERT and SLIP files, and
    the learned prompt as the port's checkpoint and the reference's msgpack."""
    d = tmp_path_factory.mktemp("weights")
    pre = d / "pretrained"
    pre.mkdir()
    for kind, name in (("pointbert", "pointbert"), ("slip", "slip_text")):
        src = save_pt(d / f"{name}.pt", reference_state_dict(kind, 3))
        tconv.convert_file(src, kind, str(pre / f"{name}.msgpack"))
    args = port_args(d, pretrained_dir=str(pre))
    _, model = cls.prompts_and_model(args, ["a", "b", "c"], torch.device("cpu"))
    tokens = torch.randn(N_CTX, TEXT["width"], generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        model.prompt_learner.learnable_tokens.copy_(tokens)
    state, _ = cls.train_state(args, model, 1)
    save_checkpoint(str(d / "run"), state)
    ref_ckpt = d / "prompt.msgpack"
    ref_ckpt.write_bytes(msgpack_serialize(
        {"params": {"prompt_learner": {"learnable_tokens": tokens.numpy()}}}))
    return {"pretrained": str(pre), "port_ckpt": str(d / "run"), "ref_ckpt": str(ref_ckpt),
            "tokens": tokens}


def port_args(out, **kw):
    base = dict(dataset_name="synthetic", npoints=128, batch_size=BATCH,
                num_learnable_prompt_tokens=N_CTX, class_name_position="middle",
                output_dir=str(out), pretrained_dir="", device="cpu")
    base.update(kw)
    args = TaskArgs(**base)
    args.pointbert_config = PointBertConfig(**TINY_BERT)
    args.text_config = TextConfig(**TEXT)
    args.num_classes, args.samples_per_class = CLASSES, PER_CLASS
    return args


@pytest.fixture
def reference(monkeypatch):
    """The reference's task at the same tiny widths: a maker of its ``args``
    and its ``feature_extract`` module."""
    from ppt_tpu.models import ulip as jax_ulip
    from ppt_tpu.nn import PointBert as JaxPointBert
    from ppt_tpu.nn import PointBertConfig as JaxBertConfig
    from ppt_tpu.nn import TextConfig as JaxTextConfig
    from ppt_tpu.tasks import feature_extract as jax_fe
    from ppt_tpu.tasks.args import TaskArgs as JaxArgs

    monkeypatch.setitem(jax_ulip.MODEL_REGISTRY, "ULIP_PointBERT", lambda args: jax_ulip._make(
        "ULIP_PointBERT", JaxPointBert(JaxBertConfig(**TINY_BERT)), 2 * TINY_BERT["trans_dim"],
        args))

    def make(out, **kw):
        base = dict(dataset_name="synthetic", npoints=128, batch_size=BATCH,
                    num_learnable_prompt_tokens=N_CTX, class_name_position="middle",
                    output_dir=str(out), pretrained_dir="")
        base.update(kw)
        args = JaxArgs(**base)
        args.text_config = JaxTextConfig(**TEXT)
        args.num_classes, args.samples_per_class = CLASSES, PER_CLASS
        return args

    return make, jax_fe


def test_the_two_packages_draw_the_same_synthetic_splits(tmp_path):
    from ppt_tpu.data import build_dataset as jax_build

    from ppt_torch.data.datasets import build_dataset

    for split in ("train", "test"):
        got = build_dataset("synthetic", port_args(tmp_path), split)
        want = jax_build("synthetic", port_args(tmp_path), split)
        np.testing.assert_array_equal(got.points, want.points)
        np.testing.assert_array_equal(got.labels, want.labels)
        assert got.classnames == want.classnames


def test_main_writes_the_reference_features(weights, reference, tmp_path):
    make, jax_fe = reference
    got_dir = feature_extract.main(port_args(tmp_path / "port", pretrained_dir=weights[
        "pretrained"], exp_name="feats"))
    want_dir = jax_fe.main(make(tmp_path / "ref", pretrained_dir=weights["pretrained"],
                                exp_name="feats"))
    assert got_dir == str(tmp_path / "port" / "feats")
    for split in ("train", "test"):
        got = np.load(os.path.join(got_dir, f"{split}.npz"))
        want = np.load(os.path.join(want_dir, f"{split}.npz"))
        assert set(got) == {"feature_list", "label_list"}
        assert got["feature_list"].dtype == np.float32
        assert got["feature_list"].shape == (CLASSES * PER_CLASS, 2 * TINY_BERT["trans_dim"])
        np.testing.assert_array_equal(got["label_list"], want["label_list"])
        np.testing.assert_allclose(got["feature_list"], want["feature_list"], rtol=0,
                                   atol=FEAT_TOL)


def test_save_recog_feats_with_a_checkpoint_matches_the_reference(weights, reference, tmp_path):
    """``--test_ckpt_addr`` restores the prompt (the round trip: the logits
    move with it); features, labels and logits against the reference's."""
    make, jax_fe = reference
    args = port_args(tmp_path, pretrained_dir=weights["pretrained"],
                     test_ckpt_addr=weights["port_ckpt"])
    path = feature_extract.save_recog_feats(args)
    assert path == str(tmp_path / "recog_feats" / "recog_feats.npz")
    got = np.load(path)
    want = np.load(jax_fe.save_recog_feats(make(
        tmp_path / "ref", pretrained_dir=weights["pretrained"],
        test_ckpt_addr=weights["ref_ckpt"])))
    assert got["logits"].shape == (CLASSES * PER_CLASS, CLASSES)
    np.testing.assert_array_equal(got["label_list"], want["label_list"])
    np.testing.assert_allclose(got["feature_list"], want["feature_list"], rtol=0, atol=FEAT_TOL)
    scale = np.abs(want["logits"]).max()
    assert np.abs(got["logits"] - want["logits"]).max() <= LOGIT_TOL * scale
    np.testing.assert_array_equal(got["logits"].argmax(-1), want["logits"].argmax(-1))

    # without the checkpoint the seeded prompt gives other logits, the same features
    plain = feature_extract.extract_features(
        port_args(tmp_path, pretrained_dir=weights["pretrained"]), "test", with_logits=True)
    np.testing.assert_array_equal(plain["feature_list"], got["feature_list"])
    assert np.abs(plain["logits"] - got["logits"]).max() > 10 * LOGIT_TOL * scale


def test_cached_text_logits_equal_the_per_batch_forward(weights, tmp_path):
    """The text tower once per split against ``model(pc, prompts)`` a batch,
    the reference's ``encode``: equal to f32 rounding (1e-6 of the scale)."""
    args = port_args(tmp_path, pretrained_dir=weights["pretrained"],
                     test_ckpt_addr=weights["port_ckpt"])
    got = feature_extract.extract_features(args, "test", with_logits=True)
    ctx = cls.setup(args)
    load_checkpoint(weights["port_ckpt"], ctx["state"])
    model, ds = ctx["model"], ctx["test_ds"]
    torch.testing.assert_close(model.prompt_learner.learnable_tokens.detach(), weights["tokens"],
                               rtol=0, atol=0)
    with torch.no_grad():
        want = torch.cat([model(torch.from_numpy(ds.points[i:i + BATCH]), ctx["prompts"])
                          for i in range(0, len(ds), BATCH)]).numpy()
    scale = np.abs(want).max()
    assert np.abs(got["logits"] - want).max() <= 1e-6 * scale


def test_the_padded_rows_of_the_last_batch_are_dropped(weights, tmp_path):
    """15 clouds in batches of 8: 15 rows, each the cloud's own features as a
    batch of 5 gives them (the pad row repeats the last cloud)."""
    base = dict(pretrained_dir=weights["pretrained"])
    got = feature_extract.extract_features(port_args(tmp_path, **base), "test")
    alone = feature_extract.extract_features(port_args(tmp_path, batch_size=5, **base), "test")
    assert got["feature_list"].shape[0] == CLASSES * PER_CLASS == len(got["label_list"])
    np.testing.assert_array_equal(got["label_list"], np.repeat(np.arange(CLASSES), PER_CLASS))
    np.testing.assert_allclose(got["feature_list"], alone["feature_list"], rtol=0, atol=FEAT_TOL)


def test_entry_points_from_argv_and_the_miss_path(tmp_path, caplog, monkeypatch):
    """``main`` and ``save_recog_feats`` take argv, as the module's
    ``__main__`` passes it; a --pretrained_dir without converted files warns and
    keeps the seeded init; without ``--device`` there is no CPU fallback."""
    import ppt_torch.models.ulip as tulip

    real = tulip.ulip_pointbert

    def tiny(args, text_fused="off"):
        args.pointbert_config = PointBertConfig(**TINY_BERT)
        args.text_config = TextConfig(**TEXT)
        return real(args, text_fused)

    monkeypatch.setitem(tulip.MODEL_REGISTRY, "ULIP_PointBERT", tiny)
    empty = tmp_path / "empty"
    empty.mkdir()
    argv = ["--dataset_name", "synthetic", "--npoints", "64", "--batch_size", "16",
            "--num_learnable_prompt_tokens", "4", "--output_dir", str(tmp_path),
            "--pretrained_dir", str(empty), "--device", "cpu"]
    with caplog.at_level(logging.WARNING):
        out = feature_extract.main(argv)
    assert any("pretrained checkpoints not found" in r.getMessage() for r in caplog.records)
    train = np.load(os.path.join(out, "train.npz"))
    assert train["feature_list"].shape == (40 * 8, 2 * TINY_BERT["trans_dim"])  # 40 x 8 clouds
    recog = np.load(feature_extract.save_recog_feats(argv + ["--exp_name", "r"]))
    assert recog["logits"].shape == (40 * 8, 40) and np.isfinite(recog["logits"]).all()
    # the module's __main__: --save_recog_feats selects the recognition dump
    monkeypatch.setattr(sys, "argv", ["feature_extract", "--save_recog_feats", *argv,
                                      "--exp_name", "m"])
    with warnings.catch_warnings():  # runpy re-executes a module already imported
        warnings.filterwarnings("ignore", "'ppt_torch.tasks.feature_extract' found in sys.modules")
        runpy.run_module("ppt_torch.tasks.feature_extract", run_name="__main__")
    np.testing.assert_array_equal(np.load(tmp_path / "m" / "recog_feats.npz")["logits"],
                                  recog["logits"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            feature_extract.main(argv[:-2])
