"""Port vs reference: loading converted ULIP/SLIP backbones.

The port's converter writes ``pointbert.msgpack`` and ``slip_text.msgpack``
from seeded reference-named state dicts (``test_torch_ckpt_convert.py``) at
the tiny widths of ``test_torch_cls_train.py``. ``cls.setup`` with
``--pretrained_dir`` loads them into the port; the reference's
``merge_pretrained`` loads the same files into the same init (the port's
seeded weights as a flax tree). Every leaf must then be bit-equal, and the
eval logits within 1e-4 of their scale (``test_torch_slice.py``'s limit for
the same tiny model). The four point-tower files load bit for bit as the
reference merges them. Also: the logged counts and a partial file, the
``--ulip2`` file name, SLIP's ``logit_scale`` winning over the backbone's,
the miss path's warning, loading under ``--evaluate_3d``, two steps of the
published recipe through ``cls.main`` with the files, and ``CastCache``
dropping its stale copy.
"""

import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from test_torch_ckpt_convert import reference_state_dict, save_pt
from test_torch_cls_train import _args
from test_torch_pointmlp import flax_variables_from_port

from ppt_torch.convert import _port_key
from ppt_torch.models.ulip import build_model
from ppt_torch.tasks import args as targs
from ppt_torch.tasks import cls
from ppt_torch.tools import ckpt_convert as tconv
from ppt_torch.train.checkpoint import load_params_file, merge_pretrained
from ppt_torch.train.eval import make_cached_text_eval
from ppt_torch.utils.msgpack import msgpack_serialize

LOADED = "%s: loaded %d/%d leaves from pretrained"


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """A directory with the converted PointBERT (plain and ULIP-2, other
    seeds) and SLIP files."""
    d = tmp_path_factory.mktemp("pretrained")
    for kind, name, seed in (("pointbert", "pointbert", 0), ("pointbert", "pointbert_ulip2", 5),
                             ("slip", "slip_text", 0)):
        src = save_pt(d / f"{name}.pt", reference_state_dict(kind, seed))
        tconv.convert_file(src, kind, str(d / f"{name}.msgpack"))
        os.remove(src)
    return d


def _counts(caplog):
    return [r.args for r in caplog.records if r.msg == LOADED]


def _leaves(path):
    """(port key, array) of every leaf of a converted file."""
    tree = load_params_file(str(path))
    return {_port_key(p, coll == "batch_stats"): v for coll in tree
            for p, v in traverse_util.flatten_dict(tree[coll]).items()}


def test_loads_bit_equal_to_the_reference_merge_and_logits_agree(converted, tmp_path, caplog,
                                                                 monkeypatch):
    from ppt_tpu.models import PromptArrays as JaxPrompts
    from ppt_tpu.models import Ulip as JaxUlip
    from ppt_tpu.nn import PointBert as JaxPointBert
    from ppt_tpu.nn import PointBertConfig as JaxBertConfig
    from ppt_tpu.nn import TextConfig as JaxTextConfig
    from ppt_tpu.prompt import build_prompt_spec as jax_spec
    from ppt_tpu.train.checkpoint import load_params_file as jax_load
    from ppt_tpu.train.checkpoint import merge_pretrained as jax_merge
    from ppt_tpu.train.trainer import make_cached_text_eval as jax_cached_eval

    from test_torch_slice import _State

    monkeypatch.setenv("PPT_FORCE_FUSED_MINI", "1")
    monkeypatch.setenv("PPT_FUSED_BLOCK", "1")
    args = _args(tmp_path, pretrained_dir=str(converted), evaluate_3d=True)
    init = build_model(args.model, args, device="cpu").model  # the seeded init setup draws
    with caplog.at_level(logging.INFO, logger="ppt_torch.train.checkpoint"):
        ctx = cls.setup(args)
    model = ctx["model"]
    n_params = len(list(model.parameters()))
    n_stats = sum(1 for k, _ in model.named_buffers() if k.endswith(("running_mean",
                                                                      "running_var")))
    pb, slip = _leaves(converted / "pointbert.msgpack"), _leaves(converted / "slip_text.msgpack")
    n_pb_stats = sum(k.endswith(("running_mean", "running_var")) for k in pb)
    assert _counts(caplog) == [
        ("params", len(pb) - n_pb_stats, n_params), ("batch_stats", n_pb_stats, n_stats),
        ("params", len(slip), n_params), ("batch_stats", 0, n_stats)]  # SLIP's empty stats
    # every leaf but the prompt's came from a file
    assert set(pb) | set(slip) == set(model.state_dict()) - {"prompt_learner.learnable_tokens"}

    classnames = ctx["classnames"]
    jmodel = JaxUlip(point_encoder=JaxPointBert(JaxBertConfig(
        trans_dim=64, depth=2, drop_path_rate=0.0, num_heads=2, group_size=8, num_group=16,
        encoder_dims=64)), pc_feat_dims=128, n_ctx=4,
        text_config=JaxTextConfig(width=64, layers=2, heads=4, embed_dim=64))
    jprompts = JaxPrompts.from_spec(jax_spec(classnames, n_ctx=4, class_name_position="middle"))
    pc = ctx["test_ds"].points[:3].astype(np.float32)
    variables = flax_variables_from_port(jmodel, init, jnp.asarray(pc), jprompts)
    for name in ("pointbert", "slip_text"):
        variables = jax_merge(variables, jax_load(str(converted / f"{name}.msgpack")))
    got = model.state_dict()
    for coll in ("params", "batch_stats"):
        for path, want in traverse_util.flatten_dict(variables[coll]).items():
            t = got[_port_key(path, coll == "batch_stats")]
            np.testing.assert_array_equal(t.numpy(), np.asarray(want), err_msg=str(path))

    embed_fn, step_fn = jax_cached_eval(jmodel)
    state = _State(trainable=variables["params"], frozen={}, batch_stats=variables["batch_stats"])
    want = np.asarray(step_fn(state, {"pc": jnp.asarray(pc)}, embed_fn(state, jprompts)))
    embed, step = make_cached_text_eval(model)
    logits = step(model, {"pc": torch.from_numpy(pc)}, embed(model, ctx["prompts"])).numpy()
    assert np.max(np.abs(logits - want)) <= 1e-4 * np.max(np.abs(want))
    np.testing.assert_array_equal(logits.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("kind,model", [("pointnet2_ssg", "ULIP_PN_SSG"),
                                        ("pointnet2_msg", "ULIP_PN_MSG"),
                                        ("pointmlp", "ULIP_PN_MLP"),
                                        ("pointnext", "ULIP_PN_NEXT")])
def test_tower_files_load_as_the_reference_merges_them(kind, model, tmp_path):
    """Each converted point-tower file (with the SLIP file) through the
    port's loader and the reference's ``merge_pretrained`` from the same
    init: every leaf bit-equal (no forward: shapes by ``jax.eval_shape``)."""
    from ppt_tpu.models import PromptArrays as JaxPrompts
    from ppt_tpu.models import Ulip as JaxUlip
    from ppt_tpu.nn import TextConfig as JaxTextConfig
    from ppt_tpu.prompt import build_prompt_spec as jax_spec
    from ppt_tpu.train.checkpoint import load_params_file as jax_load
    from ppt_tpu.train.checkpoint import merge_pretrained as jax_merge

    from test_torch_ckpt_convert import MLP_SMALL, TEXT, _tower

    from ppt_torch.nn.pointmlp import PointMLPConfig
    from ppt_torch.nn.pointnext import PointNextConfig

    d = tmp_path / "dir"
    d.mkdir()
    fname = {"pointnet2_msg": "pointnet2_msg_1kpts"}.get(kind, kind)
    for k, name in ((kind, fname), ("slip", "slip_text")):
        src = save_pt(tmp_path / f"{name}.pt", reference_state_dict(k, seed=4))
        tconv.convert_file(src, k, str(d / f"{name}.msgpack"))
    args = _args(tmp_path, model=model, pretrained_dir=str(d), use_height=kind == "pointnext")
    args.pointmlp_config = PointMLPConfig(**MLP_SMALL)
    args.pointnext_config = PointNextConfig(in_channels=4)
    init = build_model(model, args, device="cpu").model
    loaded = cls.setup(args)["model"].state_dict()

    tower, shape = _tower(kind)
    jmodel = JaxUlip(point_encoder=tower, pc_feat_dims=256, n_ctx=4,
                     text_config=JaxTextConfig(**TEXT))
    jprompts = JaxPrompts.from_spec(jax_spec(["chair", "lamp"], n_ctx=4))
    variables = flax_variables_from_port(jmodel, init, jnp.zeros(shape), jprompts)
    for name in (fname, "slip_text"):
        variables = jax_merge(variables, jax_load(str(d / f"{name}.msgpack")))
    n = 0
    for coll in ("params", "batch_stats"):
        for path, want in traverse_util.flatten_dict(variables[coll]).items():
            np.testing.assert_array_equal(loaded[_port_key(path, coll == "batch_stats")].numpy(),
                                          np.asarray(want), err_msg=str(path))
            n += 1
    assert n == len(loaded)
    assert not torch.equal(loaded["pc_projection"], init.state_dict()["pc_projection"])


def test_a_partial_file_skips_what_does_not_fit(converted, tmp_path, caplog):
    """A ``pc_projection`` of another width and a leaf of a tower the model
    lacks are skipped without error; what no leaf names keeps its init."""
    tree = load_params_file(str(converted / "pointbert.msgpack"))
    tree["params"]["pc_projection"] = np.ones((128, 32), np.float32)
    tree["params"]["point_encoder"]["sa1"] = {"conv0": {"kernel": np.ones((3, 8), np.float32)}}
    tree["batch_stats"]["point_encoder"]["encoder"]["bn1"]["count"] = np.ones(3, np.float32)
    model = build_model("ULIP_PointBERT", _args(tmp_path), device="cpu").model
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with caplog.at_level(logging.INFO, logger="ppt_torch.train.checkpoint"):
        counts = merge_pretrained(model, tree)
    n_file = sum(1 for _ in traverse_util.flatten_dict(tree["params"]))
    n_params = len(list(model.parameters()))
    assert counts["params"] == (n_file - 2, n_params)
    assert _counts(caplog)[0] == ("params", n_file - 2, n_params)
    assert counts["batch_stats"][0] == 4  # the two BatchNorms' mean and var, not "count"
    after = model.state_dict()
    assert torch.equal(after["pc_projection"], before["pc_projection"])
    assert not torch.equal(after["point_encoder.reduce_dim.kernel"],
                           before["point_encoder.reduce_dim.kernel"])
    for k in ("prompt_learner.learnable_tokens", "text.positional_embedding", "logit_scale"):
        assert torch.equal(after[k], before[k]), k


def test_ulip2_file_and_slip_logit_scale_wins(converted, tmp_path):
    """``--ulip2`` reads ``pointbert_ulip2.msgpack``; a backbone file's own
    ``logit_scale`` loads first and SLIP's, loaded after it, wins."""
    d = tmp_path / "dir"
    d.mkdir()
    tree = load_params_file(str(converted / "pointbert_ulip2.msgpack"))
    tree["params"]["logit_scale"] = np.asarray(np.float32(1.0)).reshape(())
    (d / "pointbert_ulip2.msgpack").write_bytes(msgpack_serialize(tree))
    (d / "pointbert.msgpack").write_bytes((converted / "pointbert.msgpack").read_bytes())
    (d / "slip_text.msgpack").write_bytes((converted / "slip_text.msgpack").read_bytes())
    for ulip2, name in ((True, "pointbert_ulip2"), (False, "pointbert")):
        model = cls.setup(_args(tmp_path, pretrained_dir=str(d), ulip2=ulip2))["model"]
        want = _leaves(converted / f"{name}.msgpack")
        for key in ("point_encoder.block_1.attn.qkv.kernel", "pc_projection"):
            np.testing.assert_array_equal(model.state_dict()[key].numpy(), want[key])
        assert float(model.logit_scale) == pytest.approx(np.log(1 / 0.07) + 0.25, abs=1e-6)
    # the backbone alone: its own logit_scale
    os.remove(d / "slip_text.msgpack")
    model = cls.setup(_args(tmp_path, pretrained_dir=str(d), ulip2=True))["model"]
    assert float(model.logit_scale) == 1.0


@pytest.mark.parametrize("evaluate", [False, True], ids=["train", "evaluate_3d"])
def test_a_directory_without_files_warns_and_keeps_the_init(tmp_path, caplog, evaluate):
    empty = tmp_path / "empty"
    empty.mkdir()
    args = _args(tmp_path, pretrained_dir=str(empty), evaluate_3d=evaluate)
    want = build_model(args.model, args, device="cpu").model.state_dict()
    with caplog.at_level(logging.WARNING, logger="ppt_torch.tasks.cls"):
        ctx = cls.setup(args)
    assert f"pretrained checkpoints not found under {empty}; random init" in caplog.text
    got = ctx["model"].state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_evaluate_3d_loads_and_the_recipe_trains_two_steps(converted, tmp_path, monkeypatch):
    """``ppt_base_mn40.yaml`` (``ulip2: true``) through ``cls.main`` with the
    files: the ULIP-2 tower loaded before the trainable partition and the
    optimizer, two steps (4 batches of 8 at ``data_ratio`` 0.4), the frozen
    leaves still the file's after them, the prompt moved; then
    ``--evaluate_3d`` from the same directory loads them too."""
    from test_torch_recipes import _argv, _shrink

    seen = {}

    def parse_and_shrink(argv=None):
        args = _shrink(targs.parse_args(argv))
        args.num_classes, args.samples_per_class = 4, 8
        seen["args"] = args
        return args

    def setup(args):
        seen["ctx"] = ctx = SETUP(args)
        seen["prompt0"] = ctx["model"].prompt_learner.learnable_tokens.detach().clone()
        return ctx

    SETUP = cls.setup
    monkeypatch.setattr(cls, "parse_args", parse_and_shrink)
    monkeypatch.setattr(cls, "setup", setup)
    out = cls.main(_argv("ppt_base_mn40.yaml", tmp_path, "--pretrained_dir", str(converted)))
    assert seen["args"].ulip2 and seen["args"].pretrained_dir == str(converted)
    state, model = seen["ctx"]["state"], seen["ctx"]["model"]
    assert state.step == 2 and np.isfinite(out["history"][0]["loss"])
    want = _leaves(converted / "pointbert_ulip2.msgpack")
    got = model.state_dict()
    for key in ("point_encoder.block_0.mlp.fc1.kernel", "pc_projection"):
        np.testing.assert_array_equal(got[key].numpy(), want[key])
    assert not torch.equal(got["prompt_learner.learnable_tokens"], seen["prompt0"])

    model = SETUP(_args(tmp_path, pretrained_dir=str(converted), evaluate_3d=True))["model"]
    want = _leaves(converted / "pointbert.msgpack")
    np.testing.assert_array_equal(model.state_dict()["pc_projection"].numpy(),
                                  want["pc_projection"])


def test_cast_cache_drops_its_stale_copy(converted, tmp_path):
    """The tower route's stacked weights, cached before a load, are rebuilt
    from the loaded ones: the in-place copies bump the parameters'
    versions."""
    model = build_model("ULIP_PointBERT", _args(tmp_path), device="cpu").model
    tower = model.point_encoder
    with torch.no_grad():
        stale = tower.stacked_weights()
        assert tower.stacked_weights() is stale  # cached
        merge_pretrained(model, load_params_file(str(converted / "pointbert.msgpack")))
        fresh = tower.stacked_weights()
    assert fresh is not stale
    want = _leaves(converted / "pointbert.msgpack")
    qkv = np.stack([want[f"point_encoder.block_{i}.attn.qkv.kernel"] for i in range(2)])
    stacked = [w for w in fresh if tuple(w.shape) == qkv.shape]
    assert stacked and any(np.array_equal(w.float().numpy(), qkv) for w in stacked)
    assert not any(np.array_equal(w.float().numpy(), qkv) for w in stale
                   if tuple(w.shape) == qkv.shape)
