"""The serving export (``ppt_torch/tools/export.py``) on the CPU.

The five tests of ``tests/test_export.py`` in the port's terms (round trip,
baked weights, symbolic batch, the CLI's files, a checkpoint's restore),
then: the port's loaded program against ``ppt_tpu``'s exported program on
the same weights and clouds; the logit scale read from the shipped leaf; the
graph's ``ppt`` operators, none of them decomposed; and no
``autograd.Function`` in the graph.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import __graft_entry__ as graft
from ppt_tpu.tools import export as jexport
from ppt_torch.convert import from_jax
from ppt_torch.kernels import _autograd
from ppt_torch.tasks import cls
from ppt_torch.tools import export
from ppt_torch.train.checkpoint import save_checkpoint
from ppt_torch.utils.msgpack import msgpack_serialize

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores

CPU = torch.device("cpu")
B, N = 4, 128
# the ops the tiny graph calls: one grouping, one encoder, depth 2 = one block + the readout
TINY_OPS = {"fps_batched": 1, "fused_vit_block": 1, "fused_vit_block_readout": 1,
            "knn_gather": 1, "mini_forward": 1}


def clouds(n, seed=1):
    return torch.from_numpy(np.random.RandomState(seed).rand(n, N, 3).astype(np.float32))


@pytest.fixture(scope="module")
def tiny():
    args = export.flagship_args(True, CPU)
    model, prompts = export.flagship(args, CPU)
    pc = clouds(5)
    with torch.no_grad():
        ref = model(pc, prompts)
    return args, model, prompts, pc, ref


@pytest.fixture(scope="module")
def unbaked(tiny, tmp_path_factory):
    _, model, prompts, _, _ = tiny
    path = str(tmp_path_factory.mktemp("unbaked") / export.ARTIFACT)
    export.save_exported(export.export_serving(model, prompts, batch=B, npoints=N), path)
    return path


def test_roundtrip_matches_eager(tiny, unbaked):
    """The program takes the pruned serving leaves (the text tower baked, not
    shipped) and gives the eager model's logits bit for bit."""
    _, model, _, pc, ref = tiny
    sv = export.serving_variables(model)
    assert not any(k.startswith(("text.", "prompt_learner.")) for k in sv)
    assert {"logit_scale", "pc_projection", "point_encoder.encoder.bn1.running_mean"} <= set(sv)
    call = export.load_exported(unbaked, weights=sv)
    out = call(pc[:B])
    assert out.shape == (B, 40) and torch.equal(out, ref[:B])
    # the full tree no longer matches the calling convention
    with pytest.raises((ValueError, RuntimeError, TypeError)):
        call.program.module()(model.state_dict(), pc[:B])


def test_baked_weights_self_contained(tiny, tmp_path):
    _, model, prompts, pc, ref = tiny
    path = str(tmp_path / export.ARTIFACT)
    export.save_exported(
        export.export_serving(model, prompts, batch=B, npoints=N, bake_weights=True), path)
    assert not os.path.exists(tmp_path / export.WEIGHTS)
    loaded = torch.export.load(path)
    assert "point_encoder.block_0.attn.qkv.kernel" in loaded.state_dict
    assert torch.equal(export.load_exported(path)(pc[:B]), ref[:B])


def test_symbolic_batch(tiny, tmp_path):
    _, model, prompts, pc, ref = tiny
    ep = export.export_serving(model, prompts, batch=B, npoints=N, bake_weights=True,
                               sym_batch=True)
    path = str(tmp_path / export.ARTIFACT)
    export.save_exported(ep, path)
    call = export.load_exported(path)
    for b in (3, 5):
        assert torch.equal(call(pc[:b]), ref[:b])


def test_cli_main_writes_artifact_weights_meta(tmp_path):
    out = str(tmp_path / "exp")
    export.main(["--out", out, "--tiny", "--device", "cpu", "--batch", "2", "--npoints", str(N)])
    assert os.path.getsize(os.path.join(out, export.ARTIFACT)) > 0
    assert os.path.getsize(os.path.join(out, export.WEIGHTS)) > 0
    meta = json.load(open(os.path.join(out, export.META)))
    assert meta["baked_weights"] is False and meta["device"] == "cpu"
    assert meta["ppt_ops"] == TINY_OPS and meta["n_classes"] == 40
    assert meta["artifact_bytes"] == os.path.getsize(os.path.join(out, export.ARTIFACT))
    assert "constant" in meta["text_embed"] and meta["input"][-1] == f"pc [2, {N}, 3] f32"
    logits = export.load_exported(out)(clouds(2))  # the weights beside it
    assert logits.shape == (2, 40) and torch.isfinite(logits).all()


def test_ckpt_restore_changes_logits(tiny, tmp_path, capsys):
    """A checkpoint whose prompt tokens differ changes the exported text
    constant: the restore lands in the graph."""
    args, model, _, pc, _ = tiny
    fresh, _ = export.flagship(args, CPU)
    state, _ = cls.train_state(args, fresh, 1)
    tokens = fresh.prompt_learner.learnable_tokens
    rng = np.random.RandomState(7)
    with torch.no_grad():
        # random, not constant: a uniform shift lies in the first LayerNorm's null space
        tokens.add_(torch.from_numpy(0.25 * rng.standard_normal(tuple(tokens.shape)))
                    .float())
    save_checkpoint(str(tmp_path / "run"), state)

    base, restored = str(tmp_path / "base"), str(tmp_path / "restored")
    common = ["--tiny", "--device", "cpu", "--batch", "2", "--npoints", str(N), "--bake-weights"]
    export.main(["--out", base, *common])
    export.main(["--out", restored, "--ckpt", str(tmp_path / "run"), *common])
    assert "--ckpt without --pretrained_dir" in capsys.readouterr().err
    again, _ = export.flagship(args, CPU)
    export.restore_ckpt(args, again, str(tmp_path / "run"))
    assert torch.equal(again.prompt_learner.learnable_tokens, tokens)
    a = export.load_exported(base)(pc[:2])
    b = export.load_exported(restored)(pc[:2])
    assert float((a - b).abs().max()) > 1e-3, "restored prompt tokens did not change the logits"


def test_against_the_jax_artifact(tmp_path):
    """``ppt_tpu``'s tiny model and exported program against the port's on
    the same weights (through ``convert.from_jax``) and the same clouds:
    logits within 1e-4 of their largest magnitude (f32). The port's
    ``weights.msgpack`` is the JAX tool's file byte for byte, and the port's
    program runs on the JAX tool's file too."""
    model_j, prompts_j = graft._flagship(tiny=True)
    pc = clouds(B).numpy()
    variables = jax.jit(model_j.init)(jax.random.PRNGKey(0), jnp.asarray(pc[:2]), prompts_j)
    jpath = str(tmp_path / "serve.jaxexport")
    jexport.save_exported(jexport.export_serving(model_j, variables, prompts_j, batch=B,
                                                 npoints=N), jpath)
    sv = jax.tree_util.tree_map(np.asarray, jexport.serving_variables(variables))
    want = np.asarray(jexport.load_exported(jpath).call(sv, pc))

    model, prompts = export.flagship(export.flagship_args(True, CPU), CPU)
    tree = jax.tree_util.tree_map(np.asarray, variables)
    model.load_state_dict(from_jax(tree["params"], tree.get("batch_stats", {}), model))
    path = str(tmp_path / export.ARTIFACT)
    export.save_exported(export.export_serving(model, prompts, batch=B, npoints=N), path)
    got = export.load_exported(path, weights=export.serving_variables(model))(
        torch.from_numpy(pc)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()

    jfile = tmp_path / "jax_weights.msgpack"
    jfile.write_bytes(serialization.to_bytes(sv))
    mine = msgpack_serialize(export.flax_tree(export.serving_variables(model)))
    assert mine == jfile.read_bytes()
    on_jax_file = export.load_exported(path, weights=str(jfile))(torch.from_numpy(pc)).numpy()
    np.testing.assert_array_equal(on_jax_file, got)


def test_logit_scale_is_read_from_the_shipped_leaf(tiny, unbaked, tmp_path):
    """A weights.msgpack with another logit_scale scales the logits by
    exp(min(leaf, ln 100)) / exp(old): the scale is no constant of the
    export, and the clamp is in the graph."""
    _, model, _, pc, ref = tiny
    sv = export.serving_variables(model)
    old = float(sv["logit_scale"])
    for leaf in (1.25, 10.0):
        tree = export.flax_tree({**sv, "logit_scale": torch.tensor(leaf)})
        path = tmp_path / f"w{leaf}.msgpack"
        path.write_bytes(msgpack_serialize(tree))
        got = export.load_exported(unbaked, weights=str(path))(pc[:B])
        factor = np.exp(min(leaf, np.log(100.0))) / np.exp(old)
        want = ref[:B].double() * factor
        assert float((got.double() - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_exported_graph_calls_each_ppt_op(tiny, unbaked):
    """Each kernel is one operator node, none decomposed: no node of the
    plain versions' bodies (sorts, argmaxes, maxima, LayerNorm's rsqrt, the
    GELU's tanh, the attention's softmax) and only the model's own five
    products outside them (two position Denses, reduce_dim, pc_projection,
    the logits)."""
    program = torch.export.load(unbaked)
    assert export.ppt_ops(program) == TINY_OPS
    aten = [str(n.target) for n in program.graph.nodes
            if n.op == "call_function" and str(n.target).startswith("aten.")]
    body = ("aten.sort", "aten.argmax", "aten.amax", "aten.max", "aten.rsqrt", "aten.tanh",
            "aten._softmax", "aten.minimum", "aten.clamp_min")
    assert not [t for t in aten if t.startswith(body)]
    assert sum(t.startswith("aten.matmul") for t in aten) == 5


def test_export_graph_holds_no_autograd_function(tiny, monkeypatch):
    """The eval forward under no_grad never applies ``recompute_grad``'s
    ``autograd.Function``, so the graph holds no node of one."""
    _, model, prompts, _, _ = tiny

    def refuse(*args):
        raise AssertionError("autograd.Function applied on the export path")

    monkeypatch.setattr(_autograd._Recompute, "apply", refuse)
    ep = export.export_serving(model, prompts, batch=B, npoints=N, bake_weights=True)
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert not [t for t in targets if "autograd" in t or "Recompute" in t]
