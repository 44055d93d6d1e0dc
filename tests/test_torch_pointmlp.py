"""Port vs reference: PointMLP's modules, the trunk and ``ULIP_PN_MLP``.

``ConvBnRelu``, ``ResBlock``, ``PreExtraction``, ``PosExtraction``,
``LocalGrouper`` and ``PointMLP`` against ``ppt_tpu/nn/pointmlp.py`` at a
small config (64 points, embed_dim 16, k 8), weights carried over by
``convert.from_jax``, the same numpy inputs through both; then one
``ULIP_PN_MLP`` prompt-tuning step against the reference's trainer.

The port's kNN is the reference's expanded-form ``topk`` in another
library, so ties may come out in another order: a grouper's output is
compared as sets, each channel sorted over the K neighbours (everything
after it is a max over K or a whole-cloud statistic). The clouds are
uniform random, so no two distances tie.

Tolerances: f32 within 1e-5 of the output's max magnitude, bf16 within
2e-2 (the Dense products round to bf16 on both sides, summed in another
order), as ``test_torch_pointnet2.py``; running statistics after one
training-mode call within 1e-5 absolute in f32 and 2e-3 in bf16. The
head's dropouts cannot be matched draw for draw: wherever training mode
is compared, both packages' dropouts are made the identity. The step
keeps ``test_torch_trainer.py``'s loss limit (rel 1e-4) and running
statistics' (abs 1e-5); the prompt's gradient is held within 1e-3 of its
scale (the test says why).
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from test_torch_pointnet2 import close, np_tree, stats_close
from test_torch_trainer import CLASSES, EPOCHS, OPT, SCHED, SMOOTHING, STEPS_PER_EPOCH, TEXT

from ppt_torch.convert import _port_key, from_jax
from ppt_torch.models.losses import smoothed_cross_entropy
from ppt_torch.models.ulip import PromptArrays, build_model, trainable_mask
from ppt_torch.nn import pointmlp as tpm
from ppt_torch.nn.layers import init_dense_
from ppt_torch.nn.text import TextConfig
from ppt_torch.prompt.learner import build_prompt_spec
from ppt_torch.tasks.args import TaskArgs
from ppt_torch.train.optim import build_optimizer, build_schedule
from ppt_torch.train.trainer import create_train_state, make_train_step

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores

SMALL = dict(points=64, embed_dim=16, k_neighbors=(8, 8, 8, 8))
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _dt(name):
    return getattr(torch, name), getattr(jnp, name)


def _cloud(B, N, seed):
    return np.random.RandomState(seed).rand(B, N, 3).astype(np.float32)


@pytest.fixture
def no_dropout(monkeypatch):
    """Both packages' head dropouts as the identity."""

    class Keep(flax.linen.Module):
        rate: float

        @flax.linen.compact
        def __call__(self, x, deterministic=True):
            return x

    monkeypatch.setattr(flax.linen, "Dropout", Keep)
    monkeypatch.setattr(tpm, "dropout", lambda x, rate, train, generator: x)


def flax_variables_from_port(jmodule, tmodule, *inputs):
    """The flax module's variables with the port module's values: the tree's
    shapes by ``jax.eval_shape`` (no compile), each leaf taken from the port
    by the weight bridge's name rule."""
    shapes = jax.eval_shape(jmodule.init, jax.random.PRNGKey(0), *inputs)
    sd = tmodule.state_dict()
    out = {}
    for coll, tree in shapes.items():
        leaves = {}
        for path, leaf in traverse_util.flatten_dict(tree).items():
            got = sd[_port_key(path, coll == "batch_stats")].float().numpy().copy()
            assert got.shape == tuple(leaf.shape), (path, got.shape, leaf.shape)
            leaves[path] = got
        out[coll] = traverse_util.unflatten_dict(leaves)
    return out


def _randomise(tmodule, seed):
    """Dense kernels lecun-normal, and non-trivial BatchNorm and affine."""
    gen = torch.Generator().manual_seed(seed)
    init_dense_(tmodule, gen)
    with torch.no_grad():
        for name, t in tmodule.state_dict(keep_vars=True).items():
            leaf = name.rsplit(".", 1)[-1]
            if name.endswith("bias") and t.dim() == 1 or leaf in ("affine_beta", "running_mean"):
                t.copy_(0.1 * torch.randn(t.shape, generator=gen))
            elif leaf == "running_var":
                t.copy_(0.5 + torch.rand(t.shape, generator=gen))
            elif leaf in ("weight", "affine_alpha"):
                t.copy_(1 + 0.1 * torch.randn(t.shape, generator=gen))


def _pair(jmodule, tmodule, *inputs, seed=2):
    """(flax variables, port module) with the same random weights."""
    _randomise(tmodule, seed)
    variables = flax_variables_from_port(jmodule, tmodule, *[jnp.asarray(x) for x in inputs])
    tmodule.load_state_dict(from_jax(variables.get("params", {}),
                                     variables.get("batch_stats", {}), tmodule))
    return variables, tmodule


def _module_pair(name, dtype):
    """(flax module, port module, inputs) of one PointMLP module."""
    import ppt_tpu.nn.pointmlp as jpm

    tdt, jdt = _dt(dtype)
    rng = np.random.RandomState(1)
    if name == "ConvBnRelu":
        return jpm.ConvBnRelu(12, False, dtype=jdt), tpm.ConvBnRelu(7, 12, False, dtype=tdt), \
            (rng.randn(2, 10, 6, 7).astype(np.float32),)
    if name == "ResBlock":
        return jpm.ResBlock(12, 1.0, False, dtype=jdt), tpm.ResBlock(12, 1.0, False, dtype=tdt), \
            (rng.randn(2, 10, 6, 12).astype(np.float32),)
    if name == "PreExtraction":
        return jpm.PreExtraction(16, 2, 1.0, False, dtype=jdt), \
            tpm.PreExtraction(10, 16, 2, 1.0, False, dtype=tdt), \
            (rng.randn(2, 10, 6, 10).astype(np.float32),)
    return jpm.PosExtraction(16, 2, 1.0, False, dtype=jdt), \
        tpm.PosExtraction(16, 2, 1.0, False, dtype=tdt), (rng.randn(2, 10, 16).astype(np.float32),)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["ConvBnRelu", "ResBlock", "PreExtraction", "PosExtraction"])
def test_modules_match_flax_in_eval_and_train(name, dtype):
    jmod, tmod, inputs = _module_pair(name, dtype)
    variables, tmod = _pair(jmod, tmod, *inputs)
    stats = variables["batch_stats"]
    jin = [jnp.asarray(x) for x in inputs]
    tin = [torch.from_numpy(x) for x in inputs]
    want = jmod.apply(variables, *jin)
    with torch.no_grad():
        got = tmod(*tin)
    assert got.dtype == torch.float32  # BatchNorm's f32 output, whatever the Dense dtype
    close(got.numpy(), want, TOL[dtype])
    want, mutated = jmod.apply(variables, *jin, True, mutable=["batch_stats"])
    with torch.no_grad():
        got = tmod(*tin, train=True)
    close(got.numpy(), want, TOL[dtype])
    stats_close(tmod, np_tree(mutated["batch_stats"]), stats,
                atol=1e-5 if dtype == "float32" else 2e-3)


@pytest.mark.parametrize("normalize,use_xyz", [("anchor", False), ("center", True), ("", False)])
def test_local_grouper_matches_flax_as_sets(normalize, use_xyz):
    import ppt_tpu.nn.pointmlp as jpm

    rng = np.random.RandomState(3)
    xyz = _cloud(2, 48, 4)
    pts = rng.randn(2, 48, 6).astype(np.float32)
    jg = jpm.LocalGrouper(6, 12, 5, use_xyz=use_xyz, normalize=normalize or None)
    tg = tpm.LocalGrouper(6, 12, 5, use_xyz=use_xyz, normalize=normalize)
    variables, tg = _pair(jg, tg, xyz, pts)
    want_xyz, want = jg.apply(variables, jnp.asarray(xyz), jnp.asarray(pts))
    with torch.no_grad():
        got_xyz, got = tg(torch.from_numpy(xyz), torch.from_numpy(pts))
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    assert got.shape == (2, 12, 5, 6 + (3 if use_xyz else 0) + 6)
    close(np.sort(got.numpy(), axis=2), np.sort(np.asarray(want), axis=2), 1e-5)


@pytest.mark.parametrize("dtype,N", [("float32", 96), ("bfloat16", 64)])
def test_pointmlp_trunk_matches_flax_in_eval_and_train(dtype, N, no_dropout):
    """The trunk at 64 configured points, eval and train. At N=96 the
    stages still keep 32, 16, 8 and 4 anchors (``config.points // 2`` and
    on, not the cloud's N), as the reference does. Training mode is
    compared in f32, as ``test_torch_pointnet2.py`` compares the trunks':
    the running statistics within 1e-5 and the output within 1e-3 of its
    scale. Seventeen BatchNorms normalising with their batch statistics
    over as few as 16 rows (the head's) magnify the other summation order
    layer by layer: 1.4e-4 of the output at the head in f32, against 7e-7
    in eval. In bf16 the same stack leaves 0.27 of the output's scale and
    2e-3 in a running variance of the last stage; the modules' bf16
    training mode is compared one by one above."""
    import ppt_tpu.nn.pointmlp as jpm

    tdt, jdt = _dt(dtype)
    xyz = _cloud(16, N, 5)
    jmodel = jpm.PointMLP(jpm.PointMLPConfig(**SMALL), dtype=jdt)
    variables, tmodel = _pair(jmodel, tpm.PointMLP(tpm.PointMLPConfig(**SMALL), dtype=tdt), xyz)
    stats = variables["batch_stats"]
    kept = []
    for i in range(4):
        getattr(tmodel, f"grouper{i}").register_forward_hook(
            lambda mod, args, out: kept.append((args[0].shape[1], out[0].shape[1])))
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(xyz))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(xyz))
    assert kept == [(N, 32), (32, 16), (16, 8), (8, 4)]
    assert got.shape == (16, 256) and got.dtype == torch.float32
    close(got.numpy(), want, TOL[dtype])
    if dtype != "float32":
        return
    want, mutated = jax.jit(lambda v, x: jmodel.apply(v, x, True, mutable=["batch_stats"]))(
        variables, jnp.asarray(xyz))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(xyz), train=True, generator=torch.Generator())
    close(got.numpy(), want, 1e-3)
    stats_close(tmodel, np_tree(mutated["batch_stats"]), stats)


def _mlp_args(**kw):
    args = TaskArgs(num_learnable_prompt_tokens=4, class_name_position="middle", **kw)
    args.text_config = TextConfig(**TEXT)
    args.pointmlp_config = tpm.PointMLPConfig(**SMALL)
    return args


def test_ulip_pn_mlp_prompt_step_matches_the_reference(no_dropout):
    """One head_type 0 step of ``ULIP_PN_MLP`` from the same weights on the
    same batch of 32 clouds: the loss and the prompt's gradient of the
    training-mode forward (``jax.value_and_grad`` of the reference's
    composite against the port's trainer step and autograd), and the frozen
    tower's BatchNorm buffers after the step. The gradient is held within
    1e-3 of its scale: it passes through the training-mode tower, whose
    output the trunk test above holds within 1e-3 (measured 1.4e-4)."""
    from ppt_tpu.models import PromptArrays as JaxPrompts
    from ppt_tpu.models import Ulip as JaxUlip
    from ppt_tpu.models.losses import smoothed_cross_entropy as jax_ce
    from ppt_tpu.nn import TextConfig as JaxTextConfig
    from ppt_tpu.nn.pointmlp import PointMLP as JaxPointMLP
    from ppt_tpu.nn.pointmlp import PointMLPConfig as JaxConfig
    from ppt_tpu.prompt import build_prompt_spec as jax_spec

    from test_torch_trainer import flat, port_name, torch_batch

    jmodel = JaxUlip(point_encoder=JaxPointMLP(JaxConfig(**SMALL)), pc_feat_dims=256, n_ctx=4,
                     text_config=JaxTextConfig(**TEXT))
    jprompts = JaxPrompts.from_spec(jax_spec(CLASSES, n_ctx=4, class_name_position="middle"))
    model = build_model("ULIP_PN_MLP", _mlp_args(), device="cpu").model
    variables = flax_variables_from_port(jmodel, model, jnp.asarray(_cloud(2, 64, 0)), jprompts)
    rng = np.random.RandomState(7)
    b = {"pc": _cloud(32, 64, 8), "label": rng.randint(0, len(CLASSES), 32).astype(np.int32)}

    def jloss(tokens):
        params = dict(variables["params"], prompt_learner={"learnable_tokens": tokens})
        logits, mutated = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(b["pc"]),
            jprompts, train=True, mutable=["batch_stats"])
        return jax_ce(logits, jnp.asarray(b["label"]), SMOOTHING), mutated["batch_stats"]

    tokens0 = variables["params"]["prompt_learner"]["learnable_tokens"]
    (want_loss, want_stats), want_grad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(tokens0))
    want_loss = float(want_loss)

    prompts = PromptArrays.from_spec(
        build_prompt_spec(CLASSES, n_ctx=4, class_name_position="middle"), device="cpu")
    tokens = model.prompt_learner.learnable_tokens
    buffers0 = {k: v.clone() for k, v in model.named_buffers()}
    loss = smoothed_cross_entropy(model(torch.from_numpy(b["pc"]), prompts, train=True),
                                  torch.from_numpy(b["label"]).long(), SMOOTHING)
    grad, = torch.autograd.grad(loss, [tokens])
    loss_value = float(loss.detach())
    assert abs(loss_value - want_loss) <= 1e-4 * abs(want_loss), (loss_value, want_loss)
    close(grad.numpy(), np.asarray(want_grad), 1e-3)
    with torch.no_grad():
        for k, v in model.named_buffers():
            v.copy_(buffers0[k])

    sched = build_schedule("cosine", 3e-3, EPOCHS, STEPS_PER_EPOCH, **SCHED)
    state = create_train_state(model, trainable_mask(model, head_type=0),
                               lambda tr: build_optimizer("adamw", tr.items(), sched, **OPT),
                               seed=1)
    state, m = make_train_step(smoothing=SMOOTHING)(state, torch_batch(b), prompts)
    assert abs(float(m["loss"]) - want_loss) <= 1e-4 * abs(want_loss)
    assert not torch.equal(state.trainable["prompt_learner.learnable_tokens"],
                           torch.from_numpy(tokens0))
    buffers = dict(model.named_buffers())
    for path, want in flat(np_tree(want_stats)).items():
        np.testing.assert_allclose(buffers[port_name(path)].numpy(), want, rtol=0, atol=1e-5,
                                   err_msg=str(path))


@pytest.mark.parametrize("head_type", [1, 2, 3])
def test_head_types_train_only_the_prompt(head_type):
    """``_HEAD_TYPE_UNFREEZE`` names PointBERT's ``block_11``, which PointMLP
    lacks: only the prompt trains, as in the reference."""
    model = build_model("ULIP_PN_MLP", _mlp_args(), device="cpu").model
    mask = trainable_mask(model, head_type=head_type)
    assert [k for k, v in mask.items() if v] == ["prompt_learner.learnable_tokens"]


def test_use_height_is_refused_by_name():
    with pytest.raises(NotImplementedError, match="ULIP_PN_MLP takes xyz"):
        build_model("ULIP_PN_MLP", _mlp_args(use_height=True), device="cpu")
