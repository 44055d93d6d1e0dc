"""Port vs reference: the PointNeXt layers, the trunk, and its train step.

``SetAbstractionNext``, ``GlobalAggregation``, ``InvResMLP`` and
``PointNext`` (the S plan at reduced N, and a plan with an ``InvResMLP``
block) against the flax modules with weights through
``convert.from_jax``; then three head_type 0 train steps of
``ULIP_PN_NEXT`` in lockstep with the reference's trainer.

The clouds lie on a 1/64 lattice, so the reference's expanded-form ball
query on the CPU and the port's kernel-form plain version pick the same
neighbours at every stage (``test_torch_pointnet2.py`` says why; none of
0.15 * 1.5**k squares to a multiple of 1/4096 either).

Tolerances: f32 within 1e-5 of the output's max magnitude; bf16 within
2e-2; running statistics after one training-mode call within 1e-5
absolute in f32. The head's dropout is pinned to 0 wherever training mode
is compared (its draws cannot be matched). The lockstep steps keep
``test_torch_trainer.py``'s limits: loss rel 1e-4 per step, the prompt
tokens and the running statistics abs 1e-5, frozen leaves bit-unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pointnet2 import (TOL, close, flax_variables, lattice_cloud, np_tree,
                                  stats_close)
from test_torch_trainer import (CLASSES, EPOCHS, OPT, SCHED, SMOOTHING, STEPS_PER_EPOCH, TEXT,
                                flat, jax_batch, port_name, torch_batch)

from ppt_torch.convert import from_jax
from ppt_torch.models.ulip import PromptArrays, build_model, trainable_mask
from ppt_torch.nn import pointnext as tpn
from ppt_torch.nn.text import TextConfig
from ppt_torch.prompt.learner import build_prompt_spec
from ppt_torch.tasks.args import TaskArgs
from ppt_torch.train.optim import build_optimizer, build_schedule
from ppt_torch.train.trainer import create_train_state, make_train_step

S_SMALL = dict(head_dropout=0.0)  # the S plan; N is reduced by the input
BLOCKY = dict(in_channels=3, width=8, blocks=(1, 2, 1), strides=(1, 2, 2), radius=0.3,
              nsample=6, expansion=2, head_mlps=(24, 16), head_dropout=0.0)


def _dt(name):
    return getattr(torch, name), getattr(jnp, name)


def test_config_plans_match_the_reference():
    from ppt_tpu.nn.pointnext import PointNextConfig as JaxConfig

    for plan in (None, "b", "l", "xl"):
        t = tpn.PointNextConfig() if plan is None else getattr(tpn.PointNextConfig, plan)()
        j = JaxConfig() if plan is None else getattr(JaxConfig, plan)()
        assert t.stage_channels() == j.stage_channels() and t.stage_radii() == j.stage_radii()
        assert (t.blocks, t.strides, t.sa_layers, t.sa_use_res, t.width, t.nsample) == (
            j.blocks, j.strides, j.sa_layers, j.sa_use_res, j.width, j.nsample)
    assert tpn.PointNextConfig().stage_channels() == (32, 64, 128, 256, 512, 512)
    np.testing.assert_allclose(tpn.PointNextConfig().stage_radii()[1:5],
                               (0.15, 0.225, 0.3375, 0.50625))


@pytest.mark.parametrize("dtype,cin,cout", [("float32", 8, 16), ("bfloat16", 8, 16),
                                            ("float32", 16, 16)])
def test_set_abstraction_next_matches_flax(dtype, cin, cout):
    """Eval and training mode; ``cin == cout`` has no ``skipconv``."""
    from ppt_tpu.nn.pointnext import SetAbstractionNext as JaxSA

    tdt, jdt = _dt(dtype)
    rng = np.random.RandomState(0)
    xyz = lattice_cloud(2, 64, 1)
    feats = rng.randn(2, 64, cin).astype(np.float32)
    jsa = JaxSA(cout, 2, 0.3, 7, dtype=jdt)
    params, stats = flax_variables(jsa, rng, jnp.asarray(xyz), jnp.asarray(feats))
    assert ("skipconv" in params) == (cin != cout)
    tsa = tpn.SetAbstractionNext(cin, cout, 2, 0.3, 7, dtype=tdt)
    tsa.load_state_dict(from_jax(params, stats, tsa))
    variables = {"params": params, "batch_stats": stats}
    want_xyz, want = jsa.apply(variables, jnp.asarray(xyz), jnp.asarray(feats))
    with torch.no_grad():
        got_xyz, got = tsa(torch.from_numpy(xyz), torch.from_numpy(feats))
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    assert got.shape == (2, 32, cout)
    close(got.numpy(), want, TOL[dtype])
    (_, want), mutated = jsa.apply(variables, jnp.asarray(xyz), jnp.asarray(feats), True,
                                   mutable=["batch_stats"])
    with torch.no_grad():
        _, got = tsa(torch.from_numpy(xyz), torch.from_numpy(feats), train=True)
    close(got.numpy(), want, TOL[dtype])
    stats_close(tsa, np_tree(mutated["batch_stats"]), stats,
                atol=1e-5 if dtype == "float32" else 2e-3)


def test_nsample_is_clamped_to_the_cloud():
    from ppt_tpu.nn.pointnext import SetAbstractionNext as JaxSA

    rng = np.random.RandomState(1)
    xyz = lattice_cloud(2, 12, 2)
    feats = rng.randn(2, 12, 4).astype(np.float32)
    jsa = JaxSA(8, 2, 0.6, 32)
    params, stats = flax_variables(jsa, rng, jnp.asarray(xyz), jnp.asarray(feats))
    _, want = jsa.apply({"params": params, "batch_stats": stats}, jnp.asarray(xyz),
                        jnp.asarray(feats))
    tsa = tpn.SetAbstractionNext(4, 8, 2, 0.6, 32)
    tsa.load_state_dict(from_jax(params, stats, tsa))
    with torch.no_grad():
        _, got = tsa(torch.from_numpy(xyz), torch.from_numpy(feats))
    close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_aggregation_and_inv_res_mlp_match_flax(dtype):
    from ppt_tpu.nn.pointnext import GlobalAggregation as JaxGlobal
    from ppt_tpu.nn.pointnext import InvResMLP as JaxInv

    tdt, jdt = _dt(dtype)
    rng = np.random.RandomState(2)
    xyz = lattice_cloud(2, 40, 3)
    feats = rng.randn(2, 40, 8).astype(np.float32)
    pairs = (
        (JaxGlobal(12, 2, dtype=jdt), tpn.GlobalAggregation(8, 12, 2, dtype=tdt)),
        (JaxInv(8, 0.35, 6, 2, dtype=jdt), tpn.InvResMLP(8, 0.35, 6, 2, dtype=tdt)),
    )
    for jmod, tmod in pairs:
        params, stats = flax_variables(jmod, rng, jnp.asarray(xyz), jnp.asarray(feats))
        tmod.load_state_dict(from_jax(params, stats, tmod))
        variables = {"params": params, "batch_stats": stats}
        want = jmod.apply(variables, jnp.asarray(xyz), jnp.asarray(feats))
        with torch.no_grad():
            got = tmod(torch.from_numpy(xyz), torch.from_numpy(feats))
        close(got.numpy(), want, TOL[dtype])
        want, mutated = jmod.apply(variables, jnp.asarray(xyz), jnp.asarray(feats), True,
                                   mutable=["batch_stats"])
        with torch.no_grad():
            got = tmod(torch.from_numpy(xyz), torch.from_numpy(feats), train=True)
        close(got.numpy(), want, TOL[dtype])
        stats_close(tmod, np_tree(mutated["batch_stats"]), stats,
                    atol=1e-5 if dtype == "float32" else 2e-3)


@pytest.mark.parametrize("plan,dtype", [("s", "float32"), ("s", "bfloat16"),
                                        ("blocky", "float32"), ("blocky", "bfloat16")])
def test_pointnext_trunk_matches_flax(plan, dtype):
    """The S plan (6 stages, 4 input channels, full widths) at N=64, and a
    plan with an InvResMLP block and no group-all tail; eval, then one
    training-mode call with the head's dropout at 0."""
    from ppt_tpu.nn.pointnext import PointNext as JaxPointNext
    from ppt_tpu.nn.pointnext import PointNextConfig as JaxConfig

    tdt, jdt = _dt(dtype)
    kw = S_SMALL if plan == "s" else BLOCKY
    rng = np.random.RandomState(3)
    pts = lattice_cloud(16, 64, 4, channels=kw.get("in_channels", 4))
    jmodel = JaxPointNext(JaxConfig(**kw), dtype=jdt)
    params, stats = flax_variables(jmodel, rng, jnp.asarray(pts))
    tmodel = tpn.PointNext(tpn.PointNextConfig(**kw), dtype=tdt)
    tmodel.load_state_dict(from_jax(params, stats, tmodel))
    if plan == "blocky":
        assert "stage1_block1" in params and "stage2_sa" in params
    else:
        assert {"stem", "stage1_sa", "stage4_sa", "stage5_global", "head_fc1"} <= set(params)
    variables = {"params": params, "batch_stats": stats}
    want = jmodel.apply(variables, jnp.asarray(pts))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(pts))
    assert got.shape == (16, kw.get("head_mlps", (512, 256))[-1]) and got.dtype == torch.float32
    close(got.numpy(), want, TOL[dtype])
    want, mutated = jmodel.apply(variables, jnp.asarray(pts), True, mutable=["batch_stats"])
    with torch.no_grad():
        got = tmodel(torch.from_numpy(pts), train=True)
    # the head normalises 16 rows by their own sqrt(var + 1e-5): a channel that
    # hardly varies over the batch magnifies the towers' rounding differences
    # (5e-4 seen in f32, 5e-2 in bf16), so the training-mode feature gets a
    # sanity bound and the buffers, which are what training keeps, the tight one
    close(got.numpy(), want, {"float32": 5e-3, "bfloat16": 0.15}[dtype])
    # bf16: a rounding flip early in the tower moves the later layers' statistics
    stats_close(tmodel, np_tree(mutated["batch_stats"]), stats,
                atol=1e-5 if dtype == "float32" else 2e-2)


def test_pointnext_refuses_the_wrong_channel_count():
    model = tpn.PointNext(tpn.PointNextConfig(in_channels=4))
    with pytest.raises(ValueError, match="use_height"):
        model(torch.rand(1, 16, 3))


# the head's training-mode BatchNorm normalises over the batch's rows: with 32 they
# are conditioned well enough for test_torch_trainer.py's limits (4 are not)
LOCKSTEP_BATCH = 32


def _tiny_args(**kw):
    args = TaskArgs(num_learnable_prompt_tokens=4, class_name_position="middle", **kw)
    args.text_config = TextConfig(**TEXT)
    args.pointnext_config = tpn.PointNextConfig(**S_SMALL)
    return args


def test_pn_next_train_step_lockstep_with_reference(tmp_path):
    """Three head_type 0 steps of ``ULIP_PN_NEXT`` (S plan, N=64, 4 channels)
    from the same weights on the same batches: the frozen tower's BatchNorm
    buffers move every step and must agree with the reference's. Then the
    reference's checkpoint payload goes into a fresh port state through
    ``train_state_from_jax``: the new tree's leaves (``conv/kernel`` without
    bias, ``skipconv``, ``stem``, ``head_fc*``/``head_bn*``, BatchNorm
    ``mean``/``var``) land bit for bit."""
    from flax import serialization
    from ppt_tpu.train.checkpoint import save_checkpoint as jax_save

    from ppt_torch.convert import train_state_from_jax
    from ppt_tpu.models import PromptArrays as JaxPrompts
    from ppt_tpu.models import Ulip as JaxUlip
    from ppt_tpu.models import trainable_mask as jax_mask
    from ppt_tpu.nn import TextConfig as JaxTextConfig
    from ppt_tpu.nn.pointnext import PointNext as JaxPointNext
    from ppt_tpu.nn.pointnext import PointNextConfig as JaxConfig
    from ppt_tpu.prompt import build_prompt_spec as jax_spec
    from ppt_tpu.train.optim import build_optimizer as jax_optimizer
    from ppt_tpu.train.optim import build_schedule as jax_schedule
    from ppt_tpu.train.trainer import create_train_state as jax_create
    from ppt_tpu.train.trainer import make_train_step as jax_make_step

    jmodel = JaxUlip(point_encoder=JaxPointNext(JaxConfig(**S_SMALL)), pc_feat_dims=256,
                     n_ctx=4, text_config=JaxTextConfig(**TEXT))
    jprompts = JaxPrompts.from_spec(jax_spec(CLASSES, n_ctx=4, class_name_position="middle"))
    variables = np_tree(jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, 64, 4)) + 0.5,
                                    jprompts))
    opt = jax_optimizer("adamw", jax_schedule("cosine", 3e-3, EPOCHS, STEPS_PER_EPOCH, **SCHED),
                        **OPT)
    jstate = jax_create(jax.tree_util.tree_map(jnp.asarray, variables),
                        jax_mask(variables["params"], head_type=0), opt, jax.random.PRNGKey(1))
    jstep = jax_make_step(jmodel, opt, smoothing=SMOOTHING)

    model = build_model("ULIP_PN_NEXT", _tiny_args(use_height=True), device="cpu").model
    model.load_state_dict(from_jax(variables["params"], variables["batch_stats"], model))
    sched = build_schedule("cosine", 3e-3, EPOCHS, STEPS_PER_EPOCH, **SCHED)
    state = create_train_state(model, trainable_mask(model, head_type=0),
                               lambda tr: build_optimizer("adamw", tr.items(), sched, **OPT),
                               seed=1)
    step = make_train_step(smoothing=SMOOTHING)
    prompts = PromptArrays.from_spec(
        build_prompt_spec(CLASSES, n_ctx=4, class_name_position="middle"), device="cpu")
    assert sorted(state.trainable) == ["prompt_learner.learnable_tokens"]
    frozen0 = {k: v.detach().clone() for k, v in model.named_parameters()
               if k not in state.trainable}
    stats0 = {k: v.clone() for k, v in state.batch_stats().items()}
    assert len(stats0) == 2 * (2 * 4 + 2 + 2)  # 4 SA stages x 2, the tail's 2, the head's 2

    rng = np.random.RandomState(0)
    for i in range(3):
        b = {"pc": lattice_cloud(LOCKSTEP_BATCH, 64, 10 + i, channels=4),
             "label": rng.randint(0, len(CLASSES), LOCKSTEP_BATCH).astype(np.int32)}
        jstate, jm = jstep(jstate, jax_batch(b), jprompts)
        state, m = step(state, torch_batch(b), prompts)
        want = float(jm["loss"])
        assert abs(float(m["loss"]) - want) <= 1e-4 * abs(want), (i, float(m["loss"]), want)

    want = np.asarray(jstate.trainable["prompt_learner"]["learnable_tokens"])
    got = state.trainable["prompt_learner.learnable_tokens"].detach().numpy()
    assert np.max(np.abs(got - want)) <= 1e-5
    tokens0 = np.asarray(variables["params"]["prompt_learner"]["learnable_tokens"])
    assert np.max(np.abs(got - tokens0)) > 1e-4  # the prompt was tuned
    buffers = dict(model.named_buffers())
    for path, want in flat(np_tree(jstate.batch_stats)).items():
        got = buffers[port_name(path)].numpy()
        assert np.max(np.abs(got - want)) <= 1e-5, (path, np.max(np.abs(got - want)))
    assert all(not torch.equal(v, stats0[k]) for k, v in state.batch_stats().items())
    for k, v in model.named_parameters():
        if k in frozen0:
            assert torch.equal(v, frozen0[k]) and v.grad is None, k

    jax_save(str(tmp_path), jstate)
    with open(tmp_path / "checkpoint_best.msgpack", "rb") as f:
        payload = serialization.msgpack_restore(f.read())
    fresh = build_model("ULIP_PN_NEXT", _tiny_args(use_height=True), device="cpu", seed=5).model
    fstate = create_train_state(fresh, trainable_mask(fresh, head_type=0),
                                lambda tr: build_optimizer("adamw", tr.items(), sched, **OPT),
                                seed=1)
    fstate = train_state_from_jax(payload, fstate)
    assert fstate.step == 3 and fstate.optimizer.count == 3
    np.testing.assert_array_equal(
        fstate.trainable["prompt_learner.learnable_tokens"].detach().numpy(),
        np.asarray(payload["trainable"]["prompt_learner"]["learnable_tokens"]))
    carried = dict(fresh.named_buffers())
    leaves = flat(payload["batch_stats"])
    assert len(leaves) == len(stats0)
    for path, want in leaves.items():
        np.testing.assert_array_equal(carried[port_name(path)].numpy(), want)
