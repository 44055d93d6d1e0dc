"""Port vs reference: the five ULIP entries of this slice through the port's
entry points (``ULIP_PointNet``, ``ULIP_PointNet_STN``, ``ULIP_DGCNN``,
``ULIP_PCT``, ``ULIP_CurveNet``).

- the registry holds every entry of ``ppt_tpu/models/ulip.py:274-286``;
- each factory through ``cls.setup``: one ``--evaluate_3d`` batch of the
  cached-text eval step against the reference's ``make_cached_text_eval``
  on the JAX ``Ulip``, same weights (the reference's init, BatchNorm made
  non-trivial, carried across by ``convert.from_jax``), logits within 1e-4
  of their scale (f32 on both sides, other summation order); CurveNet at
  ``tests/test_curvenet.py``'s tiny config with the reference's eval draws
  from ``PRNGKey(0)`` passed in;
- one head-type-0 step of the four that train, in lockstep with the
  reference's (``jax.value_and_grad`` of its composite in training mode,
  both dropouts the identity): the loss within 1e-4 relative, the prompt's
  gradient within 1e-3 of its scale, the frozen tower's running statistics
  within 1e-5 (plus a share of the batch statistic for the T-Net encoder
  and PCT: ``BATCH_REL``), on 32 clouds (a training-mode BatchNorm over few
  rows magnifies rounding);
- ``ULIP_CurveNet``'s train step refuses by name, as the reference's fails
  for its missing ``gumbel`` stream;
- ``cls.main --evaluate_3d`` serves each on the CPU; the FPS wrapper's
  launches a batch (0 / 0 / 0 / 2 / 3) and shapes at full width; the
  trainable partition of head types 1-3; ``--use_height``;
- ``ppt_torch.nn`` exports each name of its ``__all__`` from the module
  that defines it, and every name the reference's ``ppt_tpu.nn`` exports
  from a module the port has.

The clouds of the lockstep step lie on a 1/64 lattice, so that the
coordinate kNN and ball queries pick alike in both packages.
"""

import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import struct

from test_torch_classic import no_dropout, stats_close_batch  # noqa: F401 (a fixture)
from test_torch_curvenet import TINY as CURVE_TINY
from test_torch_curvenet import jax_config, jax_uniforms
from test_torch_pointnet2 import close, lattice_cloud, np_tree, randomise_bn
from test_torch_trainer import CLASSES, EPOCHS, OPT, SCHED, SMOOTHING, STEPS_PER_EPOCH, TEXT
from test_torch_trainer import torch_batch

import ppt_torch.nn
import ppt_tpu.nn
from ppt_torch.convert import from_jax
from ppt_torch.kernels import group as kgroup
from ppt_torch.models.losses import smoothed_cross_entropy
from ppt_torch.models.ulip import MODEL_REGISTRY, PromptArrays, build_model, trainable_mask
from ppt_torch.nn import curvenet as tcv
from ppt_torch.nn.text import TextConfig
from ppt_torch.prompt.learner import build_prompt_spec
from ppt_torch.tasks import cls
from ppt_torch.tasks.args import TaskArgs
from ppt_torch.train.eval import make_cached_text_eval
from ppt_torch.train.optim import build_optimizer, build_schedule
from ppt_torch.train.trainer import create_train_state, make_train_step

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores

NEW = ("ULIP_PointNet", "ULIP_PointNet_STN", "ULIP_DGCNN", "ULIP_PCT", "ULIP_CurveNet")
FEAT_DIMS = {"ULIP_PointNet": 256, "ULIP_PointNet_STN": 1024, "ULIP_DGCNN": 256,
             "ULIP_PCT": 256, "ULIP_CurveNet": 256}
# the cloud sizes: PCT's FPS stages keep 512 and 256 points, CurveNet's tiny
# config starts at 128
NPOINTS = {"ULIP_PointNet": 128, "ULIP_PointNet_STN": 128, "ULIP_DGCNN": 64,
           "ULIP_PCT": 600, "ULIP_CurveNet": 128}
# the running statistics' allowance beyond 1e-5, in units of the batch
# statistic (``test_torch_classic.stats_close_batch``): the T-Net encoder's
# bn1 (``test_torch_classic.py``); PCT's head bn6, whose batch variance moves
# by 0.17% of itself between the packages (1.67e-5 on its running variance
# at a batch variance of 1.0, measured; 1.96e-5 at 3.56 over 64 clouds): the
# training-mode trunk below it (offset attention renormalised by column,
# fourteen BatchNorms over the batch) magnifies the other summation order
BATCH_REL = {"ULIP_PointNet_STN": 1e-6, "ULIP_PCT": 1e-5}
FPS_SHAPES = {"ULIP_PointNet": [], "ULIP_PointNet_STN": [], "ULIP_DGCNN": [],
              "ULIP_PCT": [(1024, 512), (512, 256)],
              "ULIP_CurveNet": [(1024, 256), (256, 64), (64, 16)]}


@struct.dataclass
class _State:
    trainable: dict
    frozen: dict
    batch_stats: dict


def tiny_args(name, **kw):
    args = TaskArgs(num_learnable_prompt_tokens=4, class_name_position="middle", model=name,
                    **kw)
    args.text_config = TextConfig(**TEXT)
    if name == "ULIP_CurveNet":
        args.curvenet_config = CURVE_TINY
    return args


def jax_model(name):
    """The reference's ``Ulip`` for ``name``: its own factory at full
    width, CurveNet at the tiny config."""
    from ppt_tpu.models import Ulip as JaxUlip
    from ppt_tpu.models import build_model as jax_build
    from ppt_tpu.nn import TextConfig as JaxTextConfig
    from ppt_tpu.nn.curvenet import CurveNet as JaxCurveNet

    if name == "ULIP_CurveNet":
        return JaxUlip(point_encoder=JaxCurveNet(jax_config(CURVE_TINY)), pc_feat_dims=256,
                       n_ctx=4, text_config=JaxTextConfig(**TEXT))
    jargs = TaskArgs(num_learnable_prompt_tokens=4)
    jargs.text_config = JaxTextConfig(**TEXT)
    return jax_build(name, jargs).model


def jax_variables(jmodel, pc, prompts, seed):
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(pc[:1]), prompts)
    params, stats = np_tree(variables["params"]), np_tree(variables["batch_stats"])
    randomise_bn(params["point_encoder"], stats["point_encoder"], np.random.RandomState(seed))
    return params, stats


@pytest.fixture
def curve_eval_draws(monkeypatch):
    """The port's eval draws replaced by the reference's from
    ``PRNGKey(0)``, as its every curve stage draws them."""
    monkeypatch.setattr(tcv, "eval_uniforms", lambda shape, device: torch.from_numpy(
        jax_uniforms(jax.random.PRNGKey(0), shape[0], shape[1:])).to(device))


def test_registry_holds_every_reference_entry():
    from ppt_tpu.models.ulip import MODEL_REGISTRY as JAX_REGISTRY

    assert set(MODEL_REGISTRY) == set(JAX_REGISTRY)
    assert len(MODEL_REGISTRY) == 11


@pytest.mark.parametrize("name", NEW)
def test_evaluate_3d_batch_through_setup_matches_the_reference(name, curve_eval_draws):
    from ppt_tpu.models import PromptArrays as JaxPrompts
    from ppt_tpu.prompt import build_prompt_spec as jax_spec
    from ppt_tpu.train.trainer import make_cached_text_eval as jax_cached_eval

    args = tiny_args(name, dataset_name="synthetic", npoints=NPOINTS[name], batch_size=4,
                     evaluate_3d=True, device="cpu", pretrained_dir="")
    args.num_classes, args.samples_per_class = 5, 2
    ctx = cls.setup(args)
    model, names = ctx["model"], ctx["classnames"]
    pc = np.asarray(ctx["test_ds"].points[:4], np.float32)

    jmodel = jax_model(name)
    jprompts = JaxPrompts.from_spec(jax_spec(names, n_ctx=4, class_name_position="middle"))
    params, stats = jax_variables(jmodel, pc, jprompts, 1)
    embed_fn, step_fn = jax_cached_eval(jmodel)
    state = _State(trainable=params, frozen={}, batch_stats=stats)
    want = np.asarray(step_fn(state, {"pc": jnp.asarray(pc)}, embed_fn(state, jprompts)))

    model.load_state_dict(from_jax(params, stats, model))
    embed, step = make_cached_text_eval(model)
    got = step(model, {"pc": torch.from_numpy(pc)}, embed(model, ctx["prompts"]))
    assert got.shape == (4, len(names))
    close(got.numpy(), want, 1e-4)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), want.argmax(-1))


@pytest.mark.parametrize("name", NEW[:4])
def test_prompt_step_matches_the_reference(name, no_dropout):
    """One head-type-0 step: the loss and the prompt's gradient of the
    training-mode forward (``jax.value_and_grad`` of the reference's
    composite against the port's trainer step and autograd), and the frozen
    tower's BatchNorm buffers after the step."""
    from ppt_tpu.models import PromptArrays as JaxPrompts
    from ppt_tpu.models.losses import smoothed_cross_entropy as jax_ce
    from ppt_tpu.prompt import build_prompt_spec as jax_spec

    from test_torch_trainer import flat, port_name

    jmodel = jax_model(name)
    jprompts = JaxPrompts.from_spec(jax_spec(CLASSES, n_ctx=4, class_name_position="middle"))
    npoints = NPOINTS[name]
    rng = np.random.RandomState(7)
    b = {"pc": lattice_cloud(32, npoints, 8),
         "label": rng.randint(0, len(CLASSES), 32).astype(np.int32)}
    params, stats = jax_variables(jmodel, b["pc"], jprompts, 2)

    def jloss(tokens):
        p = dict(params, prompt_learner={"learnable_tokens": tokens})
        logits, mutated = jmodel.apply({"params": p, "batch_stats": stats}, jnp.asarray(b["pc"]),
                                       jprompts, train=True, mutable=["batch_stats"])
        return jax_ce(logits, jnp.asarray(b["label"]), SMOOTHING), mutated["batch_stats"]

    tokens0 = params["prompt_learner"]["learnable_tokens"]
    (want_loss, want_stats), want_grad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(tokens0))
    want_loss = float(want_loss)

    model = build_model(name, tiny_args(name), device="cpu").model
    model.load_state_dict(from_jax(params, stats, model))
    prompts = PromptArrays.from_spec(
        build_prompt_spec(CLASSES, n_ctx=4, class_name_position="middle"), device="cpu")
    tokens = model.prompt_learner.learnable_tokens
    buffers0 = {k: v.clone() for k, v in model.named_buffers()}
    loss = smoothed_cross_entropy(model(torch.from_numpy(b["pc"]), prompts, train=True),
                                  torch.from_numpy(b["label"]).long(), SMOOTHING)
    grad, = torch.autograd.grad(loss, [tokens])
    assert abs(float(loss.detach()) - want_loss) <= 1e-4 * abs(want_loss)
    close(grad.numpy(), np.asarray(want_grad), 1e-3)
    with torch.no_grad():
        for k, v in model.named_buffers():
            v.copy_(buffers0[k])

    sched = build_schedule("cosine", 3e-3, EPOCHS, STEPS_PER_EPOCH, **SCHED)
    state = create_train_state(model, trainable_mask(model, head_type=0),
                               lambda tr: build_optimizer("adamw", tr.items(), sched, **OPT),
                               seed=1)
    frozen0 = {k: v.detach().clone() for k, v in model.named_parameters()
               if k not in state.trainable}
    state, m = make_train_step(smoothing=SMOOTHING)(state, torch_batch(b), prompts)
    assert abs(float(m["loss"]) - want_loss) <= 1e-4 * abs(want_loss)
    assert not torch.equal(state.trainable["prompt_learner.learnable_tokens"],
                           torch.tensor(np.asarray(tokens0)))
    assert all(torch.equal(v, frozen0[k]) for k, v in model.named_parameters() if k in frozen0)
    stats_close_batch(model.point_encoder, np_tree(want_stats)["point_encoder"],
                      stats["point_encoder"], batch_rel=BATCH_REL.get(name, 0.0))
    buffers = dict(model.named_buffers())
    assert all(port_name(p) in buffers for p in flat(np_tree(want_stats)))


def test_curvenet_train_step_refuses_by_name():
    """The reference's train step passes the rngs ``dropout`` and
    ``droppath`` only, and its CurveNet asks for ``gumbel``
    (``InvalidRngError``); the port's step refuses by name, before any
    leaf moves."""
    model = build_model("ULIP_CurveNet", tiny_args("ULIP_CurveNet"), device="cpu").model
    prompts = PromptArrays.from_spec(
        build_prompt_spec(CLASSES, n_ctx=4, class_name_position="middle"), device="cpu")
    sched = build_schedule("cosine", 3e-3, EPOCHS, STEPS_PER_EPOCH, **SCHED)
    state = create_train_state(model, trainable_mask(model, head_type=0),
                               lambda tr: build_optimizer("adamw", tr.items(), sched, **OPT),
                               seed=1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    b = {"pc": lattice_cloud(4, 128, 1), "label": np.zeros(4, np.int32)}
    with pytest.raises(ValueError, match="ULIP_CurveNet.*'gumbel'"):
        make_train_step(smoothing=SMOOTHING)(state, torch_batch(b), prompts)
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


def test_curvenet_train_driver_refuses_by_name(tmp_path):
    args = tiny_args("ULIP_CurveNet", dataset_name="synthetic", npoints=128, batch_size=4,
                     epochs=1, device="cpu", pretrained_dir="", output_dir=str(tmp_path))
    args.num_classes, args.samples_per_class = 3, 2
    with pytest.raises(ValueError, match="ULIP_CurveNet.*'gumbel'"):
        cls.main(args)


@pytest.mark.parametrize("name", NEW)
def test_cls_main_evaluate_3d_serves_each_entry(name, tmp_path):
    args = tiny_args(name, dataset_name="synthetic", npoints=NPOINTS[name], batch_size=4,
                     evaluate_3d=True, device="cpu", pretrained_dir="",
                     output_dir=str(tmp_path))
    args.num_classes, args.samples_per_class = 3, 2  # 6 clouds: one full batch, one padded
    result = cls.main(args)
    assert 0.0 <= result["best_acc"] <= 100.0 and result["best_epoch"] == -1


@pytest.mark.parametrize("name", NEW)
def test_fps_launches_a_batch_at_full_width(name, monkeypatch):
    """The FPS wrapper at the default configs, one eval batch of 2 clouds
    of 1024 points: PointNet, its T-Net encoder and DGCNN run none, PCT two
    (1024 -> 512 -> 256), CurveNet three (1024 -> 256 -> 64 -> 16)."""
    calls = []
    real = kgroup.fps_batched
    monkeypatch.setattr(kgroup, "fps_batched",
                        lambda p, n: calls.append((p.shape[1], n)) or real(p, n))
    args = TaskArgs(num_learnable_prompt_tokens=4, class_name_position="middle", model=name)
    args.text_config = TextConfig(**TEXT)
    spec = build_model(name, args, device="cpu")
    assert spec.pc_feat_dims == FEAT_DIMS[name] and spec.name == name
    with torch.no_grad():
        feat = spec.model.encode_pc(torch.from_numpy(lattice_cloud(2, 1024, 3)))
    assert feat.shape == (2, 64) and torch.isfinite(feat).all()
    assert calls == FPS_SHAPES[name]


@pytest.mark.parametrize("head_type", [1, 2, 3])
@pytest.mark.parametrize("name", NEW)
def test_head_types_train_only_the_prompt(name, head_type):
    """``_HEAD_TYPE_UNFREEZE`` names PointBERT's ``block_11``, which these
    towers lack: only the prompt trains, as in the reference."""
    model = build_model(name, tiny_args(name), device="cpu").model
    mask = trainable_mask(model, head_type=head_type)
    assert [k for k, v in mask.items() if v] == ["prompt_learner.learnable_tokens"]


@pytest.mark.parametrize("name", ["ULIP_PCT", "ULIP_CurveNet"])
def test_use_height_is_refused_by_the_fps_towers(name):
    with pytest.raises(NotImplementedError, match=f"{name} takes xyz"):
        build_model(name, tiny_args(name, use_height=True), device="cpu")


@pytest.mark.parametrize("name", NEW[:3])
def test_use_height_widens_the_first_layer(name):
    """The reference infers a 4-wide first layer from the 4-channel input;
    so does the port's factory for the towers without an FPS kernel."""
    model = build_model(name, tiny_args(name, use_height=True), device="cpu").model
    first = {"ULIP_PointNet": "conv0", "ULIP_PointNet_STN": "conv0_1", "ULIP_DGCNN": "edge0"}[name]
    width = getattr(model.point_encoder, first).kernel.shape[0]
    assert width == (8 if name == "ULIP_DGCNN" else 4)
    with torch.no_grad():
        feat = model.encode_pc(torch.from_numpy(lattice_cloud(2, 64, 4, channels=4)))
    assert torch.isfinite(feat).all()


@pytest.mark.parametrize("name", ppt_torch.nn.__all__)
def test_nn_exports_resolve(name):
    """Each exported name is the object its defining module holds."""
    obj = getattr(ppt_torch.nn, name)
    module = importlib.import_module(obj.__module__)
    assert obj.__module__.startswith("ppt_torch.nn.") and getattr(module, name) is obj


# The reference's layer modules that the port keeps as functions of
# ``nn/layers.py`` (``quick_gelu``, ``drop_path``), not as modules.
FUNCTIONS_IN_THE_PORT = {"QuickGELU", "DropPath"}


def test_nn_exports_cover_the_reference():
    """Every name ``ppt_tpu.nn`` exports from a module the port has ported
    is exported by ``ppt_torch.nn`` too; an unknown name is refused."""
    ported = {m.rsplit(".", 1)[-1] for m in (getattr(ppt_tpu.nn, n).__module__
                                              for n in ppt_tpu.nn.__all__)
              if importlib.util.find_spec(f"ppt_torch.nn.{m.rsplit('.', 1)[-1]}")}
    want = {n for n in ppt_tpu.nn.__all__
            if getattr(ppt_tpu.nn, n).__module__.rsplit(".", 1)[-1] in ported}
    assert "classic" in ported and "simpleview" in ported
    assert want - FUNCTIONS_IN_THE_PORT <= set(ppt_torch.nn.__all__)
    with pytest.raises(AttributeError, match="NoSuchTower"):
        ppt_torch.nn.NoSuchTower
