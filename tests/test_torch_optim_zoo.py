"""Port vs reference: every optimizer and schedule name, in lockstep.

Each optimizer name takes 5 steps with ``ppt_tpu.train.optim.build_optimizer``
(through ``optax.with_extra_args_support``, as the reference's train step
calls it, with ``value=loss`` and, for ``adahessian``, ``hess=``) and with
``ppt_torch.train.optim.build_optimizer`` on the same leaves and gradients,
made from a numpy seed: shapes ``[7]``, ``[4, 5]`` and ``[128, 160]`` (the last
so that ``adafactor`` factors it). Both sides compute in f32 in the same
order. Parameters agree within 1e-6 relative, each entry measured against
the larger of itself and 1/100 of its leaf's largest entry; state slots
within 1e-6 of their leaf's largest entry (8 ulps of it). Both limits are
looser than a bare 1e-6 relative, for this reason: XLA's fused loops and
torch's vector code contract a multiply and an add into one rounding in
different places, and sum a norm or a mean in another order, so the two
sides differ by an ulp or two of the terms of a sum (measured: at most 2
ulps of the leaf's largest entry); an entry that such a sum brings close
to 0 (a parameter a step moves through 0, a moment or momentum trace whose
gradient changed sign) differs by an ulp of those terms, not of itself.
The learning rate comes from
the reference's schedule on one side and the port's on the other, each
name against its counterpart at 1e-7 absolute (rates <= 3e-3, as
``tests/test_torch_optim.py`` holds the cosine). Also: the plateau stage
with a stagnant loss, the state round trip through ``save_checkpoint`` /
``load_checkpoint``, ``adahessian`` and ``hutchinson_diag`` against the
reference's recurrence tests (``tests/test_optim_and_schedules.py:190-280``),
and the second-order route check: the reference's ``hutchinson_diag``
cannot take ``jax.jvp`` through a ``custom_vjp`` kernel, and the port
refuses a second derivative through its kernels by name.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ppt_tpu.train.optim import build_optimizer as jax_build_optimizer
from ppt_tpu.train.optim import build_schedule as jax_build_schedule
from ppt_torch.train.optim import OPTIMIZERS, SCHEDULES, build_optimizer, build_schedule

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores

SHAPES = {"bias": (7,), "small": (4, 5), "wide": (128, 160)}
OPT_KW = dict(weight_decay=0.1, betas=(0.9, 0.98), eps=1e-8)
SCHED_KW = dict(final_lr=1e-5, warmup_epochs=1, warmup_start_lr=1e-6)


def _leaves(seed=0):
    rng = np.random.RandomState(seed)
    p0 = {k: np.asarray(rng.randn(*s) * 0.5, np.float32) for k, s in SHAPES.items()}
    grads = [{k: np.asarray(rng.randn(*s) * 10 ** rng.uniform(-3, 0), np.float32)
              for k, s in SHAPES.items()} for _ in range(5)]
    hess = [{k: np.asarray(rng.randn(*s), np.float32) for k, s in SHAPES.items()}
            for _ in range(5)]
    losses = [np.float32(2.0 - 0.1 * i) for i in range(5)]
    return p0, grads, hess, losses


def _close(got, want, what, floor=0.01):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.maximum(np.abs(want), floor * np.max(np.abs(want), initial=0.0))
    err = np.abs(got - want)
    assert np.all(err <= 1e-6 * scale), (what, float(np.max(err / np.maximum(scale, 1e-38))))


def _optax_slots(state, names):
    """{field: {leaf: array}} for every NamedTuple field of the optax state
    that holds a dict over the parameter names."""
    found = {}

    def walk(node):
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            for field, value in zip(node._fields, node):
                if isinstance(value, dict) and set(value) == set(names):
                    assert field not in found, field
                    found[field] = value
                else:
                    walk(value)
        elif isinstance(node, (tuple, list)):
            for v in node:
                walk(v)

    walk(state)
    return found


def _lockstep(name, sched_name="cosine", plateau=0, losses=None):
    p0, grads, hess, default_losses = _leaves()
    losses = default_losses if losses is None else losses
    epochs, spe = 4, 2
    jsched = jax_build_schedule(sched_name, 3e-3, epochs, spe, **SCHED_KW)
    tsched = build_schedule(sched_name, 3e-3, epochs, spe, **SCHED_KW)
    jopt = optax.with_extra_args_support(jax_build_optimizer(
        name, jsched, plateau_patience_epochs=plateau, steps_per_epoch=spe,
        plateau_factor=0.1, **OPT_KW))
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    st = jopt.init(pj)
    pt = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    topt = build_optimizer(name, pt.items(), tsched, plateau_patience=plateau,
                           steps_per_epoch=spe, plateau_factor=0.1, **OPT_KW)
    for i, (g, h, loss) in enumerate(zip(grads, hess, losses)):
        extra = {"hess": {k: jnp.asarray(v) for k, v in h.items()}} if name == "adahessian" else {}
        upd, st = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, st, pj,
                              value=jnp.asarray(loss), **extra)
        pj = optax.apply_updates(pj, upd)
        textra = {"hess": {k: torch.from_numpy(v) for k, v in h.items()}} \
            if name == "adahessian" else {}
        topt.step({k: torch.from_numpy(v) for k, v in g.items()}, value=torch.tensor(loss),
                  **textra)
        assert topt.count == i + 1
        for k in SHAPES:
            _close(pt[k].numpy(), pj[k], f"{name} step {i} {k}")
    return topt, st, pt, pj


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_matches_the_reference_for_five_steps(name):
    topt, st, _, _ = _lockstep(name)
    slots = _optax_slots(st, SHAPES)
    state = topt.state_dict()
    assert set(topt.slots) == set(slots), (topt.slots, sorted(slots))
    for slot, leaves in slots.items():
        for k, v in leaves.items():
            _close(state[slot][k].numpy(), v, f"{name} {slot} {k}", floor=1.0)


@pytest.mark.parametrize("sched", [s for s in SCHEDULES if s not in ("cosine", "constant")])
def test_schedule_drives_an_optimizer_in_lockstep(sched):
    _lockstep("sgd", sched_name=sched)


@pytest.mark.parametrize("name", SCHEDULES)
@pytest.mark.parametrize("warmup_epochs", [0, 1, 3])
def test_schedule_values_match_the_reference(name, warmup_epochs):
    kw = dict(SCHED_KW, warmup_epochs=warmup_epochs)
    # milestones and the cycle length cut to the run, so every leg is reached
    for epochs, spe, extra in ((10, 7, dict(milestones=(2, 5), gamma=0.5, power=0.7)),
                               (250, 3, {})):
        try:
            want_fn = jax_build_schedule(name, 3e-3, epochs, spe, **kw, **extra)
        except ValueError as e:  # a restart cycle shorter than the warmup
            with pytest.raises(ValueError, match="cycle"):
                build_schedule(name, 3e-3, epochs, spe, **kw, **extra)
            assert "decay_steps" in str(e)
            continue
        got_fn = build_schedule(name, 3e-3, epochs, spe, **kw, **extra)
        for step in list(range(0, epochs * spe + 3)) + [10 ** 5]:
            want = float(want_fn(jnp.asarray(step, jnp.int32)))
            assert abs(got_fn(step) - want) <= 1e-7 * max(1.0, abs(want) / 3e-3), (
                name, step, got_fn(step), want)


def test_plateau_scales_the_updates_on_a_stagnant_loss():
    """A constant loss: the average stops improving after the first epoch,
    and after ``patience`` epochs without improvement the updates drop by
    the factor, as the reference's ``reduce_on_plateau`` stage does."""
    flat = [np.float32(1.0)] * 5
    topt, st, _, _ = _lockstep("adamw", sched_name="plateau", plateau=1, losses=flat)
    plateau = [s for s in jax.tree_util.tree_leaves(st, is_leaf=lambda n: hasattr(n, "best_value"))
               if hasattr(s, "best_value")][0]
    got = topt.plateau.state_dict()
    assert got["count"] == int(plateau.count)
    assert int(plateau.cooldown_count) == 0  # the reference's stage keeps no cooldown
    for k in ("scale", "best_value", "plateau_count", "avg_value"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(getattr(plateau, k)), rtol=1e-6)
    assert float(got["scale"]) == pytest.approx(0.1)  # 5 steps, 2 a epoch: one plateau
    # the logged rate is the schedule's, untouched
    assert topt.schedule(3) == pytest.approx(3e-3)


@pytest.mark.parametrize("name", ["adamw", "adafactor", "novograd", "madgrad", "adahessian",
                                  "rmsprop_tf"])
def test_state_round_trips_through_the_checkpoint(tmp_path, name):
    from ppt_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from ppt_torch.train.trainer import TrainState

    topt, _, pt, _ = _lockstep(name, sched_name="plateau", plateau=2)

    class Holder(torch.nn.Module):
        def __init__(self, leaves):
            super().__init__()
            for k, v in leaves.items():
                self.register_parameter(k, torch.nn.Parameter(v, requires_grad=False))

    state = TrainState(model=Holder(pt), optimizer=topt, generator=torch.Generator(), step=5)
    save_checkpoint(str(tmp_path), state)
    fresh_leaves = {k: torch.zeros(s) for k, s in SHAPES.items()}
    fresh = TrainState(model=Holder(fresh_leaves),
                       optimizer=build_optimizer(name, fresh_leaves.items(), lambda s: 1e-3,
                                                 plateau_patience=2, steps_per_epoch=2),
                       generator=torch.Generator())
    load_checkpoint(str(tmp_path), fresh)
    assert fresh.step == 5 and fresh.optimizer.count == 5
    want, got = topt.state_dict(), fresh.optimizer.state_dict()
    for slot in topt.slots:
        for k in SHAPES:
            assert torch.equal(got[slot][k], want[slot][k]), (slot, k)
    for k, v in want["plateau"].items():
        assert torch.equal(torch.as_tensor(got["plateau"][k]), torch.as_tensor(v)), k
    for k in SHAPES:
        assert torch.equal(fresh.trainable[k], pt[k])


class TestAdahessian:
    """The reference's own adahessian tests, run on the port."""

    def test_recurrence_matches_reference_two_steps(self):
        from ppt_torch.train.optim import AdaHessian

        lr, wd, eps = 0.1, 0.01, 1e-8
        b1, b2 = 0.9, 0.999
        p = {"p": torch.tensor([1.0, -2.0, 0.5])}
        opt = AdaHessian(p.items(), lambda s: lr, betas=(b1, b2), eps=eps, weight_decay=wd)
        gs = [np.asarray([0.1, 0.2, -0.3]), np.asarray([-0.05, 0.4, 0.2])]
        hs = [np.asarray([2.0, 0.5, 1.5]), np.asarray([1.0, 3.0, 0.25])]
        want = np.asarray([1.0, -2.0, 0.5])
        m, v = np.zeros(3), np.zeros(3)
        for t, (g, h) in enumerate(zip(gs, hs), start=1):
            want *= 1.0 - lr * wd
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * h * h
            want -= (lr / (1 - b1 ** t)) * m / (np.sqrt(v / (1 - b2 ** t)) + eps)
        for g, h in zip(gs, hs):
            opt.step({"p": torch.tensor(g, dtype=torch.float32)},
                     hess={"p": torch.tensor(h, dtype=torch.float32)})
        np.testing.assert_allclose(p["p"].numpy(), want, rtol=1e-5)

    def test_hutchinson_diag_exact_for_diagonal_hessian(self):
        from ppt_torch.train.trainer import hutchinson_diag

        w = torch.tensor([1.0, -0.5], requires_grad=True)
        b = torch.tensor([3.0], requires_grad=True)
        loss = (w ** 4).sum() + 2.0 * (b ** 2).sum()
        grads = torch.autograd.grad(loss, [w, b], create_graph=True)
        d = hutchinson_diag(grads, [w, b], torch.Generator().manual_seed(0))
        np.testing.assert_allclose(d[0].numpy(), 12.0 * np.asarray([1.0, 0.25]), rtol=1e-6)
        np.testing.assert_allclose(d[1].numpy(), [4.0], rtol=1e-6)

    def test_build_optimizer_accepts_adahessian_and_trains(self):
        from ppt_torch.train.trainer import hutchinson_diag

        w = torch.tensor([2.0, -3.0, 1.0])
        opt = build_optimizer("adahessian", {"w": w}.items(), lambda s: 0.05)
        gen = torch.Generator().manual_seed(0)
        losses = []
        for _ in range(60):
            x = w.clone().requires_grad_(True)
            loss = (x ** 2).sum() + 0.1 * (x ** 4).sum()
            (g,) = torch.autograd.grad(loss, [x], create_graph=True)
            (h,) = hutchinson_diag([g], [x], gen)
            opt.step({"w": g.detach()}, value=loss.detach(), hess={"w": h})
            losses.append(float(loss))
        assert losses[-1] < 0.1 * losses[0], losses[::10]
        assert all(a >= b for a, b in zip(losses, losses[1:])), "not monotone"


def test_unknown_names_raise_key_error():
    with pytest.raises(KeyError, match="nope"):
        build_schedule("nope", 1e-3, 2, 2)
    with pytest.raises(KeyError, match="nope"):
        build_optimizer("nope", {}.items(), lambda s: 1e-3)


# ---------------------------------------------------------------------------
# adahessian through the model: which routes have a second derivative
# ---------------------------------------------------------------------------

def test_reference_hutchinson_cannot_go_through_a_custom_vjp_kernel():
    """The finding the port's route check follows: the reference's
    ``hutchinson_diag`` (``jax.jvp`` of ``jax.grad``) raises through
    ``fused_vit_block_readout`` (the Pallas kernel interpreted, as on its
    chip behind a ``custom_vjp``) and works through its XLA twin."""
    from ppt_tpu.kernels.vitblock import _readout_twin, fused_vit_block_readout
    from ppt_tpu.train.optim import hutchinson_diag

    B, L, C, H = 2, 17, 64, 4
    rng = np.random.RandomState(0)

    def f(*s):
        return jnp.asarray(rng.randn(*s).astype(np.float32) * 0.1)

    x, pos, dp = f(B, L, C), f(B, L, C), jnp.ones((B, 2), jnp.float32)
    params = dict(ln1s=jnp.ones(C), ln1b=jnp.zeros(C), wqkv=f(C, 3 * C), wproj=f(C, C),
                  bproj=f(C), ln2s=jnp.ones(C), ln2b=jnp.zeros(C), wfc1=f(C, 4 * C),
                  bfc1=f(4 * C), wfc2=f(4 * C, C), bfc2=f(C), lnfs=jnp.ones(C),
                  lnfb=jnp.zeros(C))
    order = ("ln1s", "ln1b", "wqkv", "wproj", "bproj", "ln2s", "ln2b", "wfc1", "bfc1", "wfc2",
             "bfc2", "lnfs", "lnfb")

    def loss(fn):
        return lambda p: jnp.sum(fn(x, pos, dp, *[p[k] for k in order], H) ** 2)

    with pytest.raises(TypeError, match="custom_vjp"):
        hutchinson_diag(jax.grad(loss(fused_vit_block_readout)), params, jax.random.PRNGKey(0))
    twin = loss(lambda *a: _readout_twin(*a[:-1], heads=a[-1]))
    d = hutchinson_diag(jax.grad(twin), params, jax.random.PRNGKey(0))
    assert all(bool(jnp.all(jnp.isfinite(v))) for v in d.values())


TEXT128 = dict(width=128, layers=2, heads=4, embed_dim=128)


def _port_adahessian(head_type, depth, route, text):
    from test_torch_trainer import CLASSES, TEXT, TINY

    from ppt_torch.models.ulip import PromptArrays, build_model, trainable_mask
    from ppt_torch.nn.pointbert import PointBertConfig
    from ppt_torch.nn.text import TextConfig
    from ppt_torch.prompt.learner import build_prompt_spec
    from ppt_torch.tasks.args import TaskArgs
    from ppt_torch.train.trainer import create_train_state, make_train_step

    args = TaskArgs(num_learnable_prompt_tokens=4, class_name_position="middle")
    args.pointbert_config = PointBertConfig(depth=depth, **TINY)
    args.text_config = TextConfig(**(TEXT if text == "off" else TEXT128))
    args.point_route = route
    torch.manual_seed(0)
    model = build_model("ULIP_PointBERT", args, device="cpu", text_fused=text).model
    state = create_train_state(
        model, trainable_mask(model, head_type=head_type),
        lambda tr: build_optimizer("adahessian", tr.items(), lambda s: 1e-3, weight_decay=0.1),
        seed=1)
    prompts = PromptArrays.from_spec(
        build_prompt_spec(CLASSES, n_ctx=4, class_name_position="middle"), device="cpu")
    return state, make_train_step(0.2, second_order=True), prompts


@pytest.mark.parametrize("head_type,depth,route,text,refused", [
    (0, 2, "block", "off", None),
    (3, 12, "block", "off", "fused_vit_block_readout"),
    (3, 12, "tower", "off", "fused_vit_tower"),
    (3, 12, "plain", "off", None),
    (2, 12, "unfused", "off", "fused_mha"),
    (1, 12, "unfused", "off", None),
    (0, 2, "block", "block", "fused_text_block"),
    (0, 2, "block", "tower", "fused_text_tower_bwd"),
])
def test_adahessian_route_check(head_type, depth, route, text, refused):
    """The port's second-order route check: where a trainable leaf reaches
    the loss through a kernel the step refuses by the kernel's name (the
    reference refuses there too, above); elsewhere three steps run, the
    Hessian diagonal threaded in, and move the trainable leaves."""
    from test_torch_trainer import make_batches, torch_batch

    state, step, prompts = _port_adahessian(head_type, depth, route, text)
    before = {k: v.detach().clone() for k, v in state.trainable.items()}
    batches = [torch_batch(b) for b in make_batches(3)]
    if refused:
        with pytest.raises(NotImplementedError, match=f"^{refused}: no second derivative"):
            step(state, batches[0], prompts)
        return
    for b in batches:
        state, m = step(state, b, prompts)
        assert math.isfinite(float(m["loss"]))
    assert state.optimizer.count == 3
    assert all(bool(torch.isfinite(v).all()) for v in state.trainable.values())
    assert any(not torch.equal(v, before[k]) for k, v in state.trainable.items())


def test_adahessian_step_matches_the_reference_with_the_probes_fixed(monkeypatch):
    """Head type 0 on the default routes (the reference's MiniPointNet and
    block kernels interpreted in its frozen point tower), the probes fixed
    to ones on both sides (the draws come from other generators): the
    reference's ``jax.jvp`` of its gradient and the port's second backward
    give the same ``H 1`` (1e-4 of its largest entry: f32 second
    derivatives summed in another order), and one adahessian step the same
    loss (rel 1e-4) and prompt tokens within 1e-4 of the step's largest
    move: the first step moves a token by ``lr g / |h|``, and where ``h``
    is near 0 its error (1e-4 of the largest ``h``) is magnified by the
    division, as it is on the reference's own side."""
    import ppt_tpu.train.optim as jax_optim
    from test_torch_trainer import (CLASSES, OPT, SCHED, SMOOTHING, TEXT, TINY, jax_batch,
                                    make_batches, np_tree, port_side, torch_batch)

    from ppt_tpu.models import PromptArrays as JaxPrompts
    from ppt_tpu.models import Ulip as JaxUlip
    from ppt_tpu.models import trainable_mask as jax_mask
    from ppt_tpu.nn import PointBert as JaxPointBert
    from ppt_tpu.nn import PointBertConfig as JaxBertConfig
    from ppt_tpu.nn import TextConfig as JaxTextConfig
    from ppt_tpu.prompt import build_prompt_spec as jax_spec
    from ppt_tpu.train.trainer import _make_train_step_fn
    from ppt_tpu.train.trainer import create_train_state as jax_create
    from ppt_torch.train import trainer

    seen = {}

    def jax_ones(grad_fn, params, key, n_samples=1):
        z = jax.tree_util.tree_map(jnp.ones_like, params)
        seen["jax"] = jax.jvp(grad_fn, (params,), (z,))[1]
        return seen["jax"]

    def torch_ones(grads, params, generator, n_samples=1):
        seen["torch"] = torch.autograd.grad(grads, params,
                                            grad_outputs=[torch.ones_like(p) for p in params])
        return list(seen["torch"])

    monkeypatch.setattr(jax_optim, "hutchinson_diag", jax_ones)
    monkeypatch.setattr(trainer, "hutchinson_diag", torch_ones)
    monkeypatch.setenv("PPT_FORCE_FUSED_MINI", "1")
    monkeypatch.setenv("PPT_FUSED_BLOCK", "1")
    model = JaxUlip(point_encoder=JaxPointBert(JaxBertConfig(depth=2, **TINY)),
                    pc_feat_dims=128, n_ctx=4, text_config=JaxTextConfig(**TEXT))
    jprompts = JaxPrompts.from_spec(jax_spec(CLASSES, n_ctx=4, class_name_position="middle"))
    variables = np_tree(model.init(jax.random.PRNGKey(0), jnp.zeros((1, 128, 3)) + 0.5,
                                   jprompts))
    jopt = jax_build_optimizer("adahessian", jax_build_schedule("cosine", 3e-3, 3, 2, **SCHED),
                               **OPT)
    jstate = jax_create(jax.tree_util.tree_map(jnp.asarray, variables),
                        jax_mask(variables["params"], head_type=0), jopt, jax.random.PRNGKey(1))
    state, _, prompts = port_side(0, 2, variables)
    state.optimizer = build_optimizer("adahessian", state.trainable.items(),
                                      build_schedule("cosine", 3e-3, 3, 2, **SCHED), **OPT)

    b = make_batches(1)[0]
    jstate, jm = _make_train_step_fn(model, jopt, SMOOTHING, second_order=True)(
        jstate, jax_batch(b), jprompts)
    state, m = trainer.make_train_step(SMOOTHING, second_order=True)(state, torch_batch(b),
                                                                      prompts)
    want = float(jm["loss"])
    assert abs(float(m["loss"]) - want) <= 1e-4 * abs(want)
    hj = np.asarray(seen["jax"]["prompt_learner"]["learnable_tokens"])
    (ht,) = seen["torch"]
    assert np.max(np.abs(ht.detach().numpy() - hj)) <= 1e-4 * np.max(np.abs(hj))
    got = state.trainable["prompt_learner.learnable_tokens"].detach().numpy()
    want = np.asarray(jstate.trainable["prompt_learner"]["learnable_tokens"])
    tokens0 = np.asarray(variables["params"]["prompt_learner"]["learnable_tokens"])
    moved = np.max(np.abs(want - tokens0))
    assert moved > 0 and np.max(np.abs(got - want)) <= 1e-4 * moved


@pytest.mark.parametrize("route,kernel", [("block", "fused_vit_block"), ("plain", "mini_forward")])
def test_mpm_step_refuses_adahessian_by_the_kernel_name(tmp_path, monkeypatch, route, kernel):
    """MPM threads the Hutchinson diagonal into its step, as the
    reference's does (``tasks/mpm_pretrain.py:39-62``); the student's first
    kernel on the way back from the loss refuses the second derivative by
    name: the trunk's block kernel, or on the plain trunk route the
    MiniPointNet encoder's (the reference's kernel route refuses both)."""
    from test_torch_mpm import DVAE_KW, STUDENT_KW, set_switches

    from ppt_torch.nn.dvae import DvaeConfig
    from ppt_torch.nn.pointbert import PointBertConfig
    from ppt_torch.tasks import mpm_pretrain
    from ppt_torch.tasks.args import TaskArgs

    set_switches(monkeypatch, route)
    args = TaskArgs(dataset_name="synthetic", npoints=64, batch_size=8, epochs=1,
                    warmup_epochs=0, lr=1e-3, output_dir=str(tmp_path), device="cpu",
                    optim="adahessian")
    args.num_classes, args.samples_per_class = 2, 8
    with pytest.raises(NotImplementedError, match=f"^{kernel}: no second derivative"):
        mpm_pretrain.main(args, config=PointBertConfig(**STUDENT_KW),
                          dvae_config=DvaeConfig(**DVAE_KW))
