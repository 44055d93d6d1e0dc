"""Port vs reference: learning-rate schedules and AdamW.

Schedules: the port evaluates the reference's f32 expressions in numpy,
so values agree to 1e-7 absolute (rates are <= 3e-3; the slack is for the
cosine's last bit). AdamW: 5 steps against ``optax.adamw`` with the same
schedule, gradients from a numpy seed, 1e-6 absolute on parameters of
order 1 (f32 on both sides; the bias corrections are f64 on the host in
the port and f32 in optax).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ppt_tpu.train.optim import build_schedule as jax_build_schedule
from ppt_torch.train.optim import AdamW, build_optimizer, build_schedule

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores

KW = dict(final_lr=1e-5, warmup_epochs=1, warmup_start_lr=1e-6)


@pytest.mark.parametrize("name", ["cosine", "constant"])
@pytest.mark.parametrize("warmup_epochs", [0, 1, 3])
def test_schedule_values_match_reference(name, warmup_epochs):
    kw = dict(KW, warmup_epochs=warmup_epochs)
    epochs, spe = 10, 7
    want_fn = jax_build_schedule(name, 3e-3, epochs, spe, **kw)
    got_fn = build_schedule(name, 3e-3, epochs, spe, **kw)
    for step in list(range(0, epochs * spe + 3)) + [1000]:
        want = float(want_fn(jnp.asarray(step)))
        assert abs(got_fn(step) - want) <= 1e-7, (step, got_fn(step), want)


def test_schedule_reads_published_recipe_endpoints():
    sched = build_schedule("cosine", 3e-3, 250, 328, **KW)
    assert abs(sched(0) - 1e-6) <= 1e-9
    assert abs(sched(328) - 3e-3) <= 1e-9
    assert abs(sched(250 * 328) - 1e-5) <= 1e-9


def test_adamw_matches_optax_for_five_steps():
    rng = np.random.RandomState(0)
    shapes = {"tokens": (4, 16), "scale": ()}
    p0 = {k: np.asarray(rng.randn(*s), np.float32) for k, s in shapes.items()}
    grads = [{k: np.asarray(rng.randn(*s) * 10 ** rng.uniform(-4, 0), np.float32)
              for k, s in shapes.items()} for _ in range(5)]
    sched_j = jax_build_schedule("cosine", 3e-3, 3, 2, **KW)
    opt = optax.adamw(sched_j, b1=0.9, b2=0.98, eps=1e-8, weight_decay=0.1)
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    st = opt.init(pj)

    pt = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    topt = build_optimizer("adamw", pt.items(), build_schedule("cosine", 3e-3, 3, 2, **KW),
                           weight_decay=0.1, betas=(0.9, 0.98), eps=1e-8)
    assert isinstance(topt, AdamW)
    for i, g in enumerate(grads):
        upd, st = opt.update({k: jnp.asarray(v) for k, v in g.items()}, st, pj)
        pj = optax.apply_updates(pj, upd)
        topt.step({k: torch.from_numpy(v) for k, v in g.items()})
        assert topt.count == i + 1
        for k in shapes:
            np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(topt.mu["tokens"].numpy(), np.asarray(st[0].mu["tokens"]),
                               atol=1e-7)
    np.testing.assert_allclose(topt.nu["tokens"].numpy(), np.asarray(st[0].nu["tokens"]),
                               atol=1e-7)


def test_adamw_decays_every_leaf_and_reads_lr_before_the_increment():
    p = {"w": torch.ones(3)}
    seen = []

    def sched(step):
        seen.append(step)
        return 0.5

    opt = AdamW(p.items(), sched, weight_decay=0.1, betas=(0.9, 0.98), eps=1e-8)
    opt.step({"w": torch.zeros(3)})
    # zero gradient: only the decoupled decay moves the leaf, p -= lr * wd * p
    np.testing.assert_allclose(p["w"].numpy(), np.full(3, 1 - 0.5 * 0.1), rtol=1e-7)
    opt.step({"w": torch.zeros(3)})
    assert seen == [0, 1]


@pytest.mark.parametrize("name", ["multistep", "poly", "tanh", "plateau", "cosine_restarts"])
def test_unported_schedules_raise_by_name(name):
    """Ported since this case was a refusal: the schedule now gives the
    reference's value at every step, warmup and the step past the end
    included (1e-7 absolute, as above)."""
    kw = dict(KW, warmup_epochs=1)
    want_fn = jax_build_schedule(name, 3e-3, 6, 4, **kw, milestones=(2, 4))
    got_fn = build_schedule(name, 3e-3, 6, 4, **kw, milestones=(2, 4))
    for step in range(0, 6 * 4 + 3):
        assert abs(got_fn(step) - float(want_fn(jnp.asarray(step)))) <= 1e-7, (name, step)


@pytest.mark.parametrize("name", ["adam", "sgd", "lamb", "adahessian", "madgrad"])
def test_unported_optimizers_raise_by_name(name):
    """Ported since this case was a refusal: three steps of the optimizer
    against the reference's on the same gradients (and, for adahessian, the
    same Hessian diagonal), 1e-6 absolute on parameters of order 1."""
    from ppt_tpu.train.optim import build_optimizer as jax_build_optimizer

    rng = np.random.RandomState(2)
    shapes = {"tokens": (4, 16), "scale": ()}
    p0 = {k: np.asarray(rng.randn(*s), np.float32) for k, s in shapes.items()}
    sched = dict(KW, warmup_epochs=0)
    jopt = optax.with_extra_args_support(jax_build_optimizer(
        name, jax_build_schedule("cosine", 3e-3, 3, 2, **sched), weight_decay=0.1))
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    st = jopt.init(pj)
    pt = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    topt = build_optimizer(name, pt.items(), build_schedule("cosine", 3e-3, 3, 2, **sched),
                           weight_decay=0.1)
    for _ in range(3):
        g = {k: np.asarray(rng.randn(*s) * 0.1, np.float32) for k, s in shapes.items()}
        h = {k: np.asarray(rng.rand(*s) + 0.5, np.float32) for k, s in shapes.items()}
        extra = dict(hess={k: jnp.asarray(v) for k, v in h.items()}) if name == "adahessian" \
            else {}
        upd, st = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, st, pj,
                              value=jnp.asarray(1.0), **extra)
        pj = optax.apply_updates(pj, upd)
        topt.step({k: torch.from_numpy(v) for k, v in g.items()},
                  hess={k: torch.from_numpy(v) for k, v in h.items()})
    for k in shapes:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), atol=1e-6, rtol=0)


def test_unknown_names_raise_key_error():
    with pytest.raises(KeyError):
        build_schedule("nope", 1e-3, 2, 2)
    with pytest.raises(KeyError):
        build_optimizer("nope", {}.items(), lambda s: 1e-3)


@pytest.mark.parametrize("clip", [0.05, 1.0, 100.0], ids=["clips", "clips_some", "never"])
def test_grad_norm_clip_matches_the_reference_optimizer(clip):
    """``--grad_norm_clip``: the reference's ``build_optimizer(...,
    grad_norm_clip=c)`` chains ``optax.clip_by_global_norm(c)`` ahead of
    AdamW (``train/optim.py:394-400``); five steps of gradients whose global
    norm falls from ~2 to ~0.02 cross the clip at 1.0, so both branches of
    the select run. 1e-6 absolute, as above."""
    from ppt_tpu.train.optim import build_optimizer as jax_build_optimizer

    from ppt_torch.train.optim import clip_by_global_norm

    rng = np.random.RandomState(1)
    shapes = {"tokens": (4, 16), "scale": ()}
    p0 = {k: np.asarray(rng.randn(*s), np.float32) for k, s in shapes.items()}
    grads = [{k: np.asarray(rng.randn(*s) * 0.25 / 3 ** i, np.float32) for k, s in shapes.items()}
             for i in range(5)]
    sched = dict(final_lr=1e-5, warmup_epochs=0, warmup_start_lr=1e-6)
    opt = jax_build_optimizer("adamw", jax_build_schedule("cosine", 3e-3, 3, 2, **sched),
                              weight_decay=0.1, betas=(0.9, 0.98), eps=1e-8, grad_norm_clip=clip)
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    st = opt.init(pj)
    pt = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    topt = build_optimizer("adamw", pt.items(), build_schedule("cosine", 3e-3, 3, 2, **sched),
                           weight_decay=0.1, betas=(0.9, 0.98), eps=1e-8, grad_norm_clip=clip)
    for g in grads:
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        norm = float(np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in g.values())))
        clipped = clip_by_global_norm(tg, clip)
        for k in g:
            want = g[k] if norm < clip else g[k] / norm * clip
            np.testing.assert_allclose(clipped[k].numpy(), want, rtol=1e-6, atol=1e-9)
        upd, st = opt.update({k: jnp.asarray(v) for k, v in g.items()}, st, pj)
        pj = optax.apply_updates(pj, upd)
        topt.step(tg)
    for k in shapes:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), atol=1e-6)


def test_grad_norm_clip_flag_reaches_the_optimizer():
    from ppt_torch.tasks.args import parse_args

    assert parse_args([]).grad_norm_clip == 0.0
    assert parse_args(["--grad_norm_clip", "1.5"]).grad_norm_clip == 1.5
