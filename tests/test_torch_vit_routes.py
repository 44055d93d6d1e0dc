"""Port vs reference: PointBERT's trunk routes and its length guard.

- ``vit_tower_plain`` (what ``fused_vit_tower`` runs on CPU tensors and
  what its CUDA entry point is held to on the card) against the
  reference's ``_vit_tower_pallas`` in interpret mode, with one zeroed
  droppath entry, and its gradient against ``_vit_tower_twin``'s;
- ``PointBert`` on each route against the flax ``PointBert`` under the
  reference's switches for that route (``block``: ``PPT_FUSED_BLOCK=1``,
  interpreted kernels; ``tower``: also ``PPT_FUSED_VIT_TOWER=1``;
  ``unfused``: ``PPT_FUSED_BLOCK=0``; ``plain``: ``PPT_FORCE_XLA_ATTN=1``),
  and the last block's head_type-3 gradients per route. The reference runs
  ``fused_mha`` only on a TPU; on the CPU its unfused route takes
  ``jax.nn.dot_product_attention`` in f32, which agrees with the port's
  ``fused_mha`` to ~1e-6, so that route is held in f32 only;
- the long-sequence trunk (1024 groups, L = 1025) against flax: every route
  takes the unfused block with ``flash_mha``, which the wrapper counts show;
- the switches' precedence, and ``ulip_customized``'s logits.

Tolerances, relative to the reference output's max magnitude (at least
1): f32 1e-5 (summation order only); bf16 3e-2 (the same rounding points
on both sides, compounded over two blocks); gradients f32 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import struct

from ppt_torch.convert import from_jax
from ppt_torch.kernels import attention as kattn
from ppt_torch.kernels.vitblock import fused_vit_tower
from ppt_torch.models.ulip import PromptArrays, init_weights, ulip_customized
from ppt_torch.nn import pointbert as npb
from ppt_torch.nn.pointbert import PointBert, PointBertConfig
from ppt_torch.nn.text import TextConfig
from ppt_torch.prompt.learner import build_prompt_spec
from ppt_torch.tasks import cls
from ppt_torch.tasks.args import TaskArgs
from ppt_torch.train.eval import make_cached_text_eval

SMALL = dict(trans_dim=64, depth=2, drop_path_rate=0.0, num_heads=2, group_size=8,
             num_group=16, encoder_dims=64)
LONG = dict(trans_dim=48, depth=2, drop_path_rate=0.0, num_heads=6, group_size=8,
            num_group=1024, encoder_dims=64)
SWITCHES = ("PPT_FORCE_XLA_ATTN", "PPT_FUSED_BLOCK", "PPT_FUSED_VIT_TOWER")
# the reference's switches for each route, as a user's shell sets them
ROUTE_ENV = {"block": {"PPT_FUSED_BLOCK": "1"},
             "tower": {"PPT_FUSED_BLOCK": "1", "PPT_FUSED_VIT_TOWER": "1"},
             "unfused": {"PPT_FUSED_BLOCK": "0"},
             "plain": {"PPT_FORCE_XLA_ATTN": "1"}}
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.max(np.abs(want))), 1.0)
    assert np.max(np.abs(got - want)) <= tol * scale, np.max(np.abs(got - want)) / scale


def _set_switches(monkeypatch, env):
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


# ---------------------------------------------------------------------------
# fused_vit_tower
# ---------------------------------------------------------------------------

C, H, DEPTH, L = 128, 4, 3, 69


def _tower_args(rng):
    f = lambda *s: (rng.randn(*s) * 0.05).astype(np.float32)  # noqa: E731
    dp = np.ones((2, DEPTH, 2), np.float32)
    dp[1, 1, 0] = 0.0
    return [f(2, L, C), f(2, L, C), dp, 1.0 + 0.1 * f(DEPTH, C), f(DEPTH, C),
            f(DEPTH, C, 3 * C), f(DEPTH, C, C), f(DEPTH, C), 1.0 + 0.1 * f(DEPTH, C),
            f(DEPTH, C), f(DEPTH, C, 4 * C), f(DEPTH, 4 * C), f(DEPTH, 4 * C, C), f(DEPTH, C),
            1.0 + 0.1 * f(C), 0.1 * f(C)]


@pytest.fixture
def one_torch_thread():
    """torch's CPU kernels on one thread for the test, the count restored
    after: no GEMM blocking may follow the worker's thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_vit_tower_plain_matches_pallas(one_torch_thread, record_property):
    from ppt_tpu.kernels.vitblock import _vit_tower_pallas

    args = _tower_args(np.random.RandomState(0))
    want = _vit_tower_pallas(*map(jnp.asarray, args), heads=H, interpret=True)
    got = fused_vit_tower(*map(torch.from_numpy, args), H)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 8, C)
    record_property("max_abs_err", float(np.abs(got.numpy() - np.asarray(want)).max()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    assert torch.all(got[:, 2:] == 0)


def test_vit_tower_grad_matches_twin():
    from ppt_tpu.kernels.vitblock import _vit_tower_twin

    rng = np.random.RandomState(1)
    args = _tower_args(rng)
    cot = rng.randn(2, 8, C).astype(np.float32)
    diff = (0, 5, 6, 7, 11)  # x, wqkv, wproj, bproj, bfc1
    want = jax.jit(jax.grad(lambda *a: jnp.sum(_vit_tower_twin(*a, heads=H) * cot),
                            argnums=diff))(*map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_(i in diff) for i, a in enumerate(args)]
    (fused_vit_tower(*ts, H) * torch.from_numpy(cot)).sum().backward()
    for i, w in zip(diff, want):
        _close(ts[i].grad.numpy(), w, 1e-5)


# ---------------------------------------------------------------------------
# PointBert by route
# ---------------------------------------------------------------------------


def _jax_pointbert(cfg_kw, pts, rng):
    """The flax PointBert's config and its f32 parameters (BatchNorm state
    randomised), initialised at 16 groups: no parameter depends on the
    group count."""
    from ppt_tpu.nn import PointBert as JaxPointBert
    from ppt_tpu.nn import PointBertConfig as JaxConfig

    small = JaxConfig(**dict(cfg_kw, num_group=16))
    variables = JaxPointBert(small).init(jax.random.PRNGKey(0), jnp.asarray(pts[:1, :64]))
    jcfg = JaxConfig(**cfg_kw)
    params = jax.tree_util.tree_map(np.array, variables["params"])
    stats = jax.tree_util.tree_map(np.array, variables["batch_stats"])
    for bn in ("bn1", "bn2"):
        n = params["encoder"][bn]["scale"].shape[0]
        params["encoder"][bn] = {"scale": (1 + 0.1 * rng.randn(n)).astype(np.float32),
                                 "bias": (0.1 * rng.randn(n)).astype(np.float32)}
        stats["encoder"][bn] = {"mean": (0.1 * rng.randn(n)).astype(np.float32),
                                "var": (0.5 + rng.rand(n)).astype(np.float32)}
    return jcfg, params, stats


def _port(cfg_kw, params, stats, tdt, route):
    model = PointBert(PointBertConfig(**cfg_kw), dtype=tdt, route=route)
    model.load_state_dict(from_jax(params, stats, model))
    return model


@pytest.mark.parametrize("route,dtype", [
    ("block", "float32"), ("block", "bfloat16"), ("tower", "float32"), ("tower", "bfloat16"),
    ("unfused", "float32"), ("plain", "float32"), ("plain", "bfloat16")])
def test_pointbert_route_matches_flax(route, dtype, monkeypatch):
    from ppt_tpu.nn import PointBert as JaxPointBert

    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.RandomState(2)
    pts = rng.rand(2, 64, 3).astype(np.float32)
    jcfg, params, stats = _jax_pointbert(SMALL, pts, rng)
    monkeypatch.setenv("PPT_FORCE_FUSED_MINI", "1")
    _set_switches(monkeypatch, ROUTE_ENV[route])
    want = JaxPointBert(jcfg, dtype=jdt).apply({"params": params, "batch_stats": stats},
                                               jnp.asarray(pts))
    assert cls.point_route_from_env() == route
    with torch.no_grad():
        got = _port(SMALL, params, stats, tdt, route)(torch.from_numpy(pts))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 2 * SMALL["trans_dim"])
    _close(got.numpy(), want, tol)


@pytest.mark.parametrize("route", sorted(ROUTE_ENV))
def test_last_block_head_type3_grads_match_flax(route, monkeypatch):
    """The leaves head_type 3 trains in the last block (``block_11`` at full
    depth): their gradients follow each route's gradient source."""
    from ppt_tpu.nn import PointBert as JaxPointBert

    rng = np.random.RandomState(3)
    pts = rng.rand(2, 64, 3).astype(np.float32)
    jcfg, params, stats = _jax_pointbert(SMALL, pts, rng)
    cot = rng.randn(2, 2 * SMALL["trans_dim"]).astype(np.float32)
    last = f"block_{SMALL['depth'] - 1}"
    monkeypatch.setenv("PPT_FORCE_FUSED_MINI", "1")
    _set_switches(monkeypatch, ROUTE_ENV[route])
    jmodel = JaxPointBert(jcfg)

    def loss(attn):
        p = dict(params, **{last: dict(params[last], attn=attn)})
        out = jmodel.apply({"params": p, "batch_stats": stats}, jnp.asarray(pts))
        return jnp.sum(out * cot)

    want = jax.grad(loss)(params[last]["attn"])
    model = _port(SMALL, params, stats, torch.float32, route)
    (model(torch.from_numpy(pts)) * torch.from_numpy(cot)).sum().backward()
    attn = getattr(model, last).attn
    _close(attn.qkv.kernel.grad.numpy(), want["qkv"]["kernel"], 1e-5)
    _close(attn.proj.kernel.grad.numpy(), want["proj"]["kernel"], 1e-5)
    _close(attn.proj.bias.grad.numpy(), want["proj"]["bias"], 1e-5)


def test_long_trunk_matches_flax(monkeypatch):
    """1024 groups: L = 1025 tokens, where the reference's length guard puts
    every route on the unfused block with flash_mha (on the CPU its plain
    path, ``jax.nn.dot_product_attention``)."""
    from ppt_tpu.nn import PointBert as JaxPointBert

    rng = np.random.RandomState(4)
    pts = rng.rand(1, 2048, 3).astype(np.float32)
    jcfg, params, stats = _jax_pointbert(LONG, pts, rng)
    _set_switches(monkeypatch, {"PPT_FUSED_BLOCK": "1"})
    want = JaxPointBert(jcfg).apply({"params": params, "batch_stats": stats}, jnp.asarray(pts))
    with torch.no_grad():
        got = _port(LONG, params, stats, torch.float32, "block")(torch.from_numpy(pts))
    _close(got.numpy(), want, 1e-5)


# ---------------------------------------------------------------------------
# the switches and the length guard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("env,want", [
    ({}, "block"),
    ({"PPT_FUSED_BLOCK": "1"}, "block"),
    ({"PPT_FUSED_VIT_TOWER": "1"}, "tower"),
    ({"PPT_FUSED_VIT_TOWER": "0"}, "block"),
    ({"PPT_FUSED_BLOCK": "0"}, "unfused"),
    ({"PPT_FUSED_BLOCK": "0", "PPT_FUSED_VIT_TOWER": "1"}, "unfused"),
    ({"PPT_FUSED_BLOCK": "2"}, "unfused"),
    ({"PPT_FORCE_XLA_ATTN": "1"}, "plain"),
    ({"PPT_FORCE_XLA_ATTN": "0"}, "plain"),  # any non-empty value, as the reference reads it
    ({"PPT_FORCE_XLA_ATTN": "1", "PPT_FUSED_VIT_TOWER": "1"}, "plain"),
    ({"PPT_FORCE_XLA_ATTN": "", "PPT_FUSED_VIT_TOWER": "1"}, "tower"),
])
def test_point_route_from_env_precedence(env, want, monkeypatch):
    _set_switches(monkeypatch, env)
    assert cls.point_route_from_env() == want


def _count_calls(monkeypatch):
    """Count the calls of each trunk wrapper the module makes, and of the
    flash kernel's dispatcher (the plain path of flash_mha skips it)."""
    calls = {}

    def counted(mod, name):
        orig = getattr(mod, name)

        def wrapper(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return orig(*a, **kw)

        monkeypatch.setattr(mod, name, wrapper)

    for name in ("fused_vit_block", "fused_vit_block_readout", "fused_vit_tower", "fused_mha",
                 "flash_mha", "bf16_score_attention"):
        counted(npb, name)
    counted(kattn, "_flash_run")
    return calls


@pytest.mark.parametrize("route", sorted(ROUTE_ENV))
def test_a_1025_token_trunk_takes_flash_mha_on_every_route(route, monkeypatch):
    """Under every switch setting: 17 tokens take the route's own wrapper;
    1025 tokens take the unfused block with the flash kernel's route in
    every block and nothing else (before this guard the "block" route ran
    the fused block kernel at any length)."""
    _set_switches(monkeypatch, ROUTE_ENV[route])
    cfg = dict(LONG, trans_dim=16, num_heads=2, encoder_dims=32)
    model = PointBert(PointBertConfig(**cfg), route=cls.point_route_from_env())
    gen = torch.Generator().manual_seed(0)
    for p in model.parameters():
        p.data.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    calls = _count_calls(monkeypatch)
    with torch.no_grad():
        model.config = PointBertConfig(**dict(cfg, num_group=16))
        model(torch.rand(1, 64, 3, generator=gen))
        short = dict(calls)
        calls.clear()
        model.config = PointBertConfig(**cfg)
        out = model(torch.rand(1, 1100, 3, generator=gen))
    depth = cfg["depth"]
    assert short == {"block": {"fused_vit_block": depth - 1, "fused_vit_block_readout": 1},
                     "tower": {"fused_vit_tower": 1},
                     "unfused": {"fused_mha": depth},
                     "plain": {"flash_mha": depth}}[route]
    assert calls == {"flash_mha": depth, "_flash_run": depth}
    assert tuple(out.shape) == (1, 2 * cfg["trans_dim"]) and torch.isfinite(out).all()


@pytest.mark.parametrize("route", sorted(ROUTE_ENV))
def test_setup_passes_the_point_route_down(route, monkeypatch, tmp_path):
    """``cls.setup`` reads the switches once and the route reaches the
    trunk through ``args`` (``ulip_pointbert`` reads ``args.point_route``)."""
    _set_switches(monkeypatch, ROUTE_ENV[route])
    args = TaskArgs(dataset_name="synthetic", npoints=64, batch_size=4, device="cpu",
                    pretrained_dir="", num_learnable_prompt_tokens=4, output_dir=str(tmp_path))
    args.pointbert_config = PointBertConfig(**dict(SMALL, num_group=8))
    args.text_config = TextConfig(vocab_size=49408, **TEXT)
    assert cls.setup(args)["model"].point_encoder.route == route
    assert args.point_route == route


def test_tower_weights_are_cached_until_a_source_changes():
    """The tower route stacks and casts the blocks' weights once, until a
    source parameter changes; a weight that trains stays in the graph."""
    model = PointBert(PointBertConfig(**SMALL), dtype=torch.bfloat16, route="tower")
    gen = torch.Generator().manual_seed(0)
    for p in model.parameters():
        p.data.copy_(torch.randn(p.shape, generator=gen) * 0.1)
        p.requires_grad_(False)
    pts = torch.rand(2, 64, 3, generator=gen)
    before = model(pts)
    first = model.stacked_weights()
    assert all(a is b for a, b in zip(first, model.stacked_weights()))  # built once
    assert tuple(first[2].shape) == (2, 64, 192) and first[2].dtype == torch.bfloat16

    state = {k: v.clone() for k, v in model.state_dict().items()}
    state["block_0.mlp.fc1.kernel"] = state["block_0.mlp.fc1.kernel"] * 1.5
    model.load_state_dict(state)
    assert float((model(pts) - before).abs().max()) > 1e-4  # the new weight is in use
    assert torch.equal(model.stacked_weights()[7][0],
                       state["block_0.mlp.fc1.kernel"].to(torch.bfloat16))

    model.block_1.attn.qkv.kernel.requires_grad_(True)
    (gw,) = torch.autograd.grad(model(pts).sum(), model.block_1.attn.qkv.kernel)
    assert float(gw.abs().max()) > 0


# ---------------------------------------------------------------------------
# ulip_customized
# ---------------------------------------------------------------------------

TEXT = dict(width=64, layers=2, heads=4, embed_dim=64)
CLASSES = ["airplane", "chair", "night stand", "flower pot", "lamp"]


@struct.dataclass
class _State:
    trainable: dict
    frozen: dict
    batch_stats: dict


def test_ulip_customized_logits_match_jax(monkeypatch):
    """The template factory around a caller's PointBert (its own dtype and
    route), tiny text tower, weights through ``from_jax``: f32 logits
    within 1e-4 of their scale, as ``test_torch_slice.py`` holds
    ``ULIP_PointBERT``."""
    from ppt_tpu.models import PromptArrays as JaxPrompts
    from ppt_tpu.models.ulip import ulip_customized as jax_customized
    from ppt_tpu.nn import PointBert as JaxPointBert
    from ppt_tpu.nn import PointBertConfig as JaxConfig
    from ppt_tpu.nn import TextConfig as JaxTextConfig
    from ppt_tpu.prompt import build_prompt_spec as jax_spec
    from ppt_tpu.train.trainer import make_cached_text_eval as jax_cached_eval

    monkeypatch.setenv("PPT_FORCE_FUSED_MINI", "1")
    _set_switches(monkeypatch, ROUTE_ENV["tower"])
    rng = np.random.RandomState(5)
    pc = rng.rand(2, 64, 3).astype(np.float32)
    jargs = TaskArgs(num_learnable_prompt_tokens=4)
    jargs.text_config = JaxTextConfig(**TEXT)
    jspec = jax_customized(jargs, JaxPointBert(JaxConfig(**SMALL)), 2 * SMALL["trans_dim"])
    jprompts = JaxPrompts.from_spec(jax_spec(CLASSES, n_ctx=4, class_name_position="middle"))
    variables = jspec.model.init(jax.random.PRNGKey(0), jnp.asarray(pc[:1]), jprompts)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    embed_fn, step_fn = jax_cached_eval(jspec.model)
    state = _State(trainable=params, frozen={}, batch_stats=stats)
    want = np.asarray(step_fn(state, {"pc": jnp.asarray(pc)}, embed_fn(state, jprompts)))

    args = TaskArgs(num_learnable_prompt_tokens=4, class_name_position="middle")
    args.text_config = TextConfig(**TEXT)
    encoder = PointBert(PointBertConfig(**SMALL), route=cls.point_route_from_env())
    spec = ulip_customized(args, encoder, 2 * SMALL["trans_dim"])
    assert spec.name == "ULIP_CUSTOMIZED" and spec.model.point_encoder is encoder
    model = init_weights(spec.model, 0).eval()
    model.load_state_dict(from_jax(params, stats, model))
    prompts = PromptArrays.from_spec(
        build_prompt_spec(CLASSES, n_ctx=4, class_name_position="middle"), device="cpu")
    embed, step = make_cached_text_eval(model)
    logits = step(model, {"pc": torch.from_numpy(pc)}, embed(model, prompts))
    scale = float(np.max(np.abs(want)))
    assert np.max(np.abs(logits.numpy() - want)) <= 1e-4 * scale


# ---------------------------------------------------------------------------
# training through the long trunk: head types 2 and 3
# ---------------------------------------------------------------------------

LONG12 = dict(LONG, trans_dim=48, depth=12, encoder_dims=32)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _port_name(path):
    *mods, leaf = path
    return ".".join(list(mods) + [{"scale": "weight", "mean": "running_mean",
                                   "var": "running_var"}.get(leaf, leaf)])


@pytest.mark.parametrize("head_type", [2, 3])
def test_long_trunk_head_type_step_matches_reference(head_type, monkeypatch):
    """One prompt-tuning step of ``make_train_step`` on a narrow depth-12
    trunk of 1024 groups (L = 1025), head types 2 and 3 (``block_11``'s
    ``norm1``/``fc1`` or ``qkv``/``proj`` train: leaves before the block's
    attention, so the step runs ``flash_mha``'s backward once), against the
    reference's step from the same weights on the same batch. f32, DropPath
    0; loss rel 1e-4, AdamW's first moment (0.1 g) of every trainable leaf
    within 1e-3 of its largest entry, the updated leaves abs 1e-5 where the
    gradient exceeds that tolerance (AdamW's first step moves an entry by
    about lr sign(g), so an entry whose gradient is rounding noise on both
    sides may move either way: within 2 lr there), running statistics abs
    1e-5, frozen leaves bit-unchanged."""
    from ppt_tpu.models import PromptArrays as JaxPrompts
    from ppt_tpu.models import Ulip as JaxUlip
    from ppt_tpu.models import trainable_mask as jax_mask
    from ppt_tpu.nn import PointBert as JaxPointBert
    from ppt_tpu.nn import PointBertConfig as JaxConfig
    from ppt_tpu.nn import TextConfig as JaxTextConfig
    from ppt_tpu.prompt import build_prompt_spec as jax_spec
    from ppt_tpu.train.optim import build_optimizer as jax_optimizer
    from ppt_tpu.train.optim import build_schedule as jax_schedule
    from ppt_tpu.train.trainer import create_train_state as jax_create
    from ppt_tpu.train.trainer import make_train_step as jax_make_step

    from ppt_torch.models.ulip import build_model, trainable_mask
    from ppt_torch.train.optim import build_optimizer, build_schedule
    from ppt_torch.train.trainer import create_train_state, make_train_step

    _set_switches(monkeypatch, {"PPT_FUSED_BLOCK": "1"})
    monkeypatch.delenv("PPT_FORCE_FUSED_MINI", raising=False)
    rng = np.random.RandomState(6 + head_type)
    pc = rng.rand(2, 2048, 3).astype(np.float32)
    label = np.array([1, 3], np.int32)
    sched = dict(final_lr=1e-5, warmup_epochs=0, warmup_start_lr=1e-6)
    opt_kw = dict(weight_decay=0.1, betas=(0.9, 0.98), eps=1e-8)

    jmodel = JaxUlip(point_encoder=JaxPointBert(JaxConfig(**LONG12)), pc_feat_dims=96, n_ctx=4,
                     text_config=JaxTextConfig(**TEXT))
    jprompts = JaxPrompts.from_spec(jax_spec(CLASSES, n_ctx=4, class_name_position="middle"))
    variables = jax.tree_util.tree_map(
        np.array, jmodel.init(jax.random.PRNGKey(0), jnp.asarray(pc[:1]), jprompts))
    opt = jax_optimizer("adamw", jax_schedule("cosine", 3e-3, 2, 4, **sched), **opt_kw)
    jstate = jax_create(jax.tree_util.tree_map(jnp.asarray, variables),
                        jax_mask(variables["params"], head_type=head_type), opt,
                        jax.random.PRNGKey(1))
    jstate, jm = jax_make_step(jmodel, opt, smoothing=0.2)(
        jstate, {"pc": jnp.asarray(pc), "label": jnp.asarray(label)}, jprompts)

    args = TaskArgs(num_learnable_prompt_tokens=4, class_name_position="middle")
    args.pointbert_config = PointBertConfig(**LONG12)
    args.text_config = TextConfig(**TEXT)
    model = build_model("ULIP_PointBERT", args, device="cpu").model
    model.load_state_dict(from_jax(variables["params"], variables["batch_stats"], model))
    state = create_train_state(
        model, trainable_mask(model, head_type=head_type),
        lambda tr: build_optimizer("adamw", tr.items(),
                                   build_schedule("cosine", 3e-3, 2, 4, **sched), **opt_kw),
        seed=1)
    leaves = {2: ("norm1", "mlp.fc1"), 3: ("attn.qkv", "attn.proj")}[head_type]
    assert any(f"block_11.{leaf}" in k for k in state.trainable for leaf in leaves)
    frozen0 = {k: v.detach().clone() for k, v in model.named_parameters()
               if k not in state.trainable}
    prompts = PromptArrays.from_spec(
        build_prompt_spec(CLASSES, n_ctx=4, class_name_position="middle"), device="cpu")
    calls = _count_calls(monkeypatch)
    state, m = make_train_step(smoothing=0.2)(
        state, {"pc": torch.from_numpy(pc), "label": torch.from_numpy(label).long()}, prompts)
    assert calls == {"flash_mha": 12, "_flash_run": 12}

    want = float(jm["loss"])
    assert abs(float(m["loss"]) - want) <= 1e-4 * abs(want)
    mus = _flat(jax.tree_util.tree_map(np.asarray, jstate.opt_state[0].mu))
    assert {_port_name(p) for p in mus} == set(state.trainable)
    for path, want_mu in mus.items():
        got_mu = state.optimizer.mu[_port_name(path)].numpy()
        assert np.max(np.abs(got_mu - want_mu)) <= 1e-3 * np.max(np.abs(want_mu)), path
    for path, want_p in _flat(jax.tree_util.tree_map(np.asarray, jstate.trainable)).items():
        diff = np.abs(state.trainable[_port_name(path)].detach().numpy() - want_p)
        sure = np.abs(mus[path]) > 1e-3 * np.max(np.abs(mus[path]))
        assert np.max(diff[sure], initial=0.0) <= 1e-5, path
        assert np.max(diff) <= 2 * 3e-3, path
    stats = dict(model.named_buffers())
    for path, want_s in _flat(jax.tree_util.tree_map(np.asarray, jstate.batch_stats)).items():
        assert np.max(np.abs(stats[_port_name(path)].numpy() - want_s)) <= 1e-5, path
    for k, v in model.named_parameters():
        if k in frozen0:
            assert torch.equal(v, frozen0[k]), k


# ---------------------------------------------------------------------------
# LayerNormF32 and the unfused DropPath against the reference's modules
# ---------------------------------------------------------------------------


def test_layernorm_clamps_the_fast_variance_as_flax_does():
    """Near-constant rows of large values (300-3000 with 1e-3 noise), where
    E[x^2] - E[x]^2 rounds below zero: clamped at 0, as flax's
    ``_compute_stats`` does, so no NaN (before the repair 4-29 of 64 rows
    of 384 were NaN). Two-wide rows have one summation order in any
    implementation, so the same statistics: there the output matches
    flax's ``LayerNorm`` within 1e-5 of its max magnitude (the affine is
    rounded in another order), a quarter of them through the clamp. Rows
    of 384 are summed in another order by each side, so the rounding noise
    that stands in for the variance differs: there both are finite."""
    import flax.linen as fnn

    from ppt_torch.nn.layers import LayerNormF32

    rng = np.random.RandomState(9)
    jln = fnn.LayerNorm(epsilon=1e-6, dtype=jnp.float32)
    for width in (2, 384):
        x = (rng.uniform(300, 3000, (256, 1)) + 1e-3 * rng.randn(256, width)).astype(np.float32)
        w = (1 + 0.1 * rng.randn(width)).astype(np.float32)
        b = (0.1 * rng.randn(width)).astype(np.float32)
        ln = LayerNormF32(width, eps=1e-6)
        ln.weight.data, ln.bias.data = torch.from_numpy(w), torch.from_numpy(b)
        want = np.asarray(jln.apply({"params": {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}},
                                    jnp.asarray(x)))
        with torch.no_grad():
            got = ln(torch.from_numpy(x)).numpy()
        assert np.isfinite(got).all() and np.isfinite(want).all()
        if width == 2:
            fast_var = (x * x).mean(-1) - x.mean(-1) ** 2
            assert (fast_var < 0).sum() >= 32  # the rows that take the clamp
            _close(got, want, 1e-5)


def test_unfused_bf16_droppath_is_the_reference_division():
    """bf16 at rate 0.1 (bf16(keep) = 0.8984375): the kept samples' branch
    divided in bf16, the dropped ones exactly zero, bit-equal to the
    reference's ``DropPath`` for its own mask; and a ``VitBlock`` on the
    unfused route adds exactly that branch."""
    from ppt_tpu.nn.layers import DropPath

    from ppt_torch.nn.layers import drop_path
    from ppt_torch.nn.pointbert import VitBlock

    rng = np.random.RandomState(10)
    h = rng.randn(16, 8, 64).astype(np.float32)
    key = {"droppath": jax.random.PRNGKey(1)}
    jdp = DropPath(0.1)
    want = jdp.apply({}, jnp.asarray(h, jnp.bfloat16), deterministic=False, rngs=key)
    kept = np.asarray(jdp.apply({}, jnp.ones((16, 1, 1)), deterministic=False, rngs=key))[:, 0, 0]
    assert 0 < (kept == 0).sum() < 16
    scale = torch.from_numpy(kept.astype(np.float32))
    got = drop_path(torch.from_numpy(h).to(torch.bfloat16), scale, 0.1)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(),
                          np.asarray(want).view(np.int16))
    assert torch.equal(drop_path(torch.from_numpy(h), scale, 0.0), torch.from_numpy(h))

    blk = VitBlock(64, 2, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    for p in blk.parameters():
        p.data.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    x = torch.randn(16, 8, 64, generator=gen).to(torch.bfloat16)
    pos = torch.zeros(16, 8, 64)
    dp = torch.stack([scale, torch.ones(16)], dim=1)
    with torch.no_grad():
        out = blk(x, pos, dp, route="unfused", rate=0.1)
        h1 = blk.attn(blk.norm1(x), 2, True)
        x1 = x + drop_path(h1, dp[:, 0], 0.1)
        want_out = x1 + drop_path(blk.mlp(blk.norm2(x1)), dp[:, 1], 0.1)
    assert torch.equal(out, want_out)
    assert torch.equal(out[kept == 0], (x + (blk.mlp(blk.norm2(x)) / torch.tensor(
        0.9, dtype=torch.bfloat16)))[kept == 0])
