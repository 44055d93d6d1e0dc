"""Port vs reference: part segmentation's modules, trunk, model and step.

``three_nn`` / ``three_interpolate``, ``FeaturePropagation``,
``DgcnnPropagation``, ``PointBertPartSeg`` on each trunk route, the
``ULIP_PointBERT_partseg`` logits, its trainable partition and one train
step, against ``ppt_tpu`` with the same weights (``convert.from_jax``'s
name rule) and the same numpy inputs. The reference runs its XLA paths (no
Pallas kernel: on the CPU its switches default off); the port runs its
kernels' plain versions.

Sizes: the reference's own partseg smoke trunk (48 wide, depth 12, which
the taps at blocks 3, 7 and 11 force, 4 heads, 16 groups of 8, encoder 32),
B=2 x N=1024 (FPS takes 512 and 256 points), a 2-layer text tower 64 wide,
``drop_path_rate=0``. Clouds lie on the 1/64 lattice of [0, 1/4): every
squared distance is exact in f32, so the expanded-form and exact-difference
distances agree, coincident points give an exact 0 in the interpolation's
weights, and ties are settled by index on both sides.

Tolerances (f32 on both sides, other summation orders): interpolation and
modules within 1e-5 of the output's max magnitude; the trunk's per-point
features and the logits within 1e-4; running statistics within 1e-5
absolute; module gradients within 1e-5 of each leaf's scale (a leaf whose
gradient is rounding noise, a bias before a train-mode BatchNorm, within
1e-5 of the largest gradient); the step's loss and the prompt's gradient
within 1e-4, the heads' gradients within 5e-2 (the step's docstring says
why), updated leaves within 1e-5 where the gradient is settled. Indices
exactly equal.
"""

import json

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pointmlp import _randomise, flax_variables_from_port
from test_torch_pointnet2 import close, np_tree
from test_torch_trainer import OPT, SCHED, flat

from ppt_torch.convert import _port_key, from_jax
from ppt_torch.models.losses import smoothed_cross_entropy
from ppt_torch.models.ulip import PromptArrays, build_model, trainable_mask
from ppt_torch.nn import pointbert as npb
from ppt_torch.nn.pointbert import DgcnnPropagation, FeaturePropagation, PointBertConfig
from ppt_torch.nn.text import TextConfig
from ppt_torch.ops import geometry as tgeo
from ppt_torch.prompt.learner import build_prompt_spec
from ppt_torch.tasks.args import TaskArgs
from ppt_torch.tasks.partseg import part_names
from ppt_torch.train.optim import build_optimizer, build_schedule
from ppt_torch.train.trainer import create_train_state, make_eval_step, make_train_step

TINY = dict(trans_dim=48, depth=12, drop_path_rate=0.0, num_heads=4, group_size=8,
            num_group=16, encoder_dims=32)
TEXT = dict(width=64, layers=2, heads=4, embed_dim=64)
B, N = 2, 1024
ROUTES = {"block": {}, "tower": {"PPT_FUSED_VIT_TOWER": "1"},
          "unfused": {"PPT_FUSED_BLOCK": "0"}, "plain": {"PPT_FORCE_XLA_ATTN": "1"}}


def lattice(b, n, seed):
    return (np.random.RandomState(seed).randint(0, 16, (b, n, 3)) / 64).astype(np.float32)


def onehot(cats):
    return np.eye(16, dtype=np.float32)[cats]


@pytest.fixture
def no_dropout(monkeypatch):
    """Both packages' head dropouts as the identity."""

    class Keep(flax.linen.Module):
        rate: float

        @flax.linen.compact
        def __call__(self, x, deterministic=True):
            return x

    monkeypatch.setattr(flax.linen, "Dropout", Keep)
    monkeypatch.setattr(npb, "dropout", lambda x, rate, train, generator: x)


# ---------------------------------------------------------------------------
# three_nn / three_interpolate
# ---------------------------------------------------------------------------


def _interp_case(case):
    rng = np.random.RandomState(3)
    if case == "random":
        return rng.rand(2, 40, 3).astype(np.float32), rng.rand(2, 9, 3).astype(np.float32)
    known = lattice(2, 12, 4)
    if case == "ties":  # every point of a 2 x 2 x 2 lattice cube: many equal distances
        known = (np.stack(np.meshgrid(*[np.arange(2)] * 3, indexing="ij"), -1)
                 .reshape(1, 8, 3) / 64).astype(np.float32).repeat(2, 0)
        known = np.concatenate([known, known[:, :3]], 1)  # duplicated sources too
    unknown = np.concatenate([lattice(2, 30, 5), known[:, :6]], 1)  # coincident with sources
    return unknown, known


@pytest.mark.parametrize("case", ["random", "ties", "coincident"])
def test_three_nn_and_interpolate_match_reference(case):
    from ppt_tpu.ops import geometry as jgeo

    unknown, known = _interp_case(case)
    feats = np.random.RandomState(6).randn(*known.shape[:2], 5).astype(np.float32)
    want_d, want_i = jgeo.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    got_d, got_i = tgeo.three_nn(torch.from_numpy(unknown), torch.from_numpy(known))
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    if case == "random":
        np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
        assert (got_d.numpy() >= 0).all() and (got_d[:, -6:, 0] == 0).all()
    want = jgeo.three_interpolate(jnp.asarray(unknown), jnp.asarray(known), jnp.asarray(feats))
    got = tgeo.three_interpolate(torch.from_numpy(unknown), torch.from_numpy(known),
                                 torch.from_numpy(feats))
    close(got.numpy(), want, 1e-5)


def test_three_interpolate_keeps_the_features_dtype():
    unknown, known = _interp_case("coincident")
    feats = torch.randn(*known.shape[:2], 4).to(torch.bfloat16)
    out = tgeo.three_interpolate(torch.from_numpy(unknown), torch.from_numpy(known), feats)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 36, 4)
    # a coincident point takes its source's features (the 1e8 weight rounds the rest away)
    assert torch.equal(out[:, -6:], feats[:, :6])


def test_stable_knn_matches_reference_ties():
    """``torch.topk`` orders tied distances otherwise than ``lax.top_k``; the
    port's kNN (the EdgeConv propagation's) sorts stably and keeps the
    reference's neighbours."""
    from ppt_tpu.ops import geometry as jgeo

    xyz, q = lattice(2, 64, 7), lattice(2, 48, 8)
    want = jgeo.knn_point(4, jnp.asarray(xyz), jnp.asarray(q))
    got = tgeo.knn_point(4, torch.from_numpy(xyz), torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# FeaturePropagation / DgcnnPropagation
# ---------------------------------------------------------------------------


def grads_close(tmod, got, japply, variables, tol=1e-5):
    """The gradients of ``sum(out * cot)`` for a fixed random cotangent: every
    parameter of ``tmod`` within ``tol`` of the largest gradient of its
    leaf; a leaf whose gradient is rounding noise (under 1e-4 of the
    module's largest: a bias before a train-mode BatchNorm) within ``tol``
    of the module's largest gradient."""
    cot = np.random.RandomState(0).randn(*got.shape).astype(np.float32)
    want = flat(np_tree(jax.jit(jax.grad(lambda p: jnp.sum(japply(p) * cot)))(
        variables["params"])))
    (got * torch.from_numpy(cot)).sum().backward()
    params = dict(tmod.named_parameters())
    top = max(float(np.max(np.abs(w))) for w in want.values())
    assert len(want) == len(params)
    for path, w in want.items():
        g = params[port_name(path)].grad.numpy()
        scale = float(np.max(np.abs(w)))
        scale = top if scale < 1e-4 * top else scale
        assert np.max(np.abs(g - w)) <= tol * scale, (path, np.max(np.abs(g - w)), scale)


@pytest.mark.parametrize("with_points1", [True, False])
def test_feature_propagation_matches_flax_in_eval_and_train(with_points1):
    from ppt_tpu.nn.pointbert import FeaturePropagation as JaxFP

    rng = np.random.RandomState(9)
    xyz1, xyz2 = lattice(2, 64, 10), lattice(2, 16, 11)
    p1 = rng.randn(2, 64, 5).astype(np.float32) if with_points1 else None
    p2 = rng.randn(2, 16, 7).astype(np.float32)
    jmod = JaxFP((24, 12))
    tmod = FeaturePropagation((5 if with_points1 else 0) + 7, (24, 12))
    _randomise(tmod, 12)
    jin = [jnp.asarray(x) if x is not None else None for x in (xyz1, xyz2, p1, p2)]
    tin = [torch.from_numpy(x) if x is not None else None for x in (xyz1, xyz2, p1, p2)]
    variables = flax_variables_from_port(jmod, tmod, *jin)
    tmod.load_state_dict(from_jax(variables["params"], variables["batch_stats"], tmod))
    want = jmod.apply(variables, *jin)
    with torch.no_grad():
        got = tmod(*tin)
    assert got.dtype == torch.float32 and got.shape == (2, 64, 12)
    close(got.numpy(), want, 1e-5)
    want, mutated = jmod.apply(variables, *jin, True, mutable=["batch_stats"])
    got = tmod(*tin, train=True)
    close(got.detach().numpy(), want, 1e-5)
    grads_close(tmod, got, lambda p: jmod.apply({"params": p, "batch_stats":
                                                 variables["batch_stats"]}, *jin, True,
                                                mutable=["batch_stats"])[0], variables)
    new = flat(np_tree(mutated["batch_stats"]))
    old = flat(np_tree(variables["batch_stats"]))
    bufs = dict(tmod.named_buffers())
    for path, w in new.items():
        np.testing.assert_allclose(bufs[port_name(path, True)].numpy(), w, rtol=0, atol=1e-5)
        assert not np.allclose(w, old[path])  # the running statistics moved


def test_dgcnn_propagation_matches_flax():
    """Both EdgeConv rounds: kNN on lattice coordinates (ties settled by
    index as the reference's), GroupNorm(4) in f32, leaky ReLU, max over k."""
    from ppt_tpu.nn.pointbert import DgcnnPropagation as JaxDgcnn

    rng = np.random.RandomState(13)
    coor, coor_q = lattice(2, 16, 14), lattice(2, 40, 15)
    f, f_q = rng.randn(2, 16, 6).astype(np.float32), rng.randn(2, 40, 6).astype(np.float32)
    jmod = JaxDgcnn(k=4, hidden_dim=16, out_dim=8)
    tmod = DgcnnPropagation(6, k=4, hidden_dim=16, out_dim=8)
    _randomise(tmod, 16)
    jin = [jnp.asarray(x) for x in (coor, f, coor_q, f_q)]
    variables = flax_variables_from_port(jmod, tmod, *jin)
    tmod.load_state_dict(from_jax(variables["params"], {}, tmod))
    want = jmod.apply(variables, *jin)
    got = tmod(*[torch.from_numpy(x) for x in (coor, f, coor_q, f_q)])
    assert got.dtype == torch.float32 and got.shape == (2, 40, 8)
    close(got.detach().numpy(), want, 1e-5)
    grads_close(tmod, got, lambda p: jmod.apply({"params": p}, *jin), variables)


# ---------------------------------------------------------------------------
# The trunk and the model against one reference oracle
# ---------------------------------------------------------------------------


def port_name(path, stats=False):
    return _port_key(path, stats)


def port_args(route="block", dtype="float32"):
    args = TaskArgs(model="ULIP_PointBERT_partseg", num_learnable_prompt_tokens=4,
                    class_name_position="middle", compute_dtype=dtype)
    args.pointbert_config = PointBertConfig(**TINY)
    args.text_config = TextConfig(**TEXT)
    args.point_route = route
    return args


def port_prompts():
    return PromptArrays.from_spec(build_prompt_spec(part_names(), n_ctx=4,
                                                    class_name_position="middle"), device="cpu")


@pytest.fixture(scope="module")
def oracle():
    """The reference's ``Ulip`` over ``PointBertPartSeg`` with a port model's
    weights (BatchNorm state randomised), and its eval-mode trunk features
    and logits on one lattice batch."""
    from ppt_tpu.models import PromptArrays as JaxPrompts
    from ppt_tpu.models import Ulip as JaxUlip
    from ppt_tpu.nn import PointBertConfig as JaxConfig
    from ppt_tpu.nn import TextConfig as JaxTextConfig
    from ppt_tpu.nn.pointbert import PointBertPartSeg as JaxPartSeg
    from ppt_tpu.prompt import build_prompt_spec as jax_spec

    jmodel = JaxUlip(point_encoder=JaxPartSeg(JaxConfig(**TINY)), pc_feat_dims=128, n_ctx=4,
                     task="partseg", text_config=JaxTextConfig(**TEXT))
    jprompts = JaxPrompts.from_spec(jax_spec(part_names(), n_ctx=4,
                                             class_name_position="middle"))
    model = build_model("ULIP_PointBERT_partseg", port_args(), device="cpu").model
    _randomise(model.point_encoder, 17)
    pts, cats = lattice(B, N, 18), np.array([3, 12])
    variables = flax_variables_from_port(jmodel, model, jnp.asarray(pts), jprompts,
                                         jnp.asarray(onehot(cats)))

    def both(v, pc, oh):
        feat = jmodel.apply(v, pc, oh, method=lambda m, p, o: m.point_encoder(p, o))
        return feat, jmodel.apply(v, pc, jprompts, oh)

    feat, logits = jax.jit(both)(variables, jnp.asarray(pts), jnp.asarray(onehot(cats)))
    return dict(jmodel=jmodel, jprompts=jprompts, variables=np_tree(variables), pts=pts,
                cats=cats, feat=np.asarray(feat), logits=np.asarray(logits))


def port_model(oracle, route="block", dtype="float32"):
    model = build_model("ULIP_PointBERT_partseg", port_args(route, dtype), device="cpu").model
    v = oracle["variables"]
    model.load_state_dict(from_jax(v["params"], v["batch_stats"], model))
    return model


def _count_calls(monkeypatch):
    counts = {}

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrapper(*a, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **kw)

        monkeypatch.setattr(mod, name, wrapper)

    from ppt_torch.kernels import group as kgroup

    for name in ("fps_batched", "knn_gather"):
        counted(kgroup, name)
    for name in ("mini_forward", "mini_stats", "fused_vit_block", "fused_vit_block_readout",
                 "fused_vit_tower", "fused_mha", "flash_mha"):
        counted(npb, name)
    return counts


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_partseg_trunk_matches_flax_on_each_route(route, oracle, monkeypatch):
    """Per-point features [B, N, 128] within 1e-4 of their max magnitude on
    every route, with each route's wrappers called as on the card: FPS three
    times (the groups, 512, 256), kNN and the encoder once, twelve fused
    blocks on "block" (no readout: the taps need the blocks' tokens) and on
    "tower" (the reference's partseg trunk never reads the tower switch),
    ``fused_mha`` twelve times on "unfused", no trunk kernel on "plain"."""
    counts = _count_calls(monkeypatch)
    model = port_model(oracle, route)
    with torch.no_grad():
        got = model.point_encoder(torch.from_numpy(oracle["pts"]),
                                  torch.from_numpy(onehot(oracle["cats"])))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, N, 128)
    close(got.numpy(), oracle["feat"], 1e-4)
    want = {"fps_batched": 3, "knn_gather": 1, "mini_forward": 1}
    want.update({"block": {"fused_vit_block": 12}, "tower": {"fused_vit_block": 12},
                 "unfused": {"fused_mha": 12}, "plain": {"flash_mha": 12}}[route])
    assert counts == want, counts


def test_partseg_logits_match_flax(oracle):
    model = port_model(oracle)
    prompts = port_prompts()
    with torch.no_grad():
        logits = model(torch.from_numpy(oracle["pts"]), prompts,
                       cls_onehot=torch.from_numpy(onehot(oracle["cats"])))
        embed = model.encode_pc(torch.from_numpy(oracle["pts"]),
                                cls_onehot=torch.from_numpy(onehot(oracle["cats"])))
    assert tuple(logits.shape) == (B, N, 50) and tuple(embed.shape) == (B, N, 64)
    close(logits.numpy(), oracle["logits"], 1e-4)
    state = create_train_state(model, trainable_mask(model, 0, "partseg"),
                               lambda tr: build_optimizer("adamw", tr.items(), lambda s: 1e-3),
                               seed=1)
    batch = {"pc": torch.from_numpy(oracle["pts"]),
             "cls_onehot": torch.from_numpy(onehot(oracle["cats"]))}
    assert torch.equal(make_eval_step(partseg=True)(state, batch, prompts), logits)


@pytest.mark.parametrize("head_type", [0, 1, 2, 3])
def test_partseg_trainable_mask_matches_reference(head_type, oracle):
    from ppt_tpu.models import trainable_mask as jax_mask

    model = port_model(oracle)
    mask = trainable_mask(model, head_type=head_type, task="partseg")
    jmask = flat(jax_mask(oracle["variables"]["params"], head_type=head_type, task="partseg"))
    assert mask == {port_name(p): bool(v) for p, v in jmask.items()}
    heads = ("propagation_0", "propagation_1", "propagation_2", "dgcnn_pro_1", "dgcnn_pro_2",
             "conv1", "bn1")
    assert all(mask[k] for k in mask if k.split(".")[:2][-1] in heads)
    assert not mask["point_encoder.encoder.bn1.weight"]  # the trunk's own bn1 stays frozen


@pytest.mark.parametrize("head_type", [0, 3])
def test_partseg_train_step_lockstep_with_reference(head_type, oracle, no_dropout, monkeypatch):
    """One step from the same weights on the same batch: the reference's
    partseg loss (``trainer.py:141-160``: flattened label-smoothed CE, the
    point tower in training mode, its MiniPointNet on the fused kernel as on
    its chip, interpreted) differentiated by ``jax.value_and_grad`` over its
    trainable partition, then its AdamW update; the port's
    ``make_train_step(partseg=True)`` and, before it, autograd of the same
    loss. Head type 3 carries ``block_11``'s gradient through
    ``fused_vit_block``'s recompute (its plain version here).

    The loss and the prompt's gradient are held at phase 5's f32 limit
    (1e-4). The segmentation heads' gradients, and ``block_11``'s, which
    come back through them, are not that well conditioned: in the port
    alone, multiplying the taps by 1 + 1e-7 noise (one f32 ulp) moves them
    by up to 0.9% of their scale, 1.5% at 1e-6, and the train-mode forward
    here differs from the reference's by 1.2e-5 of its scale at the head.
    Each such leaf is held within 5e-2 of its scale (measured up to 1.1e-2
    at head type 0 and 2.9e-2 at head type 3, in ``dgcnn_pro_1.gn1.bias``);
    ``test_feature_propagation_*`` and ``test_dgcnn_*`` hold the same
    modules' gradients within 1e-5 on fixed inputs."""
    from ppt_tpu.models import trainable_mask as jax_mask
    from ppt_tpu.models.losses import smoothed_cross_entropy as jax_ce
    from ppt_tpu.train.optim import build_optimizer as jax_optimizer
    from ppt_tpu.train.optim import build_schedule as jax_schedule
    from ppt_tpu.train.trainer import merge_params, partition_params

    smoothing, lr = 0.2, 3e-3
    monkeypatch.setenv("PPT_FORCE_FUSED_MINI", "1")
    jmodel, v = oracle["jmodel"], oracle["variables"]
    rng = np.random.RandomState(20 + head_type)
    cats = rng.randint(0, 16, B)
    b = {"pc": lattice(B, N, 21 + head_type), "cls_onehot": onehot(cats),
         "label": rng.randint(0, 50, (B, N)).astype(np.int32)}
    trainable, frozen = partition_params(v["params"], jax_mask(v["params"], head_type,
                                                               "partseg"))

    def jloss(tr):
        logits, mutated = jmodel.apply(
            {"params": merge_params(tr, frozen), "batch_stats": v["batch_stats"]},
            jnp.asarray(b["pc"]), oracle["jprompts"], cls_onehot=jnp.asarray(b["cls_onehot"]),
            train=True, mutable=["batch_stats"], rngs={"droppath": jax.random.PRNGKey(0)})
        flat_logits = logits.reshape(-1, logits.shape[-1])
        return jax_ce(flat_logits, jnp.asarray(b["label"]).reshape(-1), smoothing), \
            mutated["batch_stats"]

    (want_loss, want_stats), want_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, trainable))
    opt = jax_optimizer("adamw", jax_schedule("cosine", lr, 3, 2, **SCHED), **OPT)
    updates, _ = opt.update(want_grads, opt.init(trainable), trainable)
    want_new = flat(np_tree(jax.tree_util.tree_map(lambda p, u: p + u, trainable, updates)))
    want_grads = {port_name(k): g for k, g in flat(np_tree(want_grads)).items()}
    want_loss = float(want_loss)

    model = port_model(oracle)
    state = create_train_state(
        model, trainable_mask(model, head_type, "partseg"),
        lambda tr: build_optimizer("adamw", tr.items(),
                                   build_schedule("cosine", lr, 3, 2, **SCHED), **OPT), seed=1)
    assert set(state.trainable) == set(want_grads)
    assert ("point_encoder.block_11.attn.qkv.kernel" in state.trainable) == (head_type == 3)
    prompts = port_prompts()
    tb = {"pc": torch.from_numpy(b["pc"]), "cls_onehot": torch.from_numpy(b["cls_onehot"]),
          "label": torch.from_numpy(b["label"]).long()}
    buffers0 = {k: t.clone() for k, t in model.named_buffers()}
    logits = model(tb["pc"], prompts, train=True, cls_onehot=tb["cls_onehot"])
    loss = smoothed_cross_entropy(logits.reshape(-1, 50), tb["label"].reshape(-1), smoothing)
    names = list(state.trainable)
    grads = dict(zip(names, torch.autograd.grad(loss, [state.trainable[k] for k in names])))
    assert abs(float(loss.detach()) - want_loss) <= 1e-4 * abs(want_loss), (float(loss.detach()), want_loss)
    top = max(float(np.max(np.abs(g))) for g in want_grads.values())
    for k, g in grads.items():
        scale = float(np.max(np.abs(want_grads[k])))
        scale = top if scale < 1e-4 * top else scale  # rounding noise: a bias before a BN
        err = float(np.max(np.abs(g.numpy() - want_grads[k])))
        assert err <= (1e-4 if k.startswith("prompt_learner.") else 5e-2) * scale, (k, err, scale)
    with torch.no_grad():
        for k, t in model.named_buffers():
            t.copy_(buffers0[k])

    frozen0 = {k: p.detach().clone() for k, p in model.named_parameters()
               if k not in state.trainable}
    state, m = make_train_step(smoothing=smoothing, partseg=True)(state, tb, prompts)
    assert abs(float(m["loss"]) - want_loss) <= 1e-4 * abs(want_loss)
    acc = 100.0 * float((logits.argmax(-1) == tb["label"]).float().mean())
    assert abs(float(m["acc"]) - acc) <= 1e-4
    bufs = dict(model.named_buffers())
    for path, w in flat(np_tree(want_stats)).items():
        np.testing.assert_allclose(bufs[port_name(path, True)].numpy(), w, rtol=0, atol=1e-5,
                                   err_msg=str(path))
    for path, w in want_new.items():  # AdamW's first step: lr x sign(g) + decay
        k = port_name(path)
        settled = np.abs(want_grads[k]) > 0.1 * np.max(np.abs(want_grads[k]))
        got = state.trainable[k].detach().numpy()
        assert np.max(np.abs(got - w)[settled], initial=0.0) <= 1e-5, k
    for k, p in model.named_parameters():
        if k in frozen0:
            assert torch.equal(p, frozen0[k]), k
