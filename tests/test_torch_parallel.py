"""Port vs reference: the parallelism (``ppt_torch/parallel/`` against
``ppt_tpu/parallel/``).

- the tensor-parallel rule table, case for case as the reference's
  ``TestShardingRules``, through the flax-path rule and the port-name rule,
  and over a whole tiny flagship tree;
- ``_first_slurm_node``, case for case as the reference's;
- one spawned 2-rank gloo group on the CPU (module-scoped; its ranks meet
  through a ``file://`` rendezvous under ``tmp_path``, so xdist workers never
  race for a port; a rank imports ``ppt_torch``, never this module or JAX)
  runs, from the JAX package's weights (``convert.from_jax``) and the same
  numpy inputs: the dp = 2 recognition, part-segmentation and ULIP
  pretraining SGD steps, against the JAX step on ``create_mesh(2)``; a
  tp = 2 step against ``shard_params`` on a ("data", "model") mesh of 2;
  the pp = 2 trunk and partseg features and their gradients against
  ``pipelined_trunk_features`` / ``pipelined_partseg_features`` on a
  (1, 2) ("data", "pipe") mesh; ``_run_pipelined``'s four refusals. The
  same group runs the dp = 2 recognition and part-segmentation steps (the
  latter also with its head dropout live) and one dVAE, one MPM and one MAE
  step against the port's own step in one process on the same weights and
  inputs, every leaf at the reference's tolerances: the parallelism apart
  from the two packages' conditioning, and the draws the packages cannot
  share (Gumbel noise, group masks, DropPath, masking noise) taken at the
  global batch. The JAX side runs on the conftest's virtual CPU devices
  while the ranks run;
- the reference's two-process bring-up (``tests/test_multihost.py``)
  through ``PPT_COORDINATOR``: the loader's strides are disjoint and cover
  the batch, and the reduced loss is equal on both ranks;
- ``python -m ppt_torch.parallel.dryrun --nproc 4 --device cpu``.

Tolerances (f32 on both sides, other summation orders; SGD at lr 0.05, as
the reference's ``test_dp_equivalence``, so an updated leaf differs by lr
times its gradient's difference): the reference's own, loss rtol 1e-5,
updated leaves and BatchNorm statistics rtol 1e-4 / atol 1e-5, features
atol 2e-5 (trunk) and 5e-5 (partseg), gradients within 5e-5 (trunk) and
1e-4 (partseg, through the taps) of each leaf's largest entry. Part
segmentation's heads are not that well conditioned: 1e-7 relative noise on
the input clouds moves their gradients by 1.2% (the port alone, one
process), and ``test_torch_partseg`` measured the port's and the reference's
head gradients up to 2.9% apart; the dp = 2 step holds the loss, the prompt
and every BatchNorm statistic at the reference's tolerances and each head
leaf within 5e-2 of its update's largest entry, as that file does (measured
1.0e-2), plus 1e-7 for the Dense biases just before a train-mode BatchNorm,
whose gradient its batch mean cancels to rounding noise (updates of 1e-9).
"""

import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppt_torch.convert import _port_key, from_jax
from ppt_torch.parallel import launch, mesh as tmesh, sharding as tsharding, workers

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(trans_dim=48, depth=2, num_heads=4, group_size=8, num_group=16, encoder_dims=32,
            drop_path_rate=0.0)
SEG = dict(TINY, depth=12)  # the partseg trunk taps blocks 3, 7 and 11
CFG = dict(trans_dim=64, depth=4, num_heads=4, num_group=32, group_size=16, encoder_dims=64)
TEXT = dict(width=64, layers=2, heads=4, embed_dim=64)
PARTS = [f"part {i}" for i in range(8)]
LR = 0.05
DVAE = dict(group_size=8, num_group=16, encoder_dims=32, tokens_dims=32, decoder_dims=32,
            num_tokens=64)
SELFSUP = {  # DropPath live in the MPM student, so its draws are global too
    "dvae": dict(stage="dvae", dvae=DVAE, seed=3),
    "mpm": dict(stage="mpm", dvae=DVAE, seed=4,
                point=dict(TINY, drop_path_rate=0.1, group_size=8, num_group=16)),
    "mae": dict(stage="mae", seed=5,
                mae=dict(num_group=16, group_size=8, mask_ratio=0.5, encoder_dims=32,
                         trans_dim=48, depth=2, decoder_depth=1, num_heads=4)),
}


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def port_name(path, stats=False):
    return _port_key(tuple(path), stats)


def modelnet40():
    with open(os.path.join(ROOT, "ppt_tpu", "assets", "labels.json")) as f:
        return json.load(f)["modelnet40"]


# ---------------------------------------------------------------------------
# The rule table (``tests/test_train.py::TestShardingRules``)
# ---------------------------------------------------------------------------

RULE_CASES = [
    (("text", "block_0", "attn", "in_proj", "kernel"), 2, "column"),
    (("point_encoder", "block_3", "attn", "qkv", "kernel"), 2, "column"),
    (("text", "block_0", "c_fc", "kernel"), 2, "column"),
    (("point_encoder", "block_3", "mlp", "fc1", "kernel"), 2, "column"),
    (("point_encoder", "block_3", "attn", "proj", "kernel"), 2, "row"),
    (("point_encoder", "block_3", "mlp", "fc2", "kernel"), 2, "row"),
    (("some_head", "proj", "kernel"), 2, "replicated"),  # 'proj' outside attention
    (("head", "fc1", "kernel"), 2, "replicated"),  # fc1/fc2 outside an mlp block
    (("head", "fc2", "kernel"), 2, "replicated"),
    (("logit_scale",), 0, "replicated"),
    (("text", "block_0", "attn", "qkv", "bias"), 1, "replicated"),
    (("text", "token_embedding", "embedding"), 2, "column"),
]


def _jax_spec(kind):
    from jax.sharding import PartitionSpec as P

    return {"column": P(None, "model"), "row": P("model", None), "replicated": P()}[kind]


def _port_spec(kind):
    from torch.distributed.tensor import Replicate, Shard

    return {"column": Shard(1), "row": Shard(0), "replicated": Replicate()}[kind]


@pytest.mark.parametrize("path,ndim,kind", RULE_CASES,
                         ids=["/".join(c[0]) for c in RULE_CASES])
def test_sharding_rules_match_reference(path, ndim, kind):
    """Both rule functions give the reference's placement: the flax-path
    ``ulip_param_spec`` and the port-name ``param_spec`` (a flax
    ``embedding`` is a port ``weight`` of an ``nn.Embedding``)."""
    from ppt_tpu.parallel.sharding import ulip_param_spec as jax_rule

    leaf = np.zeros((8,) * ndim)
    assert jax_rule(path, leaf) == _jax_spec(kind)
    assert tsharding.ulip_param_spec(path, leaf) == _port_spec(kind)
    name = port_name(path)
    assert tsharding.param_spec(name, torch.zeros((8,) * ndim),
                                embedding=path[-1] == "embedding") == _port_spec(kind)


def test_flagship_tree_placements_match_reference():
    """Over the whole tiny flagship tree, leaf for leaf: the port's
    placements are the reference's; every sharded kernel is in a
    transformer block and column and row counts pair up."""
    from flax import traverse_util
    from jax.sharding import PartitionSpec as P

    from __graft_entry__ import _flagship
    from ppt_tpu.parallel.sharding import ulip_param_spec as jax_rule

    jmodel, jprompts = _flagship(tiny=True)
    variables = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((2, 64, 3)),
                               jprompts)  # the shapes are what the rules read
    model, _ = workers.build_ulip(dict(point=TINY, text=TEXT, classes=modelnet40(), n_ctx=4,
                                       class_name_position="middle"), "cpu")
    specs = tsharding.model_specs(model)
    col = row = 0
    for path, leaf in traverse_util.flatten_dict(variables["params"]).items():
        want = jax_rule(path, leaf)
        got = specs[port_name(path)]
        assert got == {P(None, "model"): _port_spec("column"), P("model", None):
                       _port_spec("row"), P(): _port_spec("replicated")}[want], path
        if want != P():
            assert any(p.startswith("block_") for p in path) or path[-1] == "embedding", path
        col += want == P(None, "model") and path[-1] == "kernel"
        row += want == P("model", None)
    assert set(specs) == {port_name(p) for p in traverse_util.flatten_dict(variables["params"])}
    assert col > 0 and col == row


SLURM_CASES = [("tpu-host001", "tpu-host001"), ("nodeA,nodeB", "nodeA"),
               ("node[01-04]", "node01"), ("node[01-04,07],other", "node01"),
               ("node[3,5]", "node3"), ("a[1-2],b[3-4]", "a1"), ("", "")]


@pytest.mark.parametrize("nodelist,want", SLURM_CASES)
def test_first_slurm_node_matches_reference(nodelist, want):
    from ppt_tpu.parallel.mesh import _first_slurm_node

    assert tmesh._first_slurm_node(nodelist) == _first_slurm_node(nodelist) == want


def test_mesh_devices_is_the_world_or_zero():
    """Without a process group ``mesh_devices`` 0 or 1 is one process and
    more raises by name; the config reader takes the key."""
    from ppt_torch.tasks.args import TaskArgs, parse_args

    assert tmesh.task_mesh(TaskArgs(mesh_devices=0)) is None
    assert tmesh.task_mesh(TaskArgs(mesh_devices=1)) is None
    with pytest.raises(ValueError, match="mesh_devices=2 needs 2 ranks"):
        tmesh.task_mesh(TaskArgs(mesh_devices=2))
    assert parse_args(["--mesh_devices", "4"]).mesh_devices == 4


# ---------------------------------------------------------------------------
# The JAX side and the spawned group
# ---------------------------------------------------------------------------


def _jax_cls(classes, cfg, partseg=False):
    from ppt_tpu.models import PromptArrays, Ulip
    from ppt_tpu.nn import PointBert, PointBertConfig, TextConfig
    from ppt_tpu.nn.pointbert import PointBertPartSeg
    from ppt_tpu.prompt import build_prompt_spec

    pcfg = PointBertConfig(**cfg)
    prompts = PromptArrays.from_spec(build_prompt_spec(classes, n_ctx=4,
                                                       class_name_position="middle"))
    model = Ulip(point_encoder=PointBertPartSeg(pcfg) if partseg else PointBert(pcfg),
                 pc_feat_dims=128 if partseg else 2 * pcfg.trans_dim, n_ctx=4,
                 text_config=TextConfig(**TEXT), task="partseg" if partseg else "cls")
    return model, prompts


def _init(model, *args, **kw):
    """``model.init`` under ``jit`` (eager init of these towers takes ~20 s
    on the CPU), as numpy trees."""
    return np_tree(jax.jit(lambda key, *a: model.init(key, *a, **kw))(*args))


def _state_dict(spec, variables):
    model, _ = workers.build_ulip(spec, "cpu")
    return from_jax(np_tree(variables["params"]), np_tree(variables.get("batch_stats", {})),
                    model)


def _jax_step(model, variables, mask, batch, prompts, mesh, partseg=False, tp=False):
    import optax

    from ppt_tpu.parallel import replicate, shard_batch
    from ppt_tpu.parallel.sharding import shard_params
    from ppt_tpu.train import create_train_state, make_train_step

    opt = optax.sgd(LR)
    v = jax.tree_util.tree_map(jnp.asarray, variables)
    state = create_train_state(v, mask, opt, jax.random.PRNGKey(7))
    if tp:
        state = state.replace(trainable=shard_params(state.trainable, mesh),
                              frozen=shard_params(state.frozen, mesh))
        state = state.replace(opt_state=jax.jit(opt.init)(state.trainable))
    else:
        state = replicate(state, mesh)
    step = make_train_step(model, opt, smoothing=0.2, partseg=partseg)
    s, m = step(state, shard_batch({k: jnp.asarray(x) for k, x in batch.items()}, mesh),
                replicate(prompts, mesh))
    return {"loss": float(m["loss"]), "acc": float(m["acc"]),
            "trainable": {port_name(k): v for k, v in flat(np_tree(s.trainable)).items()},
            "stats": {port_name(k, True): v for k, v in flat(np_tree(s.batch_stats)).items()}}


def _path_mask(params, prefixes):
    from flax import traverse_util

    return traverse_util.unflatten_dict({
        p: any(".".join(p).startswith(x) for x in prefixes)
        for p in traverse_util.flatten_dict(params)})


@pytest.fixture(scope="module")
def dryrun():
    """``python -m ppt_torch.parallel.dryrun --nproc 4 --device cpu``,
    started before the group's JAX side so that the two overlap."""
    proc = subprocess.Popen([sys.executable, "-m", "ppt_torch.parallel.dryrun", "--nproc", "4",
                             "--device", "cpu", "--timeout", "300"], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        yield proc
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def group(tmp_path_factory, dryrun):
    """Build every job's weights and inputs, start the two ranks, run the
    JAX side meanwhile, then collect both."""
    from flax import linen as fnn
    from jax.sharding import Mesh

    from ppt_tpu.models import trainable_mask as jax_mask
    from ppt_tpu.nn import PointBert, PointBertConfig
    from ppt_tpu.parallel import create_mesh
    from ppt_tpu.parallel.pipeline import (pipelined_partseg_features,
                                           pipelined_trunk_features)

    rs = np.random.RandomState(0)
    B = 4
    jobs, jax_out = [], {}
    mesh2 = create_mesh(2)

    # recognition: the prompt and the last block train
    classes = modelnet40()[:10]
    jmodel, jprompts = _jax_cls(classes, TINY)
    cls_batch = {"pc": rs.rand(B, 128, 3).astype(np.float32),
                 "label": rs.randint(0, len(classes), B).astype(np.int32)}
    cls_vars = _init(jmodel, jax.random.PRNGKey(0), jnp.asarray(cls_batch["pc"][:2]), jprompts)
    spec = dict(point=TINY, text=TEXT, classes=classes, n_ctx=4, class_name_position="middle")
    spec["state_dict"] = _state_dict(spec, cls_vars)
    train = ["prompt_learner", "point_encoder.block_1"]
    jobs.append(dict(kind="step", name="cls", model=spec, batch=cls_batch, trainable=train,
                     lr=LR, mesh=dict(axes=("data",), shape=(2,))))
    jobs.append(dict(jobs[-1], name="tp", mesh=dict(axes=("data", "model"), shape=(1, 2))))

    # part segmentation at head type 0: the prompt and the heads train
    smodel, sprompts = _jax_cls(PARTS, SEG, partseg=True)
    seg_batch = {"pc": rs.rand(B, 512, 3).astype(np.float32),
                 "label": rs.randint(0, len(PARTS), (B, 512)).astype(np.int32),
                 "cls_onehot": np.eye(16, dtype=np.float32)[rs.randint(0, 16, B)]}
    seg_vars = _init(smodel, jax.random.PRNGKey(1), jnp.asarray(seg_batch["pc"][:2]), sprompts,
                     cls_onehot=jnp.asarray(seg_batch["cls_onehot"][:2]))
    sspec = dict(point=SEG, text=TEXT, classes=PARTS, n_ctx=4, class_name_position="middle",
                 task="partseg")
    sspec["state_dict"] = _state_dict(sspec, seg_vars)
    jobs.append(dict(kind="step", name="partseg", model=sspec, batch=seg_batch, task="partseg",
                     head_type=0, lr=LR, dropout=False, mesh=dict(axes=("data",), shape=(2,))))

    # ULIP pretraining (the recognition model's weights): the point tower,
    # pc_projection and logit_scale train
    pmodel, pre_vars = jmodel, cls_vars
    pc = rs.rand(B, 64, 3).astype(np.float32)
    tokens = np.zeros((B, 77), dtype=np.int32)
    tokens[:, 0], tokens[:, 1], tokens[:, 2] = 49406, 320 + np.arange(B), 49407
    jobs.append(dict(kind="pretrain", name="pretrain", model=spec,
                     batch={"pc": pc, "tokens": tokens}, lr=LR,
                     mesh=dict(axes=("data",), shape=(2,))))

    # the pipeline: the trunk (the reference's CFG) and the partseg trunk
    pts = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (8, 128, 3)))
    trunk = PointBert(PointBertConfig(**CFG))
    trunk_vars = _init(trunk, jax.random.PRNGKey(0), jnp.asarray(pts), train=False)
    tspec = dict(point=CFG, text=TEXT, classes=["a"], n_ctx=4)
    tenc, _ = workers.build_ulip(tspec, "cpu")
    jobs.append(dict(kind="pipeline", name="pp_trunk", model=tspec, batch={"pc": pts},
                     encoder_state=from_jax(trunk_vars["params"], trunk_vars["batch_stats"],
                                            tenc.point_encoder),
                     mesh=dict(axes=("data", "pipe"), shape=(1, 2))))
    # 512 distinct points of the 1/64 lattice: every distance is exact in f32
    # on both sides, so the 3-NN weights and the EdgeConv neighbours agree
    grid = np.stack(np.meshgrid(*[np.arange(16)] * 3, indexing="ij"), -1).reshape(-1, 3)
    seg_pts = np.stack([grid[rs.choice(len(grid), 512, replace=False)]
                        for _ in range(B)]).astype(np.float32) / 64
    onehot = np.eye(16, dtype=np.float32)[np.arange(B) % 16]
    pseg_vars = {"params": seg_vars["params"]["point_encoder"],  # the partseg model's tower
                 "batch_stats": seg_vars["batch_stats"]["point_encoder"]}
    psspec = dict(point=SEG, text=TEXT, classes=["a"], n_ctx=4, task="partseg")  # the tower only
    psenc, _ = workers.build_ulip(psspec, "cpu")
    jobs.append(dict(kind="pipeline", name="pp_partseg", model=psspec,
                     batch={"pc": seg_pts, "cls_onehot": onehot}, n_micro=2,
                     encoder_state=from_jax(pseg_vars["params"], pseg_vars["batch_stats"],
                                            psenc.point_encoder),
                     grad_names=["block_0.attn.qkv.kernel"],
                     mesh=dict(axes=("data", "pipe"), shape=(1, 2))))
    jobs.append(dict(kind="refusals", name="refusals", model=dict(point=CFG), bad_depth=5,
                     batch={"pc": pts}, mesh=dict(axes=("data", "pipe"), shape=(1, 2))))

    # the port's own one-process steps on the same weights and inputs, and
    # the self-supervised stages, whose draws the two packages cannot share
    for name in ("cls", "partseg"):
        jobs.append(dict(next(j for j in jobs if j["name"] == name), name=f"{name}_one",
                         mesh=None))
    seg_one = next(j for j in jobs if j["name"] == "partseg_one")
    perm = np.roll(np.arange(B), B // 2)  # the control: the rows in another order
    jobs.append(dict(seg_one, name="partseg_perm",
                     batch={k: v[perm] for k, v in seg_one["batch"].items()}))
    seg_drop = dict(next(j for j in jobs if j["name"] == "partseg"), name="partseg_drop",
                    dropout=True)
    jobs += [seg_drop, dict(seg_drop, name="partseg_drop_one", mesh=None)]
    ss_pc = rs.rand(B, 128, 3).astype(np.float32)
    for stage, model in SELFSUP.items():
        jobs.append(dict(kind="selfsup", name=stage, model=model, batch={"pc": ss_pc}, lr=LR,
                         mesh=dict(axes=("data",), shape=(2,))))
        jobs.append(dict(jobs[-1], name=f"{stage}_one", mesh=None))

    run = launch.start("ppt_torch.parallel.workers:run_jobs", 2, {"jobs": jobs},
                       workdir=str(tmp_path_factory.mktemp("group")), timeout=600)

    jax_out["cls"] = _jax_step(jmodel, cls_vars, _path_mask(cls_vars["params"], train),
                               cls_batch, jprompts, mesh2)
    jax_out["tp"] = _jax_step(
        jmodel, cls_vars, _path_mask(cls_vars["params"], train), cls_batch, jprompts,
        create_mesh(2, axis_names=("data", "model"), shape=(1, 2)), tp=True)

    class Keep(fnn.Module):  # both packages' head dropout as the identity
        rate: float

        @fnn.compact
        def __call__(self, x, deterministic=True):
            return x

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn, "Dropout", Keep)
        jax_out["partseg"] = _jax_step(
            smodel, seg_vars, jax_mask(seg_vars["params"], head_type=0, task="partseg"),
            seg_batch, sprompts, mesh2, partseg=True)
    jax_out["partseg"]["start"] = {port_name(k): v for k, v in flat(seg_vars["params"]).items()}

    import optax

    from ppt_tpu.parallel import replicate, shard_batch
    from ppt_tpu.tasks.pretrain import make_pretrain_step
    from ppt_tpu.train import create_train_state

    opt = optax.sgd(LR)
    state = create_train_state(jax.tree_util.tree_map(jnp.asarray, pre_vars),
                               jax_mask(pre_vars["params"], task="pretrain"), opt,
                               jax.random.PRNGKey(7))
    s, m = make_pretrain_step(pmodel, opt)(replicate(state, mesh2),
                                           shard_batch({"pc": jnp.asarray(pc)}, mesh2),
                                           shard_batch(jnp.asarray(tokens), mesh2))
    jax_out["pretrain"] = {
        "loss": float(m["loss"]), "pc_text_acc": float(m["pc_text_acc"]),
        "trainable": {port_name(k): v for k, v in flat(np_tree(s.trainable)).items()},
        "stats": {port_name(k, True): v for k, v in flat(np_tree(s.batch_stats)).items()}}

    pmesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "pipe"))
    tcfg, scfg = PointBertConfig(**CFG), PointBertConfig(**SEG)

    def trunk_loss(v):
        f = pipelined_trunk_features(v, jnp.asarray(pts), tcfg, pmesh)
        return jnp.sum(f ** 2), f

    def seg_loss(v):
        f = pipelined_partseg_features(v, jnp.asarray(seg_pts), jnp.asarray(onehot), scfg,
                                       pmesh, n_micro=2)
        return jnp.sum(f ** 2), f

    for name, fn, v in (("pp_trunk", trunk_loss, trunk_vars),
                        ("pp_partseg", seg_loss, pseg_vars)):
        v = jax.tree_util.tree_map(jnp.asarray, v)
        (_, feats), grads = jax.jit(jax.value_and_grad(fn, has_aux=True))(v)
        jax_out[name] = {"features": np.asarray(feats),
                         "grads": {port_name(k): g for k, g in
                                   flat(np_tree(grads["params"])).items()}}

    ranks = run.wait()
    return {"jax": jax_out, "port": ranks[0], "ranks": ranks, "seconds": run.seconds}


def _close_leaves(got, want, names, rtol, atol, what):
    assert names, what
    for k in names:
        np.testing.assert_allclose(np.asarray(got[k]), want[k], rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {k}")


def test_dp2_cls_step_matches_jax_mesh(group):
    got, want = group["port"]["cls"], group["jax"]["cls"]
    assert np.isfinite(want["loss"])
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["acc"], want["acc"], atol=1e-6)
    assert set(got["trainable"]) == set(want["trainable"])
    _close_leaves(got["trainable"], want["trainable"], list(want["trainable"]), 1e-4, 1e-5,
                  "cls params")
    _close_leaves(got["stats"], want["stats"], list(want["stats"]), 1e-4, 1e-5, "cls BN")


def test_dp2_partseg_step_matches_jax_mesh(group):
    got, want = group["port"]["partseg"], group["jax"]["partseg"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert set(got["trainable"]) == set(want["trainable"])
    _close_leaves(got["trainable"], want["trainable"], ["prompt_learner.learnable_tokens"],
                  1e-4, 1e-5, "partseg prompt")
    # sync-BN: every running statistic, the heads' included, is the global batch's
    _close_leaves(got["stats"], want["stats"], list(want["stats"]), 1e-4, 1e-5, "partseg BN")
    # the heads' leaves: within 5e-2 of their update's largest entry (the
    # module docstring says why)
    heads = [k for k in want["trainable"] if not k.startswith("prompt_learner")]
    assert heads
    for k in heads:
        update = want["trainable"][k] - want["start"][k]
        scale = float(np.max(np.abs(update)))
        diff = float(np.max(np.abs(np.asarray(got["trainable"][k]) - want["trainable"][k])))
        assert diff <= 5e-2 * scale + 1e-7, (k, diff, scale)


@pytest.mark.parametrize("name", ["cls", "partseg", "partseg_drop", "dvae", "mpm", "mae"])
def test_dp2_step_matches_one_process(group, name):
    """The dp = 2 step against the port's own step in one process, on the
    same weights and inputs: the parallelism apart from the two packages.
    The loss at rtol 1e-5, every running statistic and every updated leaf
    at the reference's rtol 1e-4 / atol 1e-5; but part segmentation's heads
    and the dVAE have kinks that another summation order of the same sums
    crosses: flax's fast variance E[x^2] - E[x]^2 in their norms cancels,
    the max over EdgeConv neighbours and the dVAE's Chamfer nearest points
    choose at near-ties. One process against itself with the batch's rows
    in another order (``partseg_perm``, printed) moves the heads' leaves as
    far as dp = 2 does. So each of their leaves with an update past
    rounding noise (its largest entry above 1e-6) is held within a relative
    L2 distance of 2e-2 of one process's update: a gradient missing a
    rank's half, or statistics missing the other rank's rows, lands at tens
    of percent. The rest
    (the biases just before a train-mode norm, whose updates are rounding
    noise of 1e-9) stay at the elementwise limit. ``partseg_drop`` keeps
    the head dropout live; the dVAE's Gumbel noise, MPM's group masks and
    DropPath, and MAE's masking noise are drawn at the global batch: each
    rank's rows of one process's draw."""
    got, want = group["port"][name], group["port"][f"{name}_one"]
    assert np.isfinite(want["loss"])
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert set(got["trainable"]) == set(want["trainable"]) and want["trainable"]
    assert want["stats"] and set(got["stats"]) == set(want["stats"])
    _close_leaves(got["stats"], {k: v.numpy() for k, v in want["stats"].items()},
                  list(want["stats"]), 1e-4, 1e-5, f"{name} BN")
    start = {}
    if name.startswith("partseg"):
        start = {k: group["jax"]["partseg"]["start"][k] for k in want["trainable"]
                 if not k.startswith("prompt_learner")}
    elif name == "dvae":
        start = {k: v.numpy() for k, v in want["start"].items()}
    def update_dist(other, k):
        w = want["trainable"][k].numpy()
        return float(np.linalg.norm(other["trainable"][k].numpy() - w)
                     / np.linalg.norm(w - start[k]))

    loose = [k for k in start
             if np.max(np.abs(want["trainable"][k].numpy() - start[k])) > 1e-6]
    for k in loose:
        assert update_dist(got, k) <= 2e-2, (k, update_dist(got, k))
    if loose:
        worst = max(update_dist(got, k) for k in loose)
        control = ""
        if name == "partseg":
            control = (", one process with its rows in another order "
                       f"{max(update_dist(group['port']['partseg_perm'], k) for k in loose):.2e}")
        print(f"{name}: dp = 2 against one process, largest relative L2 distance of a "
              f"leaf's update {worst:.2e} (limit 2e-2){control}")
    rest = [k for k in want["trainable"] if k not in loose]
    _close_leaves(got["trainable"], {k: v.numpy() for k, v in want["trainable"].items()},
                  rest, 1e-4, 1e-5, f"{name} params")


def test_dp2_pretrain_step_matches_jax_mesh(group):
    """The InfoNCE over the global batch: a loss over each rank's half would
    differ from the reference's (each half sees B/2 negatives)."""
    got, want = group["port"]["pretrain"], group["jax"]["pretrain"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["pc_text_acc"], want["pc_text_acc"], atol=1e-6)
    assert set(got["trainable"]) == set(want["trainable"])
    assert "point_encoder.encoder.conv1a.kernel" in got["trainable"]
    _close_leaves(got["trainable"], want["trainable"], list(want["trainable"]), 1e-4, 1e-5,
                  "pretrain params")
    _close_leaves(got["stats"], want["stats"], list(want["stats"]), 1e-4, 1e-5, "pretrain BN")


def test_tp2_step_matches_jax_shard_params(group):
    """The last block's qkv / fc1 column-sharded and proj / fc2 row-sharded
    over the 'model' axis, the text blocks and the token embedding too; the
    updated leaves gathered whole."""
    got, want = group["port"]["tp"], group["jax"]["tp"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert "point_encoder.block_1.attn.qkv.kernel" in got["trainable"]
    _close_leaves(got["trainable"], want["trainable"], list(want["trainable"]), 1e-4, 1e-5,
                  "tp params")
    _close_leaves(got["stats"], want["stats"], list(want["stats"]), 1e-4, 1e-5, "tp BN")


@pytest.mark.parametrize("name,feat_atol,grad_rtol", [("pp_trunk", 2e-5, 5e-5),
                                                       ("pp_partseg", 5e-5, 1e-4)])
def test_pp2_features_and_grads_match_jax(group, name, feat_atol, grad_rtol):
    """The GPipe trunk (2 stages, 2 microbatches) and, for partseg, the taps
    of blocks 3, 7 and 11 broadcast from their stages; the gradient of
    sum(features**2) through the stages back into the embedding."""
    got, want = group["port"][name], group["jax"][name]
    assert got["features"].shape == want["features"].shape
    np.testing.assert_allclose(got["features"].numpy(), want["features"], atol=feat_atol)
    names = list(got["grads"])
    assert "block_0.attn.qkv.kernel" in names
    for k in names:
        w = want["grads"][k]
        scale = max(float(np.max(np.abs(w))), 1e-6)
        assert scale > 1e-4 or name == "pp_trunk", k
        np.testing.assert_allclose(got["grads"][k].numpy(), w, atol=grad_rtol * scale,
                                   err_msg=f"{name}: {k}")


def test_stack_vit_blocks_shapes():
    """The reference's ``test_stack_vit_blocks_shapes``: each block leaf on
    a leading depth axis, block 2's slice its own."""
    from ppt_torch.parallel.pipeline import stack_vit_blocks

    model, _ = workers.build_ulip(dict(point=CFG, text=TEXT, classes=["a"], n_ctx=4), "cpu")
    encoder = model.point_encoder
    stacked = stack_vit_blocks(encoder)
    k = stacked["attn.qkv.kernel"]
    assert k.shape == (CFG["depth"], CFG["trans_dim"], 3 * CFG["trans_dim"])
    assert torch.equal(k[2], encoder.block_2.attn.qkv.kernel)
    assert set(stacked) == {n for n, _ in encoder.block_0.named_parameters()}


REFUSALS = [r"depth 5 not divisible by pp=2", r"not divisible by n_micro",
            r"has no 'pp' axis", r"pass dp_axis=None"]


@pytest.mark.parametrize("i,pattern", list(enumerate(REFUSALS)))
def test_run_pipelined_refuses_by_name(group, i, pattern):
    """The reference's four ValueErrors, provoked as its
    ``test_validation_errors`` does (the bad depth odd, for two stages)."""
    assert re.search(pattern, group["port"]["refusals"][i]), group["port"]["refusals"][i]


def test_both_ranks_agree(group):
    """Every rank ends the steps with the same numbers: the losses, the
    whole updated leaves, the features."""
    r0, r1 = group["ranks"]
    for name in ("cls", "tp", "partseg", "partseg_drop", "pretrain", "dvae", "mpm", "mae"):
        assert r0[name]["loss"] == r1[name]["loss"], name
        for k, v in r0[name]["trainable"].items():
            assert torch.equal(v, r1[name]["trainable"][k]), (name, k)
    for name in ("pp_trunk", "pp_partseg"):
        assert torch.equal(r0[name]["features"], r1[name]["features"]), name


def test_loader_strides_and_reduced_loss_two_processes(tmp_path):
    """``tests/test_multihost.py`` on the port: two processes brought up by
    ``PPT_COORDINATOR``; the loader's default striding gives disjoint halves
    that cover the batch, and the reduced loss is equal on both ranks."""
    env = {"PPT_COORDINATOR": f"file://{tmp_path / 'rendezvous'}", "PPT_NUM_PROCESSES": "2"}
    runs = [launch.start("ppt_torch.parallel.workers:loader_job", 1, None,
                         workdir=str(tmp_path / f"r{r}"), init=False, timeout=120,
                         env=dict(env, PPT_PROCESS_ID=str(r)))
            for r in range(2)]
    r0, r1 = sorted((run.wait()[0] for run in runs), key=lambda o: o["rank"])
    assert (r0["rank"], r1["rank"]) == (0, 1) and r0["distributed"] and r0["world"] == 2
    assert not set(r0["local"]) & set(r1["local"])
    assert sorted(r0["local"] + r1["local"]) == sorted(r0["global"]) == list(range(8))
    assert r0["loss"] == r1["loss"] == float(sum(r0["global"]))


def test_dryrun_four_ranks_on_the_cpu(dryrun):
    """``python -m ppt_torch.parallel.dryrun --nproc 4 --device cpu``: cls
    at dp=2 x tp=2, partseg and pretrain at dp=4, the pipeline at dp=2 x
    pp=2, each against one process."""
    stdout, stderr = dryrun.communicate(timeout=400)
    assert dryrun.returncode == 0, stdout[-3000:] + stderr[-3000:]
    lines = stdout.strip().splitlines()
    assert any("cls mesh=(dp=2, tp=2)" in ln for ln in lines), lines
    assert any("pipeline mesh=(dp=2, pp=2)" in ln for ln in lines), lines
    assert lines[-1] == "dryrun(4): cls+partseg+pretrain+pipeline all ok"


_LOADER = r"""
import pathlib, sys
from ppt_torch.kernels import _build

root = pathlib.Path(sys.argv[1])
_build.CSRC, _build.BUILD_DIR = root / "csrc", root / "build"
_build.nvcc_path = lambda: str(root / "nvcc")


class Lib:  # ctypes.CDLL's stand-in: the library must be whole when it is loaded
    def __init__(self, path):
        data = pathlib.Path(path).read_bytes()
        assert data == bytes(range(256)) * 4096, (path, len(data))
        self.ppt_error_string = lambda rc: b""


_build.ctypes.CDLL = Lib
_build.load("fake")
print("loaded")
"""

_NVCC = r"""#!{python}
import pathlib, sys, time
args = sys.argv[1:]
out = pathlib.Path(args[args.index("-o") + 1])
with open(pathlib.Path(__file__).parent / "calls.log", "a") as f:
    f.write(str(out) + "\n")
with open(out, "wb") as f:  # slowly, so that a second build would overlap it
    for _ in range(8):
        f.write(bytes(range(256)) * 512)
        f.flush()
        time.sleep(0.05)
"""


def test_two_processes_loading_a_stale_library_build_it_once(tmp_path):
    """Two processes that find ``libppt_fake.so`` stale at once: the build
    lock lets one ``nvcc`` (a stand-in script here) build it while the
    other waits, finds it fresh and only loads it; both load it whole."""
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "fake.cu").write_text("// a source newer than no library\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_NVCC.replace("{python}", sys.executable))
    nvcc.chmod(0o755)
    procs = [subprocess.Popen([sys.executable, "-c", _LOADER, str(tmp_path)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=60)
        assert p.returncode == 0 and out.strip() == "loaded", err[-2000:]
    assert len((tmp_path / "calls.log").read_text().splitlines()) == 1
    lib = tmp_path / "build" / "libppt_fake.so"
    assert lib.read_bytes() == bytes(range(256)) * 4096
    assert not list((tmp_path / "build").glob("*.tmp.so"))


def test_cls_driver_on_two_ranks_trains_as_one_process(tmp_path):
    """``cls.main`` under a two-rank group (``PPT_COORDINATOR``) at a shrunk
    PPT-Base with DropPath 0.1 and the driver's augmentation: every epoch's
    loss, train accuracy and validation accuracy equal one process's (each
    rank reads the global batch and keeps its half; the draws are one
    process's), and only rank 0 writes (one metrics line an epoch)."""
    from ppt_torch.nn.pointbert import PointBertConfig
    from ppt_torch.nn.text import TextConfig
    from ppt_torch.tasks import cls
    from ppt_torch.tasks.args import TaskArgs

    base = dict(num_learnable_prompt_tokens=4, class_name_position="middle",
                dataset_name="synthetic", npoints=128, batch_size=8, device="cpu",
                pretrained_dir="", epochs=2, label_smoothing=0.2)
    point = dict(TINY, drop_path_rate=0.1)
    extra = {"num_classes": 4, "samples_per_class": 6}
    payload = {"task": "cls", "args": dict(base, output_dir=str(tmp_path / "two")),
               "point": point, "text": TEXT, "extra": extra}
    env = {"PPT_COORDINATOR": f"file://{tmp_path / 'rendezvous'}", "PPT_NUM_PROCESSES": "2"}
    runs = [launch.start("ppt_torch.parallel.workers:task_job", 1, payload,
                         workdir=str(tmp_path / f"r{r}"), init=False, timeout=300,
                         env=dict(env, PPT_PROCESS_ID=str(r)))
            for r in range(2)]
    r0, r1 = sorted((run.wait()[0] for run in runs), key=lambda o: o["rank"])
    args = TaskArgs(**dict(base, output_dir=str(tmp_path / "one")))
    args.pointbert_config, args.text_config = PointBertConfig(**point), TextConfig(**TEXT)
    for k, v in extra.items():
        setattr(args, k, v)
    one = cls.main(args)["history"]
    assert (r0["world"], r1["world"]) == (2, 2)
    for h0, h1, h in zip(r0["history"], r1["history"], one):
        assert h0["loss"] == h1["loss"] and h0["val_acc1"] == h1["val_acc1"]
        np.testing.assert_allclose(h0["loss"], h["loss"], rtol=1e-5)
        np.testing.assert_allclose(h0["train_acc"], h["train_acc"], atol=1e-4)
        assert h0["val_acc1"] == h["val_acc1"]
    lines = (tmp_path / "two" / "cls" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 2 and (tmp_path / "two" / "cls" / "checkpoint_best.pt").exists()
