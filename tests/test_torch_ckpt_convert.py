"""Port vs reference: the ``.pt`` -> ``.msgpack`` checkpoint converter.

For each kind the port converts (slip, pointbert, pointbert_partseg,
pointnet2_ssg, pointnet2_msg, pointmlp, pointnext; pointnet, dgcnn,
balldgcnn, deepgcn, grouppointnet, simpleview; the scene backbones
pointtransformer, randlanet, baafnet), one seeded state dict
with the reference's parameter names goes through
``ppt_tpu.tools.ckpt_convert`` and ``ppt_torch.tools.ckpt_convert``: the
two ``.msgpack`` files must be equal byte for byte, and the port's msgpack
reader must decode the file to the arrays flax decodes, bit for bit. SLIP
and PointBERT take the reference tests' own makers
(``tests/test_ckpt_convert.py``) with every tensor redrawn from a seed, the
partseg kind PointBERT's with the segmentation heads added under the
reference's names; the others are written from the small
JAX model's variable tree by the inverse of the layout rules, so the
converted tree must also come back to that tree exactly (DGCNN's edge
kernels with their input halves swapped back, SimpleView's 3x3 kernels
from HWIO back to OIHW; the openpoints graph towers and SimpleView convert
at the tree's top level, without ``point_encoder`` or ``pc_projection``).
The scene backbones' state dicts come from their small JAX modules' trees
by the inverse of the integer folding (``enc1_1`` <- ``enc1.1``), and
their converted trees load into the port's modules through
``convert.from_jax``.
"""

import argparse
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization, traverse_util

from test_ckpt_convert import make_pointbert_state_dict, make_slip_state_dict

from ppt_torch.tools import ckpt_convert as tconv
from ppt_torch.utils.msgpack import msgpack_restore

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores

TINY_BERT = dict(trans_dim=64, depth=2, drop_path_rate=0.0, num_heads=2, group_size=8,
                 num_group=16, encoder_dims=64)
TEXT = dict(width=64, layers=2, heads=4, embed_dim=64)
MLP_SMALL = dict(points=64, embed_dim=16, k_neighbors=(8, 8, 8, 8))
EMBED = 64  # the joint space of the tiny models: pc_projection's width
# the scene backbones: their trees sit at the top level, built from the
# reference's test configs
SCENE = ("pointtransformer", "randlanet", "baafnet")
KINDS = ("slip", "pointbert", "pointbert_partseg", "pointnet2_ssg", "pointnet2_msg", "pointmlp",
         "pointnext", "pointnet", "dgcnn", "balldgcnn", "deepgcn", "grouppointnet",
         "simpleview") + SCENE
# the kinds whose tree sits at the top level (no point_encoder, no pc_projection)
BARE = ("balldgcnn", "deepgcn", "grouppointnet", "simpleview")


def redraw(sd, seed):
    """Every tensor of ``sd`` drawn anew from ``seed`` (variances positive)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in sd.items():
        t = torch.randn(v.shape, generator=g) * 0.05
        if k.endswith("running_var"):
            t = 0.5 + t.abs()
        out[k] = t.to(v.dtype) if v.is_floating_point() else v
    return out


def _tower(kind):
    """(flax module, sample input) of the tower a kind converts."""
    from ppt_tpu.nn.classic import DgcnnClassifier, PointNetEncoder
    from ppt_tpu.nn.gcn import BallDgcnn, DeepGcn, DeepGcnConfig, GroupPointNet
    from ppt_tpu.nn.pointmlp import PointMLP, PointMLPConfig
    from ppt_tpu.nn.pointnet2 import PointNet2Msg, PointNet2Ssg
    from ppt_tpu.nn.pointnext import PointNext, PointNextConfig
    from ppt_tpu.nn.simpleview import SimpleView, SimpleViewConfig

    return {"pointnet2_ssg": (PointNet2Ssg(), (1, 600, 3)),
            "pointnet2_msg": (PointNet2Msg(), (1, 600, 3)),
            "pointmlp": (PointMLP(PointMLPConfig(**MLP_SMALL)), (1, 64, 3)),
            "pointnext": (PointNext(PointNextConfig(in_channels=4)), (1, 64, 4)),
            # the reference's converter maps DGCNN's trunk up to the pooled
            # features, not the FC head: the tower without it
            "pointnet": (PointNetEncoder(), (1, 32, 3)),
            "dgcnn": (DgcnnClassifier(trunk=False), (1, 32, 3)),
            "balldgcnn": (BallDgcnn(), (1, 32, 3)),
            "deepgcn": (DeepGcn(DeepGcnConfig(n_blocks=4, k=4)), (1, 32, 3)),
            "grouppointnet": (GroupPointNet(), (1, 64, 3)),
            "simpleview": (SimpleView(SimpleViewConfig(channels=8, resolution=16)),
                           (1, 64, 3))}[kind]


# the inverse of the layout rules: a flax module path of the point tower
# (joined by "/") -> (the reference's module name, "conv" | "linear" | "bn")
_INVERSE = {
    "pointnet2": (
        (r"sa(\d)/conv(\d+)_(\d+)", r"sa\1.conv_blocks.\2.\3", "conv"),
        (r"sa(\d)/bn(\d+)_(\d+)", r"sa\1.bn_blocks.\2.\3", "bn"),
        (r"sa(\d)/conv(\d+)", r"sa\1.mlp_convs.\2", "conv"),
        (r"sa(\d)/bn(\d+)", r"sa\1.mlp_bns.\2", "bn"),
        (r"head/fc(\d)", r"fc\1", "linear"),
        (r"head/bn(\d)", r"bn\1", "bn"),
    ),
    "pointmlp": (
        (r"embedding/conv", "embedding.net.0", "conv"),
        (r"embedding/bn", "embedding.net.1", "bn"),
        (r"grouper(\d)", r"local_grouper_list.\1", "raw"),
        (r"pre(\d)/transfer/conv", r"pre_blocks_list.\1.transfer.net.0", "conv"),
        (r"pre(\d)/transfer/bn", r"pre_blocks_list.\1.transfer.net.1", "bn"),
        (r"(pre|pos)(\d)/res(\d)/conv(\d)", r"\1_blocks_list.\2.operation.\3.net\4.0", "conv"),
        (r"(pre|pos)(\d)/res(\d)/bn(\d)", r"\1_blocks_list.\2.operation.\3.net\4.1", "bn"),
        (r"fc1", "classifier.0", "linear"), (r"bn1", "classifier.1", "bn"),
        (r"fc2", "classifier.4", "linear"), (r"bn2", "classifier.5", "bn"),
    ),
    "pointnet": (
        (r"(f?stn)/conv(\d)", r"\1.conv\2", "conv"),
        (r"(f?stn)/fc(\d)", r"\1.fc\2", "linear"),
        (r"(f?stn)/bn(\d)", r"\1.bn\2", "bn"),
        (r"conv(\d_?\d?)", r"conv\1", "conv"),
        (r"bn(\d_?\d?)", r"bn\1", "bn"),
    ),
    "dgcnn": (
        (r"edge0", "head.gconv.nn.0", "edge"),
        (r"bn0", "head.gconv.nn.1", "bn"),
        (r"edge(\d)", lambda m: f"backbone.{int(m.group(1)) - 1}.gconv.nn.0", "edge"),
        (r"bn(\d)", lambda m: f"backbone.{int(m.group(1)) - 1}.gconv.nn.1", "bn"),
        (r"emb", "fusion_block.0", "conv"),
        (r"embn", "fusion_block.1", "bn"),
    ),
    # create_convblock's order: conv-act-norm keeps the norm at index 2,
    # conv-norm-act at 1
    "balldgcnn": (
        (r"edge0/conv", "head.gconv.nn.0", "conv"),
        (r"edge0/bn", "head.gconv.nn.2", "bn"),
        (r"edge(\d)/conv", lambda m: f"backbone.{int(m.group(1)) - 1}.gconv.nn.0", "conv"),
        (r"edge(\d)/bn", lambda m: f"backbone.{int(m.group(1)) - 1}.gconv.nn.2", "bn"),
        (r"fusion/conv", "fusion_block.0", "conv"),
        (r"fusion/bn", "fusion_block.2", "bn"),
    ),
    "deepgcn": (
        (r"edge0/conv", "head.gconv.nn.0", "conv"),
        (r"edge0/bn", "head.gconv.nn.1", "bn"),
        (r"edge(\d+)/conv", lambda m: f"backbone.{int(m.group(1)) - 1}.body.gconv.nn.0",
         "conv"),
        (r"edge(\d+)/bn", lambda m: f"backbone.{int(m.group(1)) - 1}.body.gconv.nn.1", "bn"),
        (r"fusion/conv", "fusion_block.0", "conv"),
        (r"fusion/bn", "fusion_block.1", "bn"),
    ),
    "grouppointnet": (
        (r"conv(\d)/conv", r"backbone.\1.0", "conv"),
        (r"conv(\d)/bn", r"backbone.\1.2", "bn"),
    ),
    "simpleview": (
        (r"stem_conv", "img_model.0", "conv2d"),
        (r"stem_bn", "img_model.1", "bn"),
        (r"backbone/layer(\d)_(\d)/(conv\d)",
         lambda m: f"img_model.{int(m.group(1)) + 2}.{m.group(2)}.{m.group(3)}", "conv2d"),
        (r"backbone/layer(\d)_(\d)/(bn\d)",
         lambda m: f"img_model.{int(m.group(1)) + 2}.{m.group(2)}.{m.group(3)}", "bn"),
        (r"backbone/layer(\d)_(\d)/ds_conv",
         lambda m: f"img_model.{int(m.group(1)) + 2}.{m.group(2)}.downsample.0", "conv2d"),
        (r"backbone/layer(\d)_(\d)/ds_bn",
         lambda m: f"img_model.{int(m.group(1)) + 2}.{m.group(2)}.downsample.1", "bn"),
        (r"fc_bn0", "final_fc.model.0.bn", "bn"),
        (r"fc1", "final_fc.model.3", "linear"),
        (r"fc_bn1", "final_fc.model.4", "bn"),
        (r"fc2", "final_fc.model.7", "linear"),
    ),
    "pointnext": (
        (r"stem", "encoder.encoder.0.0.convs.0.0", "conv"),
        (r"stage(\d)_(?:sa|global)/conv(\d)/conv", r"encoder.encoder.\1.0.convs.\2.0", "conv"),
        (r"stage(\d)_(?:sa|global)/conv(\d)/bn", r"encoder.encoder.\1.0.convs.\2.1", "bn"),
        (r"stage(\d)_sa/skipconv", r"encoder.encoder.\1.0.skipconv.0", "conv"),
        (r"head_fc0", "prediction.head.0.0", "linear"),
        (r"head_bn0", "prediction.head.0.1", "bn"),
        (r"head_fc1", "prediction.head.2.0", "linear"),
        (r"head_bn1", "prediction.head.2.1", "bn"),
    ),
}


def _scene(kind):
    """(flax module, port module, sample input shapes) of a scene backbone
    at the reference tests' small configs."""
    from ppt_tpu.nn import (BaafNet, BaafNetConfig, PointTransformerConfig,
                            PointTransformerSeg, RandLANet, RandLANetConfig)

    from ppt_torch.nn import baafnet as tbf
    from ppt_torch.nn import pointtransformer as tpt
    from ppt_torch.nn import randlanet as trl

    pt = dict(blocks=(2, 2, 2, 2, 2), width=8, nsample=(4, 4, 4, 4, 2), in_channels=3,
              num_classes=13)
    baaf = dict(n_points=256, ds_ratio=4, k=4, num_classes=5, dims=(3, 4, 8, 16, 32))
    return {"pointtransformer": (PointTransformerSeg(PointTransformerConfig(**pt)),
                                 tpt.PointTransformerSeg(tpt.PointTransformerConfig(**pt)),
                                 [(2, 512, 3)]),
            "randlanet": (RandLANet(RandLANetConfig(d_in=6, num_classes=6, num_neighbors=4)),
                          trl.RandLANet(trl.RandLANetConfig(d_in=6, num_classes=6,
                                                            num_neighbors=4)),
                          [(1, 256, 6)]),
            "baafnet": (BaafNet(BaafNetConfig(**baaf)), tbf.BaafNet(tbf.BaafNetConfig(**baaf)),
                        [(1, 256, 3), (1, 256, 3)])}[kind]


def tower_variables(kind, seed=0):
    """The flax tree (``params``, ``batch_stats``) of the kind's small
    tower under ``point_encoder``, with ``pc_projection`` (a scene backbone's
    and a bare kind's at the top level), drawn from ``seed``; shapes from
    ``jax.eval_shape``, nothing compiled."""
    if kind in SCENE:
        module, _, shapes_in = _scene(kind)
    else:
        module, shape = _tower(kind)
        shapes_in = [shape]
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            *[jnp.zeros(sh) for sh in shapes_in])
    rng = np.random.RandomState(seed)
    prefix = () if kind in BARE + SCENE else ("point_encoder",)
    out = {}
    for coll in ("params", "batch_stats"):
        flat = {}
        for path, leaf in traverse_util.flatten_dict(shapes[coll]).items():
            v = (0.05 * rng.randn(*leaf.shape)).astype(np.float32)
            flat[prefix + path] = 0.5 + np.abs(v) if path[-1] == "var" else v
        out[coll] = flat
    if prefix:
        out["params"][("pc_projection",)] = (0.05 * rng.randn(256, EMBED)).astype(np.float32)
    return {k: traverse_util.unflatten_dict(v) for k, v in out.items()}


def scene_state_dict(kind, variables):
    """The reference-named torch state dict of a scene backbone whose
    conversion is ``variables``: each ``name_<k>`` segment unfolded to
    ``name.<k>``, BatchNorms with ``num_batches_tracked``; PTSeg's layers
    are Linears; RandLA-Net's SharedMLPs are 1x1 Conv2d (``batch_norm``,
    ``score_fn.0`` and ``fc_start`` Linears, ``bn_start.0``), its decoder's
    ConvTranspose2d ``[in, out, 1, 1]``; BAAF-Net's are 1x1 Conv2d, its
    decoders' ``conv_trans`` ConvTranspose1d ``[in, out, 1]``."""
    flat = traverse_util.flatten_dict(variables["params"])
    stats = traverse_util.flatten_dict(variables["batch_stats"])
    bns = {p[:-1] for p in stats}
    sd = {}
    for path, v in list(flat.items()) + [(p + ("@stat",), v) for p, v in stats.items()]:
        stat = path[-1] == "@stat"
        mods, leaf = list(path[:-2 if stat else -1]), path[-2 if stat else -1]
        trans = False
        if kind == "randlanet":
            trans = mods[0].startswith("decoder_")
            mods = ["batch_norm" if m == "bn" else m + "_0" if m in ("score_fn", "bn_start")
                    else m for m in mods]
        if kind == "baafnet" and mods[0].startswith("Decoder") and mods[-1] == "linear":
            trans, mods = True, mods[:-1] + ["conv_trans"]
        name = ".".join(re.sub(r"_(\d+)", r".\1", m) for m in mods)
        t = torch.from_numpy(np.ascontiguousarray(v))
        if tuple(path[:-2 if stat else -1]) in bns:
            key = {"scale": "weight", "bias": "bias", "mean": "running_mean",
                   "var": "running_var"}[leaf]
            sd[f"{name}.{key}"] = t
            sd.setdefault(f"{name}.num_batches_tracked", torch.tensor(3))
        elif leaf == "kernel":
            if trans:  # a transposed 1x1 convolution keeps [in, out]
                sd[f"{name}.weight"] = t[:, :, None, None] if kind == "randlanet" else t[:, :, None]
            elif kind == "pointtransformer" or mods[-1] in ("fc_start", "score_fn_0"):
                sd[f"{name}.weight"] = t.t().contiguous()
            else:
                sd[f"{name}.weight"] = t.t().contiguous()[:, :, None, None]
        else:
            sd[f"{name}.{leaf}"] = t
    return sd


def inverse_state_dict(kind, variables):
    """The reference-named torch state dict whose conversion is
    ``variables``."""
    if kind in SCENE:
        return scene_state_dict(kind, variables)
    rules = _INVERSE["pointnet2" if kind.startswith("pointnet2") else kind]
    if kind in BARE:
        sd, pe = {}, ""
        flat = traverse_util.flatten_dict(variables["params"])
        stats = traverse_util.flatten_dict(variables["batch_stats"])
    else:
        sd, pe = {"pc_projection": torch.from_numpy(variables["params"]["pc_projection"])}, \
            "point_encoder."
        flat = traverse_util.flatten_dict(variables["params"]["point_encoder"])
        stats = traverse_util.flatten_dict(variables["batch_stats"]["point_encoder"])
    seen = set()
    for path, v in list(flat.items()) + [(p + ("@stat",), v) for p, v in stats.items()]:
        stat = path[-1] == "@stat"
        mod, leaf = "/".join(path[:-2 if stat else -1]), path[-2 if stat else -1]
        for pattern, repl, what in rules:
            if re.fullmatch(pattern, mod):
                name = pe + re.sub(pattern, repl, mod)
                break
        else:
            raise KeyError(f"no inverse rule for {mod}")
        t = torch.from_numpy(np.ascontiguousarray(v))
        if what == "raw":
            sd[f"{name}.{leaf}"] = t
        elif what == "bn":
            key = {"scale": "weight", "bias": "bias", "mean": "running_mean",
                   "var": "running_var"}[leaf]
            sd[f"{name}.{key}"] = t
            if name not in seen:
                sd[f"{name}.num_batches_tracked"] = torch.tensor(7)
                seen.add(name)
        elif leaf == "kernel" and what == "edge":  # the input halves swapped back
            half = t.shape[0] // 2
            sd[f"{name}.weight"] = torch.cat([t[half:], t[:half]]).t().contiguous()[..., None,
                                                                                    None]
        elif leaf == "kernel" and what == "conv2d":  # HWIO -> OIHW
            sd[f"{name}.weight"] = t.permute(3, 2, 0, 1).contiguous()
        elif leaf == "kernel":
            w = t.t().contiguous()
            sd[f"{name}.weight"] = w if what == "linear" else w[:, :, None]
        else:
            sd[f"{name}.{leaf}"] = t
    return sd


def reference_state_dict(kind, seed=0):
    """A seeded state dict of the reference's names for ``kind``, at the
    small widths the tests build."""
    from ppt_tpu.nn import PointBertConfig

    if kind == "slip":
        sd = redraw(make_slip_state_dict(width=TEXT["width"], layers=TEXT["layers"],
                                         heads=TEXT["heads"]), seed)
        sd["text_projection"] = torch.randn(TEXT["width"], EMBED,
                                            generator=torch.Generator().manual_seed(seed))
        sd["logit_scale"] = torch.tensor(float(np.log(1 / 0.07)) + 0.25)
        return sd
    if kind == "pointbert":
        sd = redraw(make_pointbert_state_dict(PointBertConfig(**TINY_BERT)), seed)
        sd["pc_projection"] = torch.randn(2 * TINY_BERT["trans_dim"], EMBED,
                                          generator=torch.Generator().manual_seed(seed + 1))
        return sd
    if kind == "pointbert_partseg":
        return partseg_state_dict(seed)
    return inverse_state_dict(kind, tower_variables(kind, seed))


def partseg_state_dict(seed):
    """The PointBERT state dict with the partseg trunk's heads under the
    reference's names (``point_encoder.py:260-420``): ``propagation_{0,1,2}``
    (``mlp_convs`` Conv1d, ``mlp_bns``), ``dgcnn_pro_{1,2}`` (``layer{1,2}.0``
    Conv2d without bias, ``layer{1,2}.1`` GroupNorm) and ``conv1`` / ``bn1``,
    at the small trunk's width, every tensor drawn from ``seed``."""
    C = TINY_BERT["trans_dim"]
    sd = reference_state_dict("pointbert", seed)
    sd["pc_projection"] = torch.randn(128, EMBED)
    pe = "point_encoder."

    def bn(name, n):
        sd.update({f"{name}.weight": torch.ones(n), f"{name}.bias": torch.zeros(n),
                   f"{name}.running_mean": torch.zeros(n), f"{name}.running_var": torch.ones(n),
                   f"{name}.num_batches_tracked": torch.tensor(0)})

    for j, cin in ((0, 16 + 3 + C), (1, 3 + C), (2, 3 + C)):
        for i, (a, b) in enumerate(((cin, 4 * C), (4 * C, C))):
            sd[f"{pe}propagation_{j}.mlp_convs.{i}.weight"] = torch.zeros(b, a, 1)
            sd[f"{pe}propagation_{j}.mlp_convs.{i}.bias"] = torch.zeros(b)
            bn(f"{pe}propagation_{j}.mlp_bns.{i}", b)
    for j in (1, 2):
        for k, (a, b) in enumerate(((2 * C, 512), (1024, C)), 1):
            sd[f"{pe}dgcnn_pro_{j}.layer{k}.0.weight"] = torch.zeros(b, a, 1, 1)
            sd[f"{pe}dgcnn_pro_{j}.layer{k}.1.weight"] = torch.ones(b)
            sd[f"{pe}dgcnn_pro_{j}.layer{k}.1.bias"] = torch.zeros(b)
    sd[f"{pe}conv1.weight"] = torch.zeros(128, C, 1)
    sd[f"{pe}conv1.bias"] = torch.zeros(128)
    bn(f"{pe}bn1", 128)
    return redraw(sd, seed + 2)


def save_pt(path, sd, module_prefix=False, state_key="state_dict"):
    """A ``.pt`` file as ULIP writes one: the state dict beside a pickled
    ``argparse.Namespace``."""
    if module_prefix:
        sd = {"module." + k: v for k, v in sd.items()}
    torch.save({state_key: sd, "args": argparse.Namespace(model="x", lr=1e-3)} if state_key
               else sd, path)
    return str(path)


@pytest.mark.parametrize("kind", KINDS)
def test_port_writes_the_reference_file_byte_for_byte(kind, tmp_path):
    from ppt_tpu.tools.ckpt_convert import convert_file as jax_convert_file

    sd = reference_state_dict(kind)
    # DataParallel's prefix on two kinds, a bare state dict on one
    src = save_pt(tmp_path / "in.pt", sd, module_prefix=kind in ("pointmlp", "slip"),
                  state_key="" if kind == "pointnext" else "state_dict")
    jax_convert_file(src, kind, str(tmp_path / "ref.msgpack"))
    tconv.main(["--src", src, "--kind", kind, "--out", str(tmp_path / "port.msgpack")])
    ref = (tmp_path / "ref.msgpack").read_bytes()
    port = (tmp_path / "port.msgpack").read_bytes()
    assert port == ref
    # the port's reader decodes the file to flax's arrays, bit for bit
    assert_same_tree(msgpack_restore(port), serialization.msgpack_restore(ref))


def assert_same_tree(got, want, path=()):
    """Equal nesting, keys, dtypes, shapes and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            assert_same_tree(got[k], want[k], path + (k,))
        return
    assert got.dtype == want.dtype and got.shape == want.shape, path
    np.testing.assert_array_equal(got, want, err_msg=str(path))


@pytest.mark.parametrize("kind", ("pointnet2_ssg", "pointnet2_msg", "pointmlp", "pointnext",
                                  "pointnet", "dgcnn", "balldgcnn", "deepgcn", "grouppointnet",
                                  "simpleview") + SCENE)
def test_conversion_inverts_the_tower_tree(kind):
    """The converter maps the inverse-written state dict back onto the
    small JAX tower's own tree, leaf for leaf, batch statistics included."""
    variables = tower_variables(kind, seed=3)
    tree = tconv.CONVERTERS[kind](inverse_state_dict(kind, variables))
    for coll in ("params", "batch_stats"):
        want = traverse_util.flatten_dict(variables[coll])
        got = traverse_util.flatten_dict(tree[coll])
        assert set(got) == set(want), coll
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=str(k))


def test_kinds_the_port_lacks_are_not_choices(tmp_path, capsys):
    """The port offers every kind of the reference's converter (the scene
    backbones' since they were ported), and no other."""
    from ppt_tpu.tools.ckpt_convert import CONVERTERS as JAX_CONVERTERS

    assert set(tconv.CONVERTERS) == set(KINDS) == set(JAX_CONVERTERS)
    with pytest.raises(SystemExit):
        tconv.main(["--src", "x.pt", "--kind", "stratified", "--out", str(tmp_path / "o")])
    assert "invalid choice" in capsys.readouterr().err


@pytest.mark.parametrize("kind", SCENE)
def test_scene_kinds_load_into_the_port_modules(kind):
    """A scene backbone's converted tree loads into the port's module
    through ``convert.from_jax``, every parameter and statistic set, each
    equal to its leaf."""
    from ppt_torch.convert import from_jax

    tree = tconv.CONVERTERS[kind](scene_state_dict(kind, tower_variables(kind, seed=4)))
    port = _scene(kind)[1]
    port.load_state_dict(from_jax(tree["params"], tree["batch_stats"], port))
    got = port.state_dict()
    for coll in ("params", "batch_stats"):
        for path, v in traverse_util.flatten_dict(tree[coll]).items():
            leaf = {"scale": "weight", "mean": "running_mean", "var": "running_var"}.get(
                path[-1], path[-1])
            key = ".".join(path[:-1] + (leaf,))
            np.testing.assert_array_equal(got[key].numpy(), v, err_msg=key)
