"""Convert the reference's PyTorch checkpoints into the loader's files.

Counterpart of ``ppt_tpu/tools/ckpt_convert.py`` for the towers the port
has. Inputs are the ``.pt`` files PPT downloads
(``models/ULIP_models.py:472-507``): ``slip_base_100ep.pt`` (the SLIP/CLIP
text tower, its visual tower ignored), ``pointbert(_ulip2).pt`` (the
ULIP-pretrained PointBERT, with ``pc_projection`` and ``logit_scale``; kind
``pointbert_partseg`` for a part-segmentation checkpoint), ``pointnet2_ssg.pt``,
``pointnet2_msg_1kpts.pt``, ``pointmlp.pt`` and PointNeXt-S's; and
openpoints' PointNet with T-Nets (``pointnet``), DGCNN (``dgcnn``),
BallDGCNN, DeepGCN, GroupPointNet and SimpleView checkpoints, and the
scene backbones' (``pointtransformer``, ``randlanet``, ``baafnet``). Each becomes
a ``<name>.msgpack`` file holding a flax-layout ``{"params": ...,
"batch_stats": ...}`` tree, byte for byte the file the reference's
converter writes. ``ppt_torch.train.checkpoint.load_pretrained_backbones``
reads the ULIP towers' files at task setup (as the reference's loader
does), so the port reads exactly the files users of the reference already
have, through one loader; neither loader names a file of the openpoints
kinds.

Layout rules, as the reference's:
  - ``Linear.weight [out, in]`` -> ``kernel [in, out]``;
  - ``Conv1d/2d(k=1).weight`` -> the spatial dims squeezed, then transposed;
  - a 3x3 ``Conv2d.weight [out, in, kh, kw]`` (SimpleView) -> HWIO;
  - BatchNorm ``weight``/``bias`` -> ``scale``/``bias`` params, and
    ``running_mean``/``running_var`` -> ``mean``/``var`` batch stats;
  - MultiheadAttention ``in_proj_weight`` -> the fused ``in_proj`` Dense;
  - a leading ``module.`` (DataParallel) is stripped.

The ``.pt`` file is read with ``torch.load(map_location="cpu",
weights_only=False)``, as the reference reads it: ULIP's checkpoints
pickle an ``argparse.Namespace`` beside the state dict, so the tool
UNPICKLES the file, which can run code from it. Convert only files from a
source you trust.

Usage:
  python -m ppt_torch.tools.ckpt_convert --src data/initialize_models/slip_base_100ep.pt \
      --kind slip --out data/pretrained_models/slip_text.msgpack
  python -m ppt_torch.tools.ckpt_convert --src pointbert.pt --kind pointbert \
      --out data/pretrained_models/pointbert.msgpack
"""

from __future__ import annotations

import argparse
import logging
import re
from typing import Any, Dict, Tuple

import numpy as np

import ppt_torch.utils.msgpack as flax_msgpack  # the port's own reader and writer

log = logging.getLogger(__name__)

Flat = Dict[Tuple[str, ...], np.ndarray]


def _t(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x)


def _unflatten(flat: Flat) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def _tree(p: Flat, s: Flat) -> Dict[str, Any]:
    return {"params": _unflatten(p), "batch_stats": _unflatten(s)}


def _linear(dst_params: Flat, path: Tuple[str, ...], w, b=None):
    dst_params[path + ("kernel",)] = _t(w).T
    if b is not None:
        dst_params[path + ("bias",)] = _t(b)


def _conv1x1(dst_params: Flat, path: Tuple[str, ...], w, b=None):
    w = _t(w)
    w = w.reshape(w.shape[0], w.shape[1])  # drop the k=1 spatial dims
    dst_params[path + ("kernel",)] = w.T
    if b is not None:
        dst_params[path + ("bias",)] = _t(b)


def _bn(dst_params: Flat, dst_stats: Flat, path: Tuple[str, ...], sd, src: str):
    dst_params[path + ("scale",)] = _t(sd[src + ".weight"])
    dst_params[path + ("bias",)] = _t(sd[src + ".bias"])
    dst_stats[path + ("mean",)] = _t(sd[src + ".running_mean"])
    dst_stats[path + ("var",)] = _t(sd[src + ".running_var"])


def _ln(dst_params: Flat, path: Tuple[str, ...], sd, src: str):
    dst_params[path + ("scale",)] = _t(sd[src + ".weight"])
    dst_params[path + ("bias",)] = _t(sd[src + ".bias"])


def _strip_module(sd: Dict[str, Any]) -> Dict[str, Any]:
    return {k.replace("module.", "", 1) if k.startswith("module.") else k: v
            for k, v in sd.items()}


def _projection(p: Flat, sd) -> None:
    if "pc_projection" in sd:
        p[("pc_projection",)] = _t(sd["pc_projection"])


def convert_slip_text(sd: Dict[str, Any]) -> Dict[str, Any]:
    """SLIP/CLIP text transformer -> ``text/*`` + ``logit_scale``."""
    sd = _strip_module(sd)
    p: Flat = {}
    p[("text", "token_embedding", "embedding")] = _t(sd["token_embedding.weight"])
    p[("text", "positional_embedding")] = _t(sd["positional_embedding"])
    p[("text", "text_projection")] = _t(sd["text_projection"])
    if "logit_scale" in sd:
        p[("logit_scale",)] = _t(sd["logit_scale"]).reshape(())
    _ln(p, ("text", "ln_final", "norm"), sd, "ln_final")
    n_blocks = 1 + max(int(m.group(1)) for k in sd
                       if (m := re.match(r"transformer\.resblocks\.(\d+)\.", k)))
    for i in range(n_blocks):
        src = f"transformer.resblocks.{i}"
        dst = ("text", f"block_{i}")
        _ln(p, dst + ("ln_1", "norm"), sd, f"{src}.ln_1")
        _ln(p, dst + ("ln_2", "norm"), sd, f"{src}.ln_2")
        _linear(p, dst + ("attn", "in_proj"),
                sd[f"{src}.attn.in_proj_weight"], sd[f"{src}.attn.in_proj_bias"])
        _linear(p, dst + ("attn", "out_proj"),
                sd[f"{src}.attn.out_proj.weight"], sd[f"{src}.attn.out_proj.bias"])
        _linear(p, dst + ("c_fc",), sd[f"{src}.mlp.c_fc.weight"], sd[f"{src}.mlp.c_fc.bias"])
        _linear(p, dst + ("c_proj",), sd[f"{src}.mlp.c_proj.weight"],
                sd[f"{src}.mlp.c_proj.bias"])
    return _tree(p, {})


def convert_pointbert(sd: Dict[str, Any]) -> Dict[str, Any]:
    """ULIP PointBERT -> ``point_encoder/*`` (+ ``pc_projection``)."""
    p: Flat = {}
    s: Flat = {}
    _pointbert_leaves(_strip_module(sd), p, s)
    return _tree(p, s)


def _pointbert_leaves(sd: Dict[str, Any], p: Flat, s: Flat) -> None:
    pe = "point_encoder."
    _projection(p, sd)
    enc = ("point_encoder", "encoder")
    _conv1x1(p, enc + ("conv1a",), sd[pe + "encoder.first_conv.0.weight"],
             sd[pe + "encoder.first_conv.0.bias"])
    _bn(p, s, enc + ("bn1",), sd, pe + "encoder.first_conv.1")
    _conv1x1(p, enc + ("conv1b",), sd[pe + "encoder.first_conv.3.weight"],
             sd[pe + "encoder.first_conv.3.bias"])
    _conv1x1(p, enc + ("conv2a",), sd[pe + "encoder.second_conv.0.weight"],
             sd[pe + "encoder.second_conv.0.bias"])
    _bn(p, s, enc + ("bn2",), sd, pe + "encoder.second_conv.1")
    _conv1x1(p, enc + ("conv2b",), sd[pe + "encoder.second_conv.3.weight"],
             sd[pe + "encoder.second_conv.3.bias"])
    _linear(p, ("point_encoder", "reduce_dim"),
            sd[pe + "reduce_dim.weight"], sd[pe + "reduce_dim.bias"])
    p[("point_encoder", "cls_token")] = _t(sd[pe + "cls_token"])
    p[("point_encoder", "cls_pos")] = _t(sd[pe + "cls_pos"])
    _linear(p, ("point_encoder", "pos_embed1"),
            sd[pe + "pos_embed.0.weight"], sd[pe + "pos_embed.0.bias"])
    _linear(p, ("point_encoder", "pos_embed2"),
            sd[pe + "pos_embed.2.weight"], sd[pe + "pos_embed.2.bias"])
    n_blocks = 1 + max(int(m.group(1)) for k in sd
                       if (m := re.match(re.escape(pe) + r"blocks\.blocks\.(\d+)\.", k)))
    for i in range(n_blocks):
        src = f"{pe}blocks.blocks.{i}"
        dst = ("point_encoder", f"block_{i}")
        _ln(p, dst + ("norm1",), sd, f"{src}.norm1")
        _ln(p, dst + ("norm2",), sd, f"{src}.norm2")
        p[dst + ("attn", "qkv", "kernel")] = _t(sd[f"{src}.attn.qkv.weight"]).T
        _linear(p, dst + ("attn", "proj"),
                sd[f"{src}.attn.proj.weight"], sd[f"{src}.attn.proj.bias"])
        _linear(p, dst + ("mlp", "fc1"), sd[f"{src}.mlp.fc1.weight"], sd[f"{src}.mlp.fc1.bias"])
        _linear(p, dst + ("mlp", "fc2"), sd[f"{src}.mlp.fc2.weight"], sd[f"{src}.mlp.fc2.bias"])
    _ln(p, ("point_encoder", "norm"), sd, pe + "norm")


def convert_pointbert_partseg(sd: Dict[str, Any]) -> Dict[str, Any]:
    """ULIP PointBERT partseg trunk (``point_encoder.py:260-420``): the cls
    trunk's leaves, then the dense heads that the checkpoint holds:
    ``propagation_{0,1,2}`` (``mlp_convs`` / ``mlp_bns``), ``dgcnn_pro_{1,2}``
    (``layer{1,2}.0`` convs without bias, the ``layer{1,2}.1`` GroupNorm
    affine as ``gn{1,2}`` ``scale``/``bias``) and ``conv1`` / ``bn1``."""
    sd = _strip_module(sd)
    pe = "point_encoder."
    p: Flat = {}
    s: Flat = {}
    _pointbert_leaves(sd, p, s)
    for j in (0, 1, 2):
        src = f"{pe}propagation_{j}"
        dst = ("point_encoder", f"propagation_{j}")
        i = 0
        while f"{src}.mlp_convs.{i}.weight" in sd:
            _conv1x1(p, dst + (f"conv{i}",), sd[f"{src}.mlp_convs.{i}.weight"],
                     sd.get(f"{src}.mlp_convs.{i}.bias"))
            _bn(p, s, dst + (f"bn{i}",), sd, f"{src}.mlp_bns.{i}")
            i += 1
    for j in (1, 2):
        src = f"{pe}dgcnn_pro_{j}"
        if f"{src}.layer1.0.weight" not in sd:
            continue
        dst = ("point_encoder", f"dgcnn_pro_{j}")
        for layer, gn in (("layer1", "gn1"), ("layer2", "gn2")):
            _conv1x1(p, dst + (layer,), sd[f"{src}.{layer}.0.weight"])
            _ln(p, dst + (gn,), sd, f"{src}.{layer}.1")  # the GroupNorm's affine
    if f"{pe}conv1.weight" in sd:
        _conv1x1(p, ("point_encoder", "conv1"), sd[f"{pe}conv1.weight"],
                 sd.get(f"{pe}conv1.bias"))
        _bn(p, s, ("point_encoder", "bn1"), sd, f"{pe}bn1")
    return _tree(p, s)


def convert_pointnet2(sd: Dict[str, Any]) -> Dict[str, Any]:
    """ULIP PointNet++ SSG or MSG (the layout tells which) ->
    ``point_encoder/*``."""
    sd = _strip_module(sd)
    pe = "point_encoder."
    p: Flat = {}
    s: Flat = {}
    _projection(p, sd)
    for sa in ("sa1", "sa2", "sa3"):
        base = pe + sa
        dst = ("point_encoder", sa)
        if f"{base}.mlp_convs.0.weight" in sd:  # single-scale
            i = 0
            while f"{base}.mlp_convs.{i}.weight" in sd:
                _conv1x1(p, dst + (f"conv{i}",), sd[f"{base}.mlp_convs.{i}.weight"],
                         sd[f"{base}.mlp_convs.{i}.bias"])
                _bn(p, s, dst + (f"bn{i}",), sd, f"{base}.mlp_bns.{i}")
                i += 1
        else:  # multi-scale: conv_blocks.{scale}.{layer}
            scale = 0
            while f"{base}.conv_blocks.{scale}.0.weight" in sd:
                j = 0
                while f"{base}.conv_blocks.{scale}.{j}.weight" in sd:
                    _conv1x1(p, dst + (f"conv{scale}_{j}",),
                             sd[f"{base}.conv_blocks.{scale}.{j}.weight"],
                             sd[f"{base}.conv_blocks.{scale}.{j}.bias"])
                    _bn(p, s, dst + (f"bn{scale}_{j}",), sd, f"{base}.bn_blocks.{scale}.{j}")
                    j += 1
                scale += 1
    head = ("point_encoder", "head")
    _linear(p, head + ("fc1",), sd[pe + "fc1.weight"], sd[pe + "fc1.bias"])
    _bn(p, s, head + ("bn1",), sd, pe + "bn1")
    _linear(p, head + ("fc2",), sd[pe + "fc2.weight"], sd[pe + "fc2.bias"])
    _bn(p, s, head + ("bn2",), sd, pe + "bn2")
    return _tree(p, s)


def convert_pointmlp(sd: Dict[str, Any]) -> Dict[str, Any]:
    """ULIP PointMLP -> ``point_encoder/*`` (``embedding.net``,
    ``local_grouper_list``, ``pre|pos_blocks_list.{i}.operation.{j}.net{1,2}``,
    ``classifier.{0,1,4,5}``)."""
    sd = _strip_module(sd)
    pe = "point_encoder."
    p: Flat = {}
    s: Flat = {}
    _projection(p, sd)

    def conv_bn(dst, src):
        _conv1x1(p, dst + ("conv",), sd[src + ".net.0.weight"], sd.get(src + ".net.0.bias"))
        _bn(p, s, dst + ("bn",), sd, src + ".net.1")

    def res_block(dst, src):
        for n in (1, 2):
            _conv1x1(p, dst + (f"conv{n}",), sd[f"{src}.net{n}.0.weight"],
                     sd.get(f"{src}.net{n}.0.bias"))
            _bn(p, s, dst + (f"bn{n}",), sd, f"{src}.net{n}.1")

    conv_bn(("point_encoder", "embedding"), pe + "embedding")
    stage = 0
    while f"{pe}local_grouper_list.{stage}.affine_alpha" in sd:
        g = ("point_encoder", f"grouper{stage}")
        p[g + ("affine_alpha",)] = _t(sd[f"{pe}local_grouper_list.{stage}.affine_alpha"])
        p[g + ("affine_beta",)] = _t(sd[f"{pe}local_grouper_list.{stage}.affine_beta"])
        conv_bn(("point_encoder", f"pre{stage}", "transfer"),
                f"{pe}pre_blocks_list.{stage}.transfer")
        for kind in ("pre", "pos"):
            j = 0
            while f"{pe}{kind}_blocks_list.{stage}.operation.{j}.net1.0.weight" in sd:
                res_block(("point_encoder", f"{kind}{stage}", f"res{j}"),
                          f"{pe}{kind}_blocks_list.{stage}.operation.{j}")
                j += 1
        stage += 1
    _linear(p, ("point_encoder", "fc1"), sd[pe + "classifier.0.weight"],
            sd[pe + "classifier.0.bias"])
    _bn(p, s, ("point_encoder", "bn1"), sd, pe + "classifier.1")
    _linear(p, ("point_encoder", "fc2"), sd[pe + "classifier.4.weight"],
            sd[pe + "classifier.4.bias"])
    _bn(p, s, ("point_encoder", "bn2"), sd, pe + "classifier.5")
    return _tree(p, s)


def convert_pointnext(sd: Dict[str, Any]) -> Dict[str, Any]:
    """ULIP PointNeXt-S (BaseCls) -> ``point_encoder/*``: the stem at
    ``encoder.encoder.0.0.convs.0.0``, SA stages with skipconv and their
    convs, the group-all stage, the ClsHead at ``prediction.head``."""
    sd = _strip_module(sd)
    pe = "point_encoder."
    p: Flat = {}
    s: Flat = {}
    _projection(p, sd)
    stem = f"{pe}encoder.encoder.0.0.convs.0"
    _conv1x1(p, ("point_encoder", "stem"), sd[stem + ".0.weight"], sd.get(stem + ".0.bias"))
    stage = 1
    while f"{pe}encoder.encoder.{stage}.0.convs.0.0.weight" in sd:
        base = f"{pe}encoder.encoder.{stage}.0"
        is_global = f"{base}.skipconv.0.weight" not in sd
        dst = ("point_encoder", f"stage{stage}_global" if is_global else f"stage{stage}_sa")
        j = 0
        while f"{base}.convs.{j}.0.weight" in sd:
            _conv1x1(p, dst + (f"conv{j}", "conv"), sd[f"{base}.convs.{j}.0.weight"],
                     sd.get(f"{base}.convs.{j}.0.bias"))
            _bn(p, s, dst + (f"conv{j}", "bn"), sd, f"{base}.convs.{j}.1")
            j += 1
        if not is_global:
            _conv1x1(p, dst + ("skipconv",), sd[f"{base}.skipconv.0.weight"],
                     sd.get(f"{base}.skipconv.0.bias"))
        stage += 1
    # the ClsHead's Sequential: linear blocks at 0 and 2 (1 and 3 dropout)
    for ours, theirs in enumerate((0, 2)):
        _linear(p, ("point_encoder", f"head_fc{ours}"),
                sd[f"{pe}prediction.head.{theirs}.0.weight"],
                sd.get(f"{pe}prediction.head.{theirs}.0.bias"))
        _bn(p, s, ("point_encoder", f"head_bn{ours}"), sd, f"{pe}prediction.head.{theirs}.1")
    return _tree(p, s)


def convert_dgcnn(sd: Dict[str, Any]) -> Dict[str, Any]:
    """openpoints DGCNN (``backbone/dgcnn.py``) -> ``point_encoder/*``: the
    edge convs ``head.gconv.nn`` / ``backbone.{i}.gconv.nn`` and
    ``fusion_block``. The reference's EdgeConv concatenates ``[center,
    neighbor - center]``, ``DgcnnClassifier`` ``[neighbor - center,
    center]``: the two halves of each edge kernel's input rows swap."""
    sd = _strip_module(sd)
    pe = "point_encoder."
    p: Flat = {}
    s: Flat = {}
    _projection(p, sd)

    def edge(dst_name: str, bn_name: str, src: str):
        w = _t(sd[src + ".0.weight"])  # [C_out, 2 C_in, 1, 1]
        w = w.reshape(w.shape[0], w.shape[1]).T  # [2 C_in, C_out]
        half = w.shape[0] // 2
        p[("point_encoder", dst_name, "kernel")] = np.concatenate([w[half:], w[:half]], axis=0)
        _bn(p, s, ("point_encoder", bn_name), sd, src + ".1")

    edge("edge0", "bn0", f"{pe}head.gconv.nn")
    i = 0
    while f"{pe}backbone.{i}.gconv.nn.0.weight" in sd:
        edge(f"edge{i + 1}", f"bn{i + 1}", f"{pe}backbone.{i}.gconv.nn")
        i += 1
    _conv1x1(p, ("point_encoder", "emb"), sd[f"{pe}fusion_block.0.weight"])
    _bn(p, s, ("point_encoder", "embn"), sd, f"{pe}fusion_block.1")
    return _tree(p, s)


def convert_pointnet(sd: Dict[str, Any]) -> Dict[str, Any]:
    """openpoints PointNet with T-Nets (``backbone/pointnet.py``, STN3d /
    STNkd) -> ``point_encoder/*``."""
    sd = _strip_module(sd)
    pe = "point_encoder."
    p: Flat = {}
    s: Flat = {}
    _projection(p, sd)

    def tnet(dst_name: str, src: str):
        dst = ("point_encoder", dst_name)
        for i in (1, 2, 3):
            _conv1x1(p, dst + (f"conv{i}",), sd[f"{src}.conv{i}.weight"],
                     sd.get(f"{src}.conv{i}.bias"))
        for i in (1, 2, 3):
            _linear(p, dst + (f"fc{i}",), sd[f"{src}.fc{i}.weight"], sd.get(f"{src}.fc{i}.bias"))
        for i in (1, 2, 3, 4, 5):
            _bn(p, s, dst + (f"bn{i}",), sd, f"{src}.bn{i}")

    if f"{pe}stn.conv1.weight" in sd:
        tnet("stn", f"{pe}stn")
    if f"{pe}fstn.conv1.weight" in sd:
        tnet("fstn", f"{pe}fstn")
    for name in ("conv0_1", "conv0_2", "conv1", "conv2", "conv3"):
        _conv1x1(p, ("point_encoder", name), sd[f"{pe}{name}.weight"], sd.get(f"{pe}{name}.bias"))
    for name in ("bn0_1", "bn0_2", "bn1", "bn2", "bn3"):
        _bn(p, s, ("point_encoder", name), sd, f"{pe}{name}")
    return _tree(p, s)


def _convblock(p: Flat, s: Flat, dst: Tuple[str, ...], sd, src: str):
    """A ``create_convblock*`` Sequential -> ``{conv, bn}``: the conv at index
    0, the BatchNorm at whichever of 1 and 2 holds running statistics (the
    order differs by tower)."""
    _conv1x1(p, dst + ("conv",), sd[src + ".0.weight"], sd.get(src + ".0.bias"))
    for j in (1, 2):
        if f"{src}.{j}.running_mean" in sd:
            _bn(p, s, dst + ("bn",), sd, f"{src}.{j}")


def convert_balldgcnn(sd: Dict[str, Any]) -> Dict[str, Any]:
    """openpoints BallDGCNN (``backbone/ball_dgcnn.py:13-108``) -> the
    ``BallDgcnn`` tree (top level, as the reference's converter writes it)."""
    sd = _strip_module(sd)
    p: Flat = {}
    s: Flat = {}
    _convblock(p, s, ("edge0",), sd, "head.gconv.nn")
    i = 0
    while f"backbone.{i}.gconv.nn.0.weight" in sd:
        _convblock(p, s, (f"edge{i + 1}",), sd, f"backbone.{i}.gconv.nn")
        i += 1
    _convblock(p, s, ("fusion",), sd, "fusion_block")
    return _tree(p, s)


def convert_deepgcn(sd: Dict[str, Any]) -> Dict[str, Any]:
    """openpoints DeepGCN (``backbone/deepgcn.py:13-128``) -> the ``DeepGcn``
    tree."""
    sd = _strip_module(sd)
    p: Flat = {}
    s: Flat = {}
    _convblock(p, s, ("edge0",), sd, "head.gconv.nn")
    i = 0
    while f"backbone.{i}.body.gconv.nn.0.weight" in sd:
        _convblock(p, s, (f"edge{i + 1}",), sd, f"backbone.{i}.body.gconv.nn")
        i += 1
    _convblock(p, s, ("fusion",), sd, "fusion_block")
    return _tree(p, s)


def convert_grouppointnet(sd: Dict[str, Any]) -> Dict[str, Any]:
    """openpoints GroupPointNet (``backbone/grouppointnet.py:11-100``) -> the
    ``GroupPointNet`` tree."""
    sd = _strip_module(sd)
    p: Flat = {}
    s: Flat = {}
    i = 0
    while f"backbone.{i}.0.weight" in sd:
        _convblock(p, s, (f"conv{i}",), sd, f"backbone.{i}")
        i += 1
    return _tree(p, s)


def _conv2d(dst_params: Flat, path: Tuple[str, ...], w, b=None):
    """Conv2d ``[out, in, kh, kw]`` -> flax's HWIO kernel."""
    dst_params[path + ("kernel",)] = _t(w).transpose(2, 3, 1, 0)
    if b is not None:
        dst_params[path + ("bias",)] = _t(b)


def convert_simpleview(sd: Dict[str, Any]) -> Dict[str, Any]:
    """openpoints MVModel (``backbone/simpleview.py:62-153``) -> the
    ``SimpleView`` tree. ``img_model``: 0 the stem conv, 1 its BatchNorm,
    3-6 ResNet's layer1..4 (Sequentials of blocks); ``final_fc.model``: 0
    the views' BatchNorm, 3 and 7 Linear, 4 BatchNorm."""
    sd = _strip_module(sd)
    p: Flat = {}
    s: Flat = {}
    _conv2d(p, ("stem_conv",), sd["img_model.0.weight"])
    _bn(p, s, ("stem_bn",), sd, "img_model.1")
    for stage in range(4):
        b = 0
        while f"img_model.{3 + stage}.{b}.conv1.weight" in sd:
            src = f"img_model.{3 + stage}.{b}"
            dst = ("backbone", f"layer{stage + 1}_{b}")
            for c in ("conv1", "conv2", "conv3"):
                if f"{src}.{c}.weight" in sd:
                    _conv2d(p, dst + (c,), sd[f"{src}.{c}.weight"])
            for n in ("bn1", "bn2", "bn3"):
                if f"{src}.{n}.weight" in sd:
                    _bn(p, s, dst + (n,), sd, f"{src}.{n}")
            if f"{src}.downsample.0.weight" in sd:
                _conv2d(p, dst + ("ds_conv",), sd[f"{src}.downsample.0.weight"])
                _bn(p, s, dst + ("ds_bn",), sd, f"{src}.downsample.1")
            b += 1
    _bn(p, s, ("fc_bn0",), sd, "final_fc.model.0.bn")
    _linear(p, ("fc1",), sd["final_fc.model.3.weight"], sd.get("final_fc.model.3.bias"))
    _bn(p, s, ("fc_bn1",), sd, "final_fc.model.4")
    _linear(p, ("fc2",), sd["final_fc.model.7.weight"], sd.get("final_fc.model.7.bias"))
    return _tree(p, s)


def _fold(parts, rename=None):
    """A torch module path as the flax tree names it: an integer segment
    folds into its parent (``enc1.1.transformer2.linear_p.1`` ->
    ``enc1_1/transformer2/linear_p_1``), after ``rename``'s renames."""
    out = []
    for part in parts:
        part = (rename or {}).get(part, part)
        if part.isdigit() and out:
            out[-1] = f"{out[-1]}_{part}"
        else:
            out.append(part)
    return tuple(out)


def _folded(sd: Dict[str, Any], flax_path, raw) -> Dict[str, Any]:
    """Every module of ``sd`` by its folded path: BatchNorms (found by their
    ``running_mean``), then weights; ``raw(src)`` tells a transposed 1x1
    convolution, whose ``[in, out, 1...]`` kernel is already flax's
    ``[in, out]``."""
    p: Flat = {}
    s: Flat = {}
    for src in sorted({k.rsplit(".", 1)[0] for k in sd}):
        dst = flax_path(src.split("."))
        if src + ".running_mean" in sd:
            _bn(p, s, dst, sd, src)
        elif src + ".weight" in sd:
            w = _t(sd[src + ".weight"])
            b = sd.get(src + ".bias")
            if w.ndim > 2 and raw(src):
                p[dst + ("kernel",)] = w.reshape(w.shape[0], w.shape[1])
                if b is not None:
                    p[dst + ("bias",)] = _t(b)
            elif w.ndim > 2:
                _conv1x1(p, dst, w, b)
            else:
                _linear(p, dst, w, b)
    return _tree(p, s)


def convert_pointtransformer(sd: Dict[str, Any]) -> Dict[str, Any]:
    """openpoints PTSeg (``backbone/pointtransformer.py:218-293``) -> the
    ``PointTransformerSeg`` tree: every integer segment folded into its
    parent, BatchNorms found by their running statistics."""
    return _folded(_strip_module(sd), _fold, lambda src: False)


def convert_randlanet(sd: Dict[str, Any]) -> Dict[str, Any]:
    """RandLA-Net (``backbone/randlenet.py:186-301``) -> the ``RandLANet``
    tree: folded as PTSeg's, SharedMLP's ``batch_norm`` named ``bn``, the
    Sequential singletons ``score_fn.0`` / ``bn_start.0`` without their
    index, and the decoder's ConvTranspose2d kernels (k=1, s=1: a 1x1
    convolution already in flax's ``[in, out]`` layout) not transposed."""

    def flax_path(parts):
        return tuple(seg[:-2] if seg in ("score_fn_0", "bn_start_0") else seg
                     for seg in _fold(parts, {"batch_norm": "bn"}))

    return _folded(_strip_module(sd), flax_path, lambda src: src.startswith("decoder."))


def convert_baafnet(sd: Dict[str, Any]) -> Dict[str, Any]:
    """openpoints BAAFNet (``backbone/baafnet.py:365-527``) -> the ``BaafNet``
    tree: folded as PTSeg's (``EncoderBCBModules.0.BA.mlp1`` ->
    ``EncoderBCBModules_0/BA/mlp1``); ``conv_trans`` (a ConvTranspose1d,
    k=1) becomes the same ``linear`` Dense, not transposed."""
    return _folded(_strip_module(sd), lambda parts: _fold(parts, {"conv_trans": "linear"}),
                   lambda src: src.endswith("conv_trans"))


# every kind of the reference's converter
CONVERTERS = {
    "slip": convert_slip_text,
    "pointbert": convert_pointbert,
    "pointbert_partseg": convert_pointbert_partseg,
    "pointnet2_ssg": convert_pointnet2,
    "pointnet2_msg": convert_pointnet2,
    "pointmlp": convert_pointmlp,
    "pointnext": convert_pointnext,
    "dgcnn": convert_dgcnn,
    "pointnet": convert_pointnet,
    "balldgcnn": convert_balldgcnn,
    "deepgcn": convert_deepgcn,
    "grouppointnet": convert_grouppointnet,
    "simpleview": convert_simpleview,
    "pointtransformer": convert_pointtransformer,
    "randlanet": convert_randlanet,
    "baafnet": convert_baafnet,
}



def _count(tree: Dict[str, Any]) -> int:
    return sum(_count(v) if isinstance(v, dict) else 1 for v in tree.values())


def convert_file(src: str, kind: str, out: str, state_key: str = "state_dict") -> None:
    """Read ``src`` (a ``.pt`` file: UNPICKLED, see the module docstring),
    convert its state dict (under ``state_key`` when present) by ``kind``
    and write the tree to ``out``."""
    import torch

    ckpt = torch.load(src, map_location="cpu", weights_only=False)
    sd = ckpt[state_key] if state_key in ckpt else ckpt
    tree = CONVERTERS[kind](sd)
    with open(out, "wb") as f:
        f.write(flax_msgpack.msgpack_serialize(tree))
    log.info("converted %s (%s): %d param leaves -> %s", src, kind, _count(tree["params"]), out)


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True)
    ap.add_argument("--kind", required=True, choices=sorted(CONVERTERS))
    ap.add_argument("--out", required=True)
    ap.add_argument("--state-key", default="state_dict")
    args = ap.parse_args(argv)
    convert_file(args.src, args.kind, args.out, args.state_key)


if __name__ == "__main__":
    main()
