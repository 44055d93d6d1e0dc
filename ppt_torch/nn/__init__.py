"""Network modules: shared layers, the point towers, the scene-segmentation
backbones, the pretraining models (the masked-point autoencoder among them)
and the CLIP text tower.

The towers' names are exported here, as ``ppt_tpu/nn/__init__.py`` exports
the reference's, and imported on first use (``from ppt_torch.nn import
CurveNet``): the kernels' modules import ``nn.layers``, so an eager import
of every tower here would run in a circle.
"""

import importlib

_EXPORTS = {
    "LayerNormF32": "layers", "MlpBlock": "layers", "BatchNorm": "layers", "Dense": "layers",
    "TextTransformer": "text", "TextConfig": "text",
    "PointBert": "pointbert", "PointBertConfig": "pointbert", "PointBertPartSeg": "pointbert",
    "PointNet2Ssg": "pointnet2", "PointNet2Msg": "pointnet2",
    "PointMLP": "pointmlp", "PointMLPConfig": "pointmlp",
    "PointNext": "pointnext", "PointNextConfig": "pointnext",
    "PointNetClassic": "classic", "PointNetEncoder": "classic", "Tnet": "classic",
    "DgcnnClassifier": "classic",
    "Pct": "pct",
    "CurveNet": "curvenet", "CurveNetConfig": "curvenet",
    "BallDgcnn": "gcn", "DeepGcn": "gcn", "DeepGcnConfig": "gcn", "GroupPointNet": "gcn",
    "BasicBlock": "resnet", "Bottleneck": "resnet", "ResNetStages": "resnet",
    "SimpleView": "simpleview", "SimpleViewConfig": "simpleview",
    "points_to_depth_views": "simpleview",
    "PointTransformerSeg": "pointtransformer", "PointTransformerConfig": "pointtransformer",
    "RandLANet": "randlanet", "RandLANetConfig": "randlanet",
    "BaafNet": "baafnet", "BaafNetConfig": "baafnet",
    "GraphVit3d": "graphvit", "GraphVit3dConfig": "graphvit", "PointPatchEmbed": "graphvit",
    "StratifiedConfig": "stratified", "StratifiedSeg": "stratified",
    "PointNextPacked": "pointnext_packed",
    "PointVitSeg": "vitseg", "PointVitSegConfig": "vitseg",
    "Assa": "assa",
    "MaeConfig": "mae", "MaskedPointMAE": "mae", "random_patch_masking": "mae",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
