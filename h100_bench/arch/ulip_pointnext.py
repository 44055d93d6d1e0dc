"""ULIP over PointNeXt-S (``ULIP_PN_NEXT``) with the prompt-tuned CLIP text tower."""

from __future__ import annotations

from typing import Dict, List

from h100_bench import weights as wt
from h100_bench.arch import (PEAK_BF16, PEAK_F32, Piece, logits_macs, prompt_length,
                             ranges_of, text_macs)
from h100_bench.reference.pointnext import PointNextTower

ranges = ranges_of


def feat_dims(cfg: Dict) -> int:
    return cfg["point"]["head_mlps"][-1]


def _stages(cfg: Dict):
    """(points in, points out, channels in, channels out) of each strided stage."""
    c = cfg["point"]
    n, w, out = cfg["npoints"], c["width"], []
    for s in c["strides"][1:]:
        if s == 1:
            break
        out.append((n, n // s, w, w * 2))
        n, w = n // s, w * 2
    return out, n, w


def shapes(cfg: Dict) -> wt.Shapes:
    c = cfg["point"]
    s = wt.ulip_shapes(cfg["text"], cfg["prompt"]["n_ctx"], feat_dims(cfg))
    p = "point_encoder."
    wt.dense(s, p + "stem", c["in_channels"], c["width"])
    stages, _, w = _stages(cfg)
    for i, (_, _, ci, co) in enumerate(stages, 1):
        widths = [co // 2] * (c["sa_layers"] - 1) + [co]
        last = ci + 3
        for j, wj in enumerate(widths):
            wt.dense(s, f"{p}stage{i}_sa.conv{j}.conv", last, wj, bias=False)
            wt.norm(s, f"{p}stage{i}_sa.conv{j}.bn", wj, running=True)
            last = wj
        wt.dense(s, f"{p}stage{i}_sa.skipconv", ci, co)
    g = len(stages) + 1
    last = w + 3
    for j in range(c["sa_layers"]):
        wt.dense(s, f"{p}stage{g}_global.conv{j}.conv", last, w, bias=False)
        wt.norm(s, f"{p}stage{g}_global.conv{j}.bn", w, running=True)
        last = w
    for i, h in enumerate(c["head_mlps"]):
        wt.dense(s, f"{p}head_fc{i}", last, h, bias=False)
        wt.norm(s, f"{p}head_bn{i}", h, running=True)
        last = h
    return s


def reference(W, cfg: Dict, P) -> PointNextTower:
    return PointNextTower(W, cfg["point"], P)


def tower_macs(cfg: Dict) -> float:
    c = cfg["point"]
    K = c["nsample"]
    stages, n, w = _stages(cfg)
    macs = cfg["npoints"] * c["in_channels"] * c["width"]
    for _, so, ci, co in stages:
        widths = [co // 2] * (c["sa_layers"] - 1) + [co]
        ins = [ci + 3] + widths[:-1]
        macs += so * K * sum(a * b for a, b in zip(ins, widths)) + so * ci * co
    macs += n * ((w + 3) * w + (c["sa_layers"] - 1) * w * w)
    last = w
    for h in c["head_mlps"]:
        macs += last * h
        last = h
    return macs


def model_flops(cfg: Dict, kind: str, clouds: int) -> float:
    if kind != "recognize":
        raise ValueError(f"{cfg['name']}: no work counts for {kind!r}")
    L = prompt_length(cfg)
    C = len(cfg["classnames"])
    macs = clouds * tower_macs(cfg) + logits_macs(cfg, clouds, feat_dims(cfg))
    return 2.0 * (macs + text_macs(cfg, C, L, backward=False))


def pieces(cfg: Dict, kind: str) -> List[Piece]:
    """The port's kernels' pieces of one batch: the stages' FPS and their
    ball-query grouping (centre-relative coordinates and feature rows)."""
    B, K = cfg["batch_size"], cfg["point"]["nsample"]
    stages, _, _ = _stages(cfg)
    fps_ops = sum(B * ni * so * 9 for ni, so, _, _ in stages)
    fps_bytes = sum(B * ni * 12 + B * so * 4 for ni, so, _, _ in stages)
    ball_bytes = sum(B * ni * 12 + B * so * 12 + B * ni * ci * 2 + B * so * K * (12 + 2 * ci)
                     for ni, so, ci, _ in stages)
    return [Piece("fps", (("kernels", ("fps_batched_kernel",)),), fps_ops, PEAK_F32, fps_bytes),
            Piece("ball_query", (("kernels", ("ball_query_feats_kernel",)),), 0.0, PEAK_BF16,
                  ball_bytes)]
