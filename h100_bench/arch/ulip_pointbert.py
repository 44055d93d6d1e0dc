"""ULIP-2 PointBERT with the prompt-tuned CLIP text tower (PPT-Base)."""

from __future__ import annotations

from typing import Dict, List

from h100_bench import weights as wt
from h100_bench.arch import (PEAK_BF16, PEAK_F32, Piece, logits_macs, prompt_length,
                             ranges_of, text_macs)
from h100_bench.reference.pointbert import PointBertTower

ranges = ranges_of


def feat_dims(cfg: Dict) -> int:
    return 2 * cfg["point"]["trans_dim"]


def shapes(cfg: Dict) -> wt.Shapes:
    c = cfg["point"]
    C, E = c["trans_dim"], c["encoder_dims"]
    s = wt.ulip_shapes(cfg["text"], cfg["prompt"]["n_ctx"], feat_dims(cfg))
    p = "point_encoder."
    s[p + "cls_token"] = (1, 1, C)
    s[p + "cls_pos"] = (1, 1, C)
    wt.dense(s, p + "encoder.conv1a", 3, 128)
    wt.norm(s, p + "encoder.bn1", 128, running=True)
    wt.dense(s, p + "encoder.conv1b", 128, 256)
    wt.dense(s, p + "encoder.conv2a", 512, 512)
    wt.norm(s, p + "encoder.bn2", 512, running=True)
    wt.dense(s, p + "encoder.conv2b", 512, E)
    wt.dense(s, p + "reduce_dim", E, C)
    wt.dense(s, p + "pos_embed1", 3, 128)
    wt.dense(s, p + "pos_embed2", 128, C)
    for i in range(c["depth"]):
        b = f"{p}block_{i}."
        wt.norm(s, b + "norm1", C)
        wt.dense(s, b + "attn.qkv", C, 3 * C, bias=False)
        wt.dense(s, b + "attn.proj", C, C)
        wt.norm(s, b + "norm2", C)
        wt.dense(s, b + "mlp.fc1", C, 4 * C)
        wt.dense(s, b + "mlp.fc2", 4 * C, C)
    wt.norm(s, p + "norm", C)
    return s


def reference(W, cfg: Dict, P) -> PointBertTower:
    return PointBertTower(W, cfg["point"], P)


def _macs(cfg: Dict):
    """Per cloud: (tokenizer, embedding, trunk) multiply-adds."""
    c = cfg["point"]
    G, M, C, E = c["num_group"], c["group_size"], c["trans_dim"], c["encoder_dims"]
    tokenizer = G * M * (3 * 128 + 128 * 256 + 512 * 512 + 512 * E)
    embed = G * (E * C + 3 * 128 + 128 * C)
    L = G + 1
    trunk = c["depth"] * (L * 12 * C * C + 2 * L * L * C)
    return tokenizer, embed, trunk


def tower_macs(cfg: Dict) -> float:
    return sum(_macs(cfg))


def model_flops(cfg: Dict, kind: str, clouds: int) -> float:
    """Model FLOPs of one step (``tune``) or one pass (``recognize``) over
    ``clouds`` clouds."""
    L = prompt_length(cfg)
    C = len(cfg["classnames"])
    macs = clouds * tower_macs(cfg) + logits_macs(cfg, clouds, feat_dims(cfg))
    macs += text_macs(cfg, C, L, backward=False)
    if kind == "tune":
        macs += text_macs(cfg, C, L, backward=True) + clouds * C * cfg["text"]["embed_dim"]
    return 2.0 * macs


def pieces(cfg: Dict, kind: str) -> List[Piece]:
    """The port's kernels' pieces of one batch: grouping (FPS and kNN, the
    point tower's own launches outside its modules), the tokenizer, and
    the blocks with the readout."""
    c, B, N = cfg["point"], cfg["batch_size"], cfg["npoints"]
    G, M, C, E, D = c["num_group"], c["group_size"], c["trans_dim"], c["encoder_dims"], c["depth"]
    tokenizer, _, trunk = _macs(cfg)
    tok_w = 3 * 128 + 128 * 256 + 512 * 512 + 512 * E
    return [
        Piece("grouping", (("range_only", "point_tower"),), ops=2 * B * N * G * 9,
              peak=PEAK_F32, bytes=B * N * 12 + B * G * M * 12 + B * G * 12),
        Piece("tokenizer", (("range", "point_tower.encoder"),), ops=2 * B * tokenizer,
              peak=PEAK_BF16, bytes=B * G * M * 12 + 2 * tok_w + B * G * E * 2),
        Piece("trunk", tuple(("range", f"point_tower.block_{i}") for i in range(D)),
              ops=2 * B * trunk, peak=PEAK_BF16,
              bytes=D * 12 * C * C * 2 + 2 * B * (G + 1) * C * 2 + B * 2 * C * 4),
    ]
