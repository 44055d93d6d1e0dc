"""PointBERT's point tower (Yu et al. 2022; ULIP-2's ``PointTransformer``),
written plainly.

- Grouping: farthest point sampling of ``num_group`` centres from point 0
  (each step takes the first point of largest distance to the centres so
  far), then the ``group_size`` nearest points of each centre, nearest
  first and ties to the lower index, minus the centre.
- Tokenizer (the mini-PointNet): per point ``3 -> 128``, BatchNorm, ReLU,
  ``-> 256``; the group's max joined in front of each point's feature,
  ``512 -> 512``, BatchNorm, ReLU, ``-> encoder_dims``; max over the group.
  BatchNorm (eps 1e-5) uses the batch's biased statistics in training and
  the running ones otherwise.
- Trunk: ``reduce_dim``, a class token, positions ``3 -> 128 -> GELU(tanh)
  -> trans_dim`` (the class token's own), added before every block;
  pre-norm blocks (LayerNorm eps 1e-6, attention with a bias-free qkv,
  tanh-GELU MLP of 4x), each branch scaled by its sample's DropPath scale.
- Readout: the final LayerNorm, then ``[class token, max over groups]``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from h100_bench.reference.clip_text import attention, layer_norm
from h100_bench.reference.precision import Products


def sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, S, 3], [B, N, 3] -> squared distances [B, S, N], f32."""
    d = a[:, :, None, :] - b[:, None, :, :]
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def fps(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Farthest point sampling from point 0: indices [B, npoint]."""
    B, N, _ = xyz.shape
    rows = torch.arange(B, device=xyz.device)
    dist = torch.full((B, N), float("inf"), device=xyz.device)
    far = torch.zeros(B, dtype=torch.long, device=xyz.device)
    out = []
    for _ in range(npoint):
        out.append(far)
        dist = torch.minimum(dist, sq_dist(xyz[rows, far][:, None], xyz)[:, 0])
        far = dist.argmax(-1)
    return torch.stack(out, 1)


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, C], idx [B, ...] -> [B, ..., C]."""
    B = x.shape[0]
    return x[torch.arange(B, device=x.device).view(B, *[1] * (idx.dim() - 1)), idx]


def batch_norm(x: torch.Tensor, W: Dict[str, torch.Tensor], name: str, train: bool,
               eps: float = 1e-5) -> torch.Tensor:
    flat = x.reshape(-1, x.shape[-1])
    if train:
        mean, var = flat.mean(0), flat.var(0, unbiased=False)
    else:
        mean, var = W[name + ".running_mean"], W[name + ".running_var"]
    return (x - mean) / torch.sqrt(var + eps) * W[name + ".weight"] + W[name + ".bias"]


def dense(P: Products, x: torch.Tensor, W: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    y = P.mm(x, W[name + ".kernel"])
    return y + W[name + ".bias"] if name + ".bias" in W else y


class PointBertTower:
    """``__call__(pc [B, N, 3], train, dp [depth, B, 2] or None)`` -> [B, 2 C]."""

    def __init__(self, W: Dict[str, torch.Tensor], cfg: Dict, P: Products,
                 prefix: str = "point_encoder."):
        self.W = {k[len(prefix):]: v for k, v in W.items() if k.startswith(prefix)}
        self.cfg, self.P = cfg, P

    def group(self, pc: torch.Tensor):
        c = self.cfg
        center = gather(pc, fps(pc, c["num_group"]))
        knn = torch.sort(sq_dist(center, pc), dim=-1, stable=True).indices[..., :c["group_size"]]
        return gather(pc, knn) - center[:, :, None], center

    def tokenizer(self, groups: torch.Tensor, train: bool) -> torch.Tensor:
        W, P = self.W, self.P
        h = torch.relu(batch_norm(dense(P, groups, W, "encoder.conv1a"), W, "encoder.bn1", train))
        h = dense(P, h, W, "encoder.conv1b")  # [B, G, M, 256]
        h = torch.cat([h.amax(2, keepdim=True).expand_as(h), h], -1)
        h = torch.relu(batch_norm(dense(P, h, W, "encoder.conv2a"), W, "encoder.bn2", train))
        return dense(P, h, W, "encoder.conv2b").amax(2)

    def __call__(self, pc: torch.Tensor, train: bool = False,
                 dp: Optional[torch.Tensor] = None) -> torch.Tensor:
        W, P, c = self.W, self.P, self.cfg
        groups, center = self.group(pc)
        B = pc.shape[0]
        x = dense(P, self.tokenizer(groups, train), W, "reduce_dim")
        pos = dense(P, F.gelu(dense(P, center, W, "pos_embed1"), approximate="tanh"), W,
                    "pos_embed2")
        x = torch.cat([W["cls_token"].expand(B, 1, -1), x], 1)
        pos = torch.cat([W["cls_pos"].expand(B, 1, -1), pos], 1)
        for i in range(c["depth"]):
            p = f"block_{i}."
            keep = dp[i] if dp is not None else torch.ones(B, 2, device=pc.device)
            x = x + pos
            h = layer_norm(x, W[p + "norm1.weight"], W[p + "norm1.bias"], 1e-6)
            a = attention(P, *P.mm(h, W[p + "attn.qkv.kernel"]).chunk(3, -1), c["num_heads"],
                          causal=False)
            x = x + dense(P, a, W, p + "attn.proj") * keep[:, 0, None, None]
            h = layer_norm(x, W[p + "norm2.weight"], W[p + "norm2.bias"], 1e-6)
            h = dense(P, F.gelu(dense(P, h, W, p + "mlp.fc1"), approximate="tanh"), W,
                      p + "mlp.fc2")
            x = x + h * keep[:, 1, None, None]
        x = layer_norm(x, W["norm.weight"], W["norm.bias"], 1e-6)
        return torch.cat([x[:, 0], x[:, 1:].amax(1)], -1)


def droppath_scales(u: torch.Tensor, rate: float) -> torch.Tensor:
    """Stochastic depth over a ladder ``linspace(0, rate, depth)``: from
    uniform draws ``u`` [depth, B, 2] (attention and MLP branch of each
    block) the scale ``Bernoulli(keep) / keep``."""
    keep = 1.0 - torch.linspace(0.0, rate, u.shape[0], dtype=torch.float64).float()
    keep = keep.to(u.device)[:, None, None]
    return (u < keep).float() / keep
