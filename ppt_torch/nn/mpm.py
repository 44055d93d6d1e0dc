"""Masked point modeling: PointBERT's second pretraining stage.

Counterpart of ``ppt_tpu/nn/mpm.py:28-109``: a frozen dVAE tokenizes each
group into a discrete id; the student ViT sees the group sequence with a
masked subset replaced by a learnable mask token and predicts the dVAE's
ids at the masked groups (cross-entropy over the codebook).

The student is PointBERT's trunk: the MiniPointNet group encoder on its
fused kernels, ``reduce_dim``, the position MLP (3 -> 128 -> width,
tanh-GELU) added before every block, 12 ``VitBlock``s on a trunk route and
a final f32 LayerNorm (eps 1e-6) feeding ``lm_head`` on the group tokens.
The route is the reference's ``VitBlock`` decision (``nn/pointbert.py:
325-332``): "block" (the fused block kernel, the default), "unfused"
(modules with ``fused_mha``) or "plain"; a trunk of ``FLASH_MIN_SEQ``
tokens or more runs unfused on ``flash_mha``. The whole-trunk tower kernel
emits only the classification readout, so it has no place here.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from ppt_torch.kernels.attention import FLASH_MIN_SEQ
from ppt_torch.nn.dvae import DiscreteVAE
from ppt_torch.nn.layers import Dense, LayerNormF32, drop_path_scales, gelu_tanh, init_dense_
from ppt_torch.nn.pointbert import MiniPointNet, PointBertConfig, VitBlock
from ppt_torch.parallel import collectives as _dp

MPM_ROUTES = ("block", "unfused", "plain")


def sample_group_mask(generator: torch.Generator, batch: int, num_group: int, ratio: float,
                      device=None) -> torch.Tensor:
    """[B, G] bool: exactly ``max(int(G * ratio), 1)`` groups masked per
    row, the lowest of uniform scores drawn from ``generator``."""
    scores = _dp.global_draw(torch.rand, (batch, num_group), generator=generator, device=device)
    k = max(int(num_group * ratio), 1)
    mask = torch.zeros(batch, num_group, dtype=torch.bool, device=scores.device)
    return mask.scatter_(1, scores.argsort(dim=1)[:, :k], True)


@torch.no_grad()
def dvae_tokenize(dvae: DiscreteVAE, neighborhood: torch.Tensor,
                  center: torch.Tensor) -> torch.Tensor:
    """The frozen dVAE's group ids [B, G]: argmax of its codebook logits,
    with its running statistics."""
    return dvae.tokenize(neighborhood, center)


class PointBertMPM(nn.Module):
    """Student: PointBERT trunk + token-prediction head."""

    def __init__(self, config: PointBertConfig = PointBertConfig(), num_tokens: int = 8192,
                 dtype: torch.dtype = torch.float32, route: str = "block"):
        super().__init__()
        if route not in MPM_ROUTES:
            raise ValueError(f"PointBertMPM route {route!r} not in {MPM_ROUTES}")
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.route = route
        C = cfg.trans_dim
        self.encoder = MiniPointNet(cfg.encoder_dims, dtype=dtype)
        self.reduce_dim = Dense(cfg.encoder_dims, C, dtype=dtype)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, C))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, C))
        self.cls_pos = nn.Parameter(torch.zeros(1, 1, C))
        self.pos_embed1 = Dense(3, 128, dtype=dtype)
        self.pos_embed2 = Dense(128, C, dtype=dtype)
        for i in range(cfg.depth):
            self.add_module(f"block_{i}", VitBlock(C, cfg.num_heads, dtype=dtype))
        self.norm = LayerNormF32(C, eps=1e-6)
        self.lm_head = Dense(C, num_tokens, dtype=dtype)

    def forward(self, neighborhood: torch.Tensor, center: torch.Tensor, mask: torch.Tensor,
                train: bool = False, generator=None) -> torch.Tensor:
        """neighborhood [B, G, M, 3], center [B, G, 3], mask [B, G] bool (True:
        masked) -> logits [B, G, num_tokens] in the compute dtype. ``train``:
        batch statistics in the group encoder and DropPath from ``generator``."""
        cfg = self.config
        dt = self.dtype
        B = mask.shape[0]
        tokens = self.reduce_dim(self.encoder(neighborhood, train))
        tokens = torch.where(mask[..., None], self.mask_token.to(tokens.dtype), tokens)
        pos = self.pos_embed2(gelu_tanh(self.pos_embed1(center)))
        x = torch.cat([self.cls_token.to(dt).expand(B, 1, -1), tokens], dim=1)
        pos = torch.cat([self.cls_pos.to(dt).expand(B, 1, -1), pos], dim=1)
        rates = np.linspace(0.0, cfg.drop_path_rate, cfg.depth).tolist()
        route = self.route if x.shape[1] < FLASH_MIN_SEQ else "unfused"
        dp = drop_path_scales(rates, B, train, generator, x.device)
        for i in range(cfg.depth):
            x = getattr(self, f"block_{i}")(x, pos, dp[i], route=route,
                                            rate=rates[i] if train else 0.0)
        return self.lm_head(self.norm(x.float())[:, 1:])


def init_mpm(model: PointBertMPM, seed: int) -> PointBertMPM:
    """Random weights from ``seed`` with the reference's initialiser
    families: lecun-normal Dense kernels, zero biases, the mask token
    normal(0.02), the cls token zero, its position normal(1)."""
    gen = torch.Generator().manual_seed(seed)
    init_dense_(model, gen)
    with torch.no_grad():
        model.mask_token.copy_(torch.randn(model.mask_token.shape, generator=gen) * 0.02)
        model.cls_pos.copy_(torch.randn(model.cls_pos.shape, generator=gen))
    return model


def mpm_loss(logits: torch.Tensor, target_ids: torch.Tensor,
             mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked-position cross-entropy and masked-position accuracy (a
    fraction), each over the masked groups only."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    picked = logp.gather(-1, target_ids.long()[..., None])[..., 0]
    m = mask.float()
    denom = torch.clamp_min(m.sum(), 1.0)
    loss = -(picked * m).sum() / denom
    acc = ((logits.argmax(-1) == target_ids).float() * m).sum() / denom
    return loss, acc
