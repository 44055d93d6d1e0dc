"""Masked-point-group autoencoder (Point-MAE style pretraining).

Counterpart of ``ppt_tpu/nn/mae.py``: FPS centres and kNN groups, per-sample
random patch masking by a noise argsort, a ViT encoder over the KEPT patches
only, a light ViT decoder over the restored sequence (kept tokens and the
mask token, each at its patch's original place, with centre position
embeddings), one Dense head regressing each patch's ``group_size`` x 3
centre-relative coordinates, and a per-patch Chamfer-L1 loss.

On the card a step runs the port's kernels: ``fps_batched`` and
``knn_gather`` in the grouping, ``mini_stats`` (training) and
``mini_forward`` in the group encoder (its last layer ``encoder_dims`` =
128 wide, which the bf16 kernel takes as a template width), and one
``fused_vit_block`` a block, on the ``L_keep`` kept tokens in the encoder
and on all ``num_group`` in the decoder. The Chamfer-L1 stays plain, as the
reference computes it in XLA (``ppt_tpu/ops/losses3d.py:64-68``).

The masking noise ``[B, L]`` is an input (``masking_noise`` draws it from a
``torch.Generator``), so a test hands both packages the same draws. Module
and parameter names follow the flax tree, so ``ppt_torch.convert.from_jax``
maps every leaf one to one.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from ppt_torch.nn.layers import Dense, LayerNormF32, gelu_tanh, init_dense_
from ppt_torch.nn.pointbert import MiniPointNet, VitBlock, group_points
from ppt_torch.ops.losses3d import chamfer_l1
from ppt_torch.parallel import collectives as _dp


@dataclasses.dataclass(frozen=True)
class MaeConfig:
    num_group: int = 64
    group_size: int = 32
    mask_ratio: float = 0.6
    encoder_dims: int = 128
    trans_dim: int = 192
    depth: int = 6
    decoder_depth: int = 2
    num_heads: int = 6


def masking_noise(generator: torch.Generator, batch: int, num_group: int) -> torch.Tensor:
    """Uniform masking noise [B, L] f32, drawn from ``generator`` on its own
    device."""
    return _dp.global_draw(torch.rand, (batch, num_group), generator=generator,
                           device=generator.device)


def random_patch_masking(noise: torch.Tensor, mask_ratio: float
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-sample shuffle by the argsort of ``noise`` [B, L]
    (``maskedpointgroup.py:71-105``): (ids_keep [B, L_keep], ids_restore
    [B, L], mask [B, L] f32 with 0 = kept, 1 = removed, in the original
    patch order). Stable sorts, as ``jnp.argsort``'s."""
    B, L = noise.shape
    len_keep = int(L * (1 - mask_ratio))
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    mask = torch.ones(B, L, device=noise.device)
    mask[:, :len_keep] = 0.0
    return ids_shuffle[:, :len_keep], ids_restore, torch.gather(mask, 1, ids_restore)


def _rows(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """x [B, L, C] gathered along L by ids [B, L']: ``take_along_axis``."""
    return torch.gather(x, 1, ids[..., None].expand(-1, -1, x.shape[-1]))


class MaskedPointMAE(nn.Module):
    """``forward(pts [B, N, 3], noise [B, L]) -> (loss, pred)``; ``pred``
    [B, L, K, 3] f32 centre-relative patch reconstructions."""

    def __init__(self, config: MaeConfig = MaeConfig(), dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dtype
        C = cfg.trans_dim
        self.encoder = MiniPointNet(cfg.encoder_dims, dtype=dtype)
        self.reduce_dim = Dense(cfg.encoder_dims, C, dtype=dtype)
        self.pos_enc1 = Dense(3, 128, dtype=dtype)
        self.pos_enc2 = Dense(128, C, dtype=dtype)
        for i in range(cfg.depth):
            self.add_module(f"block_{i}", VitBlock(C, cfg.num_heads, dtype=dtype))
        self.enc_norm = LayerNormF32(C, eps=1e-6)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, C))
        self.pos_dec1 = Dense(3, 128, dtype=dtype)
        self.pos_dec2 = Dense(128, C, dtype=dtype)
        for i in range(cfg.decoder_depth):
            self.add_module(f"dec_block_{i}", VitBlock(C, cfg.num_heads, dtype=dtype))
        self.dec_norm = LayerNormF32(C, eps=1e-6)
        self.head = Dense(C, cfg.group_size * 3, dtype=dtype)

    def _pos(self, xyz: torch.Tensor, name: str) -> torch.Tensor:
        """Dense 128, tanh-GELU, Dense ``trans_dim``: the position MLP."""
        return getattr(self, f"{name}2")(gelu_tanh(getattr(self, f"{name}1")(xyz.to(self.dtype))))

    def _blocks(self, x: torch.Tensor, pos: torch.Tensor, prefix: str, depth: int) -> torch.Tensor:
        """``depth`` blocks on the "block" route, DropPath off (the
        reference's ``VitBlock.drop_path`` is 0)."""
        dp = torch.ones(x.shape[0], 2, device=x.device)
        for i in range(depth):
            x = getattr(self, f"{prefix}{i}")(x, pos, dp)
        return x

    def forward(self, pts: torch.Tensor, noise: torch.Tensor, train: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``train``: batch statistics in the group encoder's BatchNorms
        (and their running update)."""
        cfg = self.config
        dt = self.dtype
        B, L, K = pts.shape[0], cfg.num_group, cfg.group_size
        neighborhood, center = group_points(pts, L, K)
        tokens = self.reduce_dim(self.encoder(neighborhood, train))  # [B, L, C]
        ids_keep, ids_restore, _ = random_patch_masking(noise, cfg.mask_ratio)
        kept = _rows(tokens, ids_keep)
        pos_enc = self._pos(_rows(center, ids_keep), "pos_enc")
        # the encoder runs on the kept tokens only (the MAE efficiency trick)
        h = self._blocks(kept, pos_enc, "block_", cfg.depth)
        h = self.enc_norm(h.float()).to(dt)
        # the original order restored with mask tokens, full position embeddings
        masked = self.mask_token.to(dt).expand(B, L - h.shape[1], -1)
        full = _rows(torch.cat([h, masked], dim=1), ids_restore)
        d = self._blocks(full, self._pos(center, "pos_dec"), "dec_block_", cfg.decoder_depth)
        d = self.dec_norm(d.float()).to(dt)
        pred = self.head(d).reshape(B, L, K, 3).float()
        # per-patch Chamfer-L1 against the centre-relative groups
        loss = chamfer_l1(pred.reshape(B * L, K, 3), neighborhood.float().reshape(B * L, K, 3))
        return loss, pred


def init_mae(model: MaskedPointMAE, seed: int) -> MaskedPointMAE:
    """Random weights from ``seed`` with the reference's initialiser
    families: lecun-normal Dense kernels, zero biases, the mask token
    normal(0.02)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        init_dense_(model, gen)
        model.mask_token.copy_(torch.randn(model.mask_token.shape, generator=gen) * 0.02)
    return model
