"""Discrete VAE point-cloud tokenizer (PointBERT's dVAE), channels-last.

Counterpart of ``ppt_tpu/nn/dvae.py:29-226`` (reference
``models/pointbert/dvae.py:19-344``): grouping by the FPS + kNN kernels,
the MiniPointNet group encoder on its fused kernels, a 4-round EdgeConv
(DGCNN) head giving per-group token logits, a Gumbel-softmax codebook
lookup, a second DGCNN and a folding decoder that rebuilds each
neighbourhood (coarse MLP points, then grid-folded fine points). Losses
(``dvae_loss``): coarse + fine Chamfer-L1 (or the auction EMD) per group,
plus a KL term pushing mean token usage toward uniform.

``train`` is an explicit argument, as in the point tower: batch statistics
in the encoder's and the decoder's BatchNorms (and their running update),
Gumbel noise drawn from ``generator``. The logits leave a f32 GroupNorm, so
the softmax and the codebook product run in f32 under bf16 too. Module and
parameter names mirror the flax tree, so ``convert.from_jax`` maps every
leaf one to one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ppt_torch.nn.layers import BatchNorm, Dense, GroupNorm, init_dense_, leaky_relu
from ppt_torch.nn.pointbert import MiniPointNet, group_points
from ppt_torch.ops.geometry import index_points, knn_point
from ppt_torch.ops.losses3d import chamfer_l1, earth_mover_distance
from ppt_torch.parallel import collectives as _dp


@dataclasses.dataclass(frozen=True)
class DvaeConfig:
    group_size: int = 32
    num_group: int = 64
    encoder_dims: int = 256
    tokens_dims: int = 256
    decoder_dims: int = 256
    num_tokens: int = 8192


class EdgeConvStack(nn.Module):
    """DGCNN feature head (``DGCNN``, dvae.py:19-112): an input transform,
    4 EdgeConv rounds over the k=4 nearest centres (edge feature
    ``[nbr - q, q]``, Dense, GroupNorm(4), leaky ReLU 0.2, max over the
    neighbours) and a fusion layer over the rounds' concatenated outputs."""

    WIDTHS = (256, 512, 512, 1024)

    def __init__(self, in_dim: int, output_channel: int, k: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.k = k
        self.input_trans = Dense(in_dim, 128, dtype=dtype)
        width = 128
        for i, w in enumerate(self.WIDTHS):
            self.add_module(f"layer{i + 1}", Dense(2 * width, w, bias=False, dtype=dtype))
            self.add_module(f"gn{i + 1}", GroupNorm(w))
            width = w
        self.layer5 = Dense(sum(self.WIDTHS), output_channel, bias=False, dtype=dtype)
        self.gn5 = GroupNorm(output_channel)

    def _edge(self, idx: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        nbrs = index_points(f, idx)  # [B, G, k, D]
        q = f[:, :, None, :].expand_as(nbrs)
        return torch.cat([nbrs - q, q], dim=-1)

    def forward(self, f: torch.Tensor, coor: torch.Tensor) -> torch.Tensor:
        """f [B, G, C], coor [B, G, 3] -> [B, G, output_channel] f32."""
        idx = knn_point(self.k, coor.detach(), coor.detach())  # plain; no gradient
        f = self.input_trans(f)
        feats = []
        for i in range(len(self.WIDTHS)):
            h = getattr(self, f"layer{i + 1}")(self._edge(idx, f))
            f = leaky_relu(getattr(self, f"gn{i + 1}")(h), 0.2).amax(dim=2)
            feats.append(f)
        return leaky_relu(self.gn5(self.layer5(torch.cat(feats, dim=-1))), 0.2)


class FoldingDecoder(nn.Module):
    """Per-group folding decoder (``Decoder``, dvae.py:226-280): a
    coarse-point MLP, then a 2 x 2 grid folded around each coarse point,
    with train-mode BatchNorms (momentum 0.99, the biased variance)."""

    def __init__(self, in_dim: int, num_fine: int, grid_size: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_fine = num_fine
        self.fold = grid_size ** 2
        self.num_coarse = num_fine // self.fold
        self.mlp1 = Dense(in_dim, 1024, dtype=dtype)
        self.mlp2 = Dense(1024, 1024, dtype=dtype)
        self.mlp3 = Dense(1024, 3 * self.num_coarse, dtype=dtype)
        self.final1 = Dense(in_dim + 2 + 3, 512, dtype=dtype)
        self.fbn1 = BatchNorm(512)
        self.final2 = Dense(512, 512, dtype=dtype)
        self.fbn2 = BatchNorm(512)
        self.final3 = Dense(512, 3, dtype=dtype)
        # the folding grid in [-0.05, 0.05]^2: stack([tile(lin, s), repeat(lin, s)])
        lin = torch.linspace(-0.05, 0.05, grid_size)
        seed = torch.stack([lin.repeat(grid_size), lin.repeat_interleave(grid_size)], dim=-1)
        self.register_buffer("seed", seed, persistent=False)  # [S, 2], not a weight

    def forward(self, feature: torch.Tensor,
                train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """feature [B, G, C] -> (coarse [B, G, num_fine / 4, 3], fine
        [B, G, num_fine, 3]), both in the compute dtype."""
        B, G, C = feature.shape
        dt = self.dtype
        h = torch.relu(self.mlp2(torch.relu(self.mlp1(feature))))
        coarse = self.mlp3(h).reshape(B, G, self.num_coarse, 3)
        center = coarse.repeat_interleave(self.fold, dim=2)  # [B, G, num_fine, 3]
        seeds = self.seed.repeat(self.num_coarse, 1).expand(B, G, self.num_fine, 2)
        glob = feature[:, :, None, :].expand(B, G, self.num_fine, C)
        # the concat promotes to f32 as jnp's does; final1 rounds it to dt
        feat = torch.cat([glob.float(), seeds.to(dt).float(), center.float()], dim=-1)
        x = torch.relu(self.fbn1(self.final1(feat), train))
        x = torch.relu(self.fbn2(self.final2(x), train))
        return coarse, self.final3(x) + center


class DiscreteVAE(nn.Module):
    """Point-cloud tokenizer (``DiscreteVAE``, dvae.py:283-344)."""

    def __init__(self, config: DvaeConfig = DvaeConfig(), dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.encoder = MiniPointNet(cfg.encoder_dims, dtype=dtype)
        self.dgcnn_1 = EdgeConvStack(cfg.encoder_dims, cfg.num_tokens, dtype=dtype)
        self.codebook = nn.Parameter(torch.zeros(cfg.num_tokens, cfg.tokens_dims))
        self.dgcnn_2 = EdgeConvStack(cfg.tokens_dims, cfg.decoder_dims, dtype=dtype)
        self.decoder = FoldingDecoder(cfg.decoder_dims, cfg.group_size, dtype=dtype)

    def group_logits(self, neighborhood: torch.Tensor, center: torch.Tensor,
                     train: bool = False) -> torch.Tensor:
        """Codebook logits per group [B, G, num_tokens] f32."""
        return self.dgcnn_1(self.encoder(neighborhood, train), center)

    def tokenize(self, neighborhood: torch.Tensor, center: torch.Tensor,
                 train: bool = False) -> torch.Tensor:
        """Discrete group ids [B, G]: the masked-point-modeling targets."""
        return self.group_logits(neighborhood, center, train).argmax(-1)

    def forward(self, pts: torch.Tensor, temperature: float = 1.0, hard: bool = False,
                train: bool = False, generator: Optional[torch.Generator] = None,
                uniforms: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """``train``: Gumbel noise ``-log(-log(U))`` on the logits, ``U``
        uniform in [1e-20, 1) drawn from ``generator`` (or ``uniforms``
        [B, G, num_tokens] as given); ``hard``: the straight-through one-hot."""
        cfg = self.config
        neighborhood, center = group_points(pts, cfg.num_group, cfg.group_size)
        logits = self.group_logits(neighborhood, center, train)
        if train:
            if uniforms is None:
                uniforms = torch.clamp_min(_dp.global_draw(torch.rand, logits.shape,
                                                           generator=generator,
                                                           device=logits.device), 1e-20)
            gumbel = -torch.log(-torch.log(uniforms.to(logits.device, torch.float32)))
            y = torch.softmax((logits + gumbel) / temperature, dim=-1)
        else:
            y = torch.softmax(logits / temperature, dim=-1)
        if hard:
            one_hot = F.one_hot(y.argmax(-1), cfg.num_tokens).to(y.dtype)
            y = one_hot + y - y.detach()  # straight-through
        sampled = y @ self.codebook.to(y.dtype)
        feature = self.dgcnn_2(sampled, center)
        coarse, fine = self.decoder(feature, train)
        B = pts.shape[0]
        return {
            "whole_coarse": (coarse + center[:, :, None, :]).reshape(B, -1, 3),
            "whole_fine": (fine + center[:, :, None, :]).reshape(B, -1, 3),
            "coarse": coarse,
            "fine": fine,
            "neighborhood": neighborhood,
            "logits": logits,
        }


def init_dvae(model: DiscreteVAE, seed: int) -> DiscreteVAE:
    """Random weights from ``seed`` with the reference's initialiser
    families: lecun-normal Dense kernels, zero biases, a unit-normal
    codebook; norms at scale 1 and bias 0."""
    gen = torch.Generator().manual_seed(seed)
    init_dense_(model, gen)
    with torch.no_grad():
        model.codebook.copy_(torch.randn(model.codebook.shape, generator=gen))
    return model


def dvae_loss(ret: Dict[str, torch.Tensor], num_tokens: int,
              recon: str = "chamfer") -> Tuple[torch.Tensor, torch.Tensor]:
    """(reconstruction, KL) (``DiscreteVAE.get_loss``, dvae.py:301-330):
    coarse + fine against each group's neighbourhood by Chamfer-L1
    (``recon="chamfer"``, the reference's default, plain on every device) or
    the auction EMD (``"emd"``, the kernel on the card); KL(uniform || the
    mean token distribution over groups), averaged over the batch."""
    B, G = ret["coarse"].shape[:2]
    coarse = ret["coarse"].reshape(B * G, -1, 3)
    fine = ret["fine"].reshape(B * G, -1, 3)
    gt = ret["neighborhood"].reshape(B * G, -1, 3)
    if recon == "emd":
        loss_recon = earth_mover_distance(coarse, gt) + earth_mover_distance(fine, gt)
    elif recon == "chamfer":
        loss_recon = chamfer_l1(coarse, gt) + chamfer_l1(fine, gt)
    else:
        raise ValueError(f"dvae_loss: recon {recon!r} not in ('chamfer', 'emd')")
    mean_softmax = torch.softmax(ret["logits"].float(), dim=-1).mean(1)  # [B, num_tokens]
    log_qy = torch.log(mean_softmax + 1e-10)
    log_uniform = torch.tensor(-math.log(num_tokens), dtype=torch.float32,
                               device=log_qy.device)
    loss_klv = (torch.exp(log_uniform) * (log_uniform - log_qy)).sum(-1).mean()
    return loss_recon, loss_klv
