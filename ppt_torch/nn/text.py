"""CLIP text tower (reference ``models/ULIP_models.py:154-230``).

Counterpart of ``ppt_tpu/nn/text.py``: token embedding, learned
positional embedding, pre-norm residual blocks with fused-QKV causal
attention and QuickGELU, f32 final LayerNorm, EOT-token pooling and the
f32 ``text_projection``. The reference package runs no kernel here by
default (``nn/text.py:90-96``, ``:209-215``), so this is plain PyTorch.
Attention is written out (f32 scores and softmax) rather than handed to
a fused library operator.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ppt_torch.nn.layers import Dense, LayerNormF32, quick_gelu


@dataclasses.dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 49408
    context_length: int = 77
    width: int = 512
    layers: int = 12
    heads: int = 8
    embed_dim: int = 512  # joint space


def causal_mask(length: int) -> np.ndarray:
    """Additive causal mask, -inf above the diagonal."""
    mask = np.zeros((length, length), dtype=np.float32)
    mask[np.triu_indices(length, k=1)] = -np.inf
    return mask


class FusedQKVAttention(nn.Module):
    """Multi-head self-attention with a fused QKV projection (torch
    ``nn.MultiheadAttention``'s ``in_proj``/``out_proj`` layout)."""

    def __init__(self, width: int, heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = heads
        self.in_proj = Dense(width, 3 * width, dtype=dtype)
        self.out_proj = Dense(width, width, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, L, D = x.shape
        hd = D // self.heads
        qkv = self.in_proj(x)
        q, k, v = (t.reshape(B, L, self.heads, hd).transpose(1, 2) for t in qkv.split(D, -1))
        s = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / math.sqrt(hd))
        if mask is not None:
            s = s + mask
        p = torch.softmax(s, dim=-1).to(v.dtype)
        out = (p.float() @ v.float()).to(x.dtype)
        return self.out_proj(out.transpose(1, 2).reshape(B, L, D))


class TextBlock(nn.Module):
    """Pre-norm residual attention block (``ResidualAttentionBlock``)."""

    def __init__(self, width: int, heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ln_1 = LayerNormF32(width)
        self.attn = FusedQKVAttention(width, heads, dtype=dtype)
        self.ln_2 = LayerNormF32(width)
        self.c_fc = Dense(width, 4 * width, dtype=dtype)
        self.c_proj = Dense(4 * width, width, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.c_proj(quick_gelu(self.c_fc(self.ln_2(x))))


class TextTransformer(nn.Module):
    """CLIP text encoder over pre-built prompt embeddings.

    ``embed(tokens)``: token ids -> embeddings; ``forward(prompt_embeds,
    eot_positions)``: the tower over ``[C, L, width]`` (L may be shorter
    than ``context_length``), pooled at the EOT position and projected,
    unnormalised ``[C, embed_dim]``."""

    def __init__(self, config: TextConfig = TextConfig(), dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.positional_embedding = nn.Parameter(torch.zeros(cfg.context_length, cfg.width))
        for i in range(cfg.layers):
            self.add_module(f"block_{i}", TextBlock(cfg.width, cfg.heads, dtype=dtype))
        self.ln_final = LayerNormF32(cfg.width)
        self.text_projection = nn.Parameter(torch.zeros(cfg.width, cfg.embed_dim))
        self.register_buffer(
            "mask", torch.from_numpy(causal_mask(cfg.context_length)), persistent=False
        )

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.token_embedding(tokens.long())

    def forward(self, prompt_embeds: torch.Tensor, eot_positions: torch.Tensor) -> torch.Tensor:
        L = prompt_embeds.shape[1]
        if L > self.config.context_length:
            raise ValueError(
                f"prompt length {L} exceeds context_length {self.config.context_length}"
            )
        dt = self.dtype
        x = prompt_embeds.to(dt) + self.positional_embedding[:L].to(dt)
        mask = self.mask[:L, :L]
        for i in range(self.config.layers):
            x = getattr(self, f"block_{i}")(x, mask)
        x = self.ln_final(x)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot_positions.long()]
        return (pooled.float() @ self.text_projection).to(dt)
