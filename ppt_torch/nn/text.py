"""CLIP text tower (reference ``models/ULIP_models.py:154-230``).

Counterpart of ``ppt_tpu/nn/text.py``: token embedding, learned
positional embedding, pre-norm residual blocks with fused-QKV causal
attention and QuickGELU, f32 final LayerNorm, EOT-token pooling and the
f32 ``text_projection``.

The tower runs by one of three routes, chosen by the constructor's
``fused`` argument (the reference chooses with ``PPT_FUSED_TEXT`` and
``PPT_FUSED_TEXT_TOWER``, ``nn/text.py:90-113`` and ``:209-247``; the
port's entry point reads those and passes the choice down):

- ``"off"`` (the default, as in the reference): plain PyTorch, module by
  module, rounding as flax's ``Dense(dtype=...)`` does: the product is
  rounded to the compute dtype and the cast bias added in it; attention
  is written out with f32 scores and softmax, P cast before ``P @ V``.
- ``"block"``: each block is one call of ``kernels/textblock.py``, which
  adds the bias in f32 before the cast.
- ``"tower"``: the blocks, the pooling, ``ln_final`` and the projection
  are one call of ``kernels/texttower.py``, which rounds as ``"off"``
  does but pools before ``ln_final`` and has a hand-written backward
  kernel for the input cotangent. It returns before the blocks run, so it
  wins over ``"block"``.

The kernels take the weights in the compute dtype, the tower's stacked on
a depth axis. The text tower is frozen in every task, so those copies are
built once and rebuilt only when a source parameter changed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ppt_torch.kernels.textblock import MATRICES, fused_text_block
from ppt_torch.kernels.texttower import fused_text_tower
from ppt_torch.nn.layers import CastCache, Dense, LayerNormF32, quick_gelu

TEXT_ROUTES = ("off", "block", "tower")


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
        heads = self.heads
        tp = getattr(self, "tp", None)
        if tp is not None:  # this rank's heads: in_proj's columns of them, out_proj's rows
            from ppt_torch.parallel.sharding import column_parallel, row_parallel

            heads, D = tp.split(heads, "heads"), tp.split(D, "width")
            qkv = column_parallel(x, self.in_proj, tp, fused3=True)
        else:
            qkv = self.in_proj(x)
        q, k, v = (t.reshape(B, L, heads, hd).transpose(1, 2) for t in qkv.split(D, -1))
        s = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / math.sqrt(hd))
        if mask is not None:
            s = s + mask
        p = torch.softmax(s, dim=-1).to(v.dtype)
        out = (p.float() @ v.float()).to(x.dtype)
        if tp is not None:
            return row_parallel(out.transpose(1, 2).reshape(B, L, D), self.out_proj, tp)
        return self.out_proj(out.transpose(1, 2).reshape(B, L, D))


class TextBlock(nn.Module):
    """Pre-norm residual attention block (``ResidualAttentionBlock``).
    With ``fused`` the whole block is one ``fused_text_block`` call, on
    ``weights`` where the caller keeps the cast copies (``TextTransformer``
    does), else on copies cast in this call."""

    def __init__(self, width: int, heads: int, dtype: torch.dtype = torch.float32,
                 fused: bool = False):
        super().__init__()
        self.heads = heads
        self.dtype = dtype
        self.fused = fused
        self.ln_1 = LayerNormF32(width)
        self.attn = FusedQKVAttention(width, heads, dtype=dtype)
        self.ln_2 = LayerNormF32(width)
        self.c_fc = Dense(width, 4 * width, dtype=dtype)
        self.c_proj = Dense(4 * width, width, dtype=dtype)

    def kernel_params(self) -> List[torch.Tensor]:
        """The block's 12 parameters in the kernels' argument order."""
        return [self.ln_1.weight, self.ln_1.bias,
                self.attn.in_proj.kernel, self.attn.in_proj.bias,
                self.attn.out_proj.kernel, self.attn.out_proj.bias,
                self.ln_2.weight, self.ln_2.bias,
                self.c_fc.kernel, self.c_fc.bias, self.c_proj.kernel, self.c_proj.bias]

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                weights: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        tp = getattr(self, "tp", None)
        if self.fused and tp is None:
            if mask is None:
                raise ValueError("fused_text_block: the kernel bakes in the causal mask; call "
                                 "with the mask or build the block with fused=False")
            if weights is None:
                weights = [p.to(self.dtype) if i in MATRICES else p
                           for i, p in enumerate(self.kernel_params())]
            return fused_text_block(x, *weights, self.heads)
        x = x + self.attn(self.ln_1(x), mask)
        if tp is not None:  # c_fc on its columns, c_proj on its rows, one all-reduce
            from ppt_torch.parallel.sharding import column_parallel, row_parallel

            return x + row_parallel(quick_gelu(column_parallel(self.ln_2(x), self.c_fc, tp)),
                                    self.c_proj, tp)
        return x + self.c_proj(quick_gelu(self.c_fc(self.ln_2(x))))


class TextTransformer(nn.Module):
    """CLIP text encoder over pre-built prompt embeddings.

    ``embed(tokens)``: token ids -> embeddings; ``forward(prompt_embeds,
    eot_positions)``: the tower over ``[C, L, width]`` (L may be shorter
    than ``context_length``), pooled at the EOT position and projected,
    unnormalised ``[C, embed_dim]``."""

    def __init__(self, config: TextConfig = TextConfig(), dtype: torch.dtype = torch.float32,
                 fused: str = "off"):
        super().__init__()
        if fused not in TEXT_ROUTES:
            raise ValueError(f"text route {fused!r} not in {TEXT_ROUTES}")
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.fused = fused
        self._cache = CastCache()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.positional_embedding = nn.Parameter(torch.zeros(cfg.context_length, cfg.width))
        for i in range(cfg.layers):
            self.add_module(f"block_{i}", TextBlock(cfg.width, cfg.heads, dtype=dtype,
                                                    fused=fused == "block"))
        self.ln_final = LayerNormF32(cfg.width)
        self.text_projection = nn.Parameter(torch.zeros(cfg.width, cfg.embed_dim))
        self.register_buffer(
            "mask", torch.from_numpy(causal_mask(cfg.context_length)), persistent=False
        )

    def stacked_weights(self) -> Tuple[torch.Tensor, ...]:
        """The 15 weights ``fused_text_tower`` takes: the blocks' stacked
        on a leading depth axis with the matrices cast to the compute
        dtype, then ``ln_final`` and ``text_projection``. The block route
        takes layer ``i``'s slice of the first twelve, so the one cache
        serves both routes."""
        blocks = [getattr(self, f"block_{i}").kernel_params()
                  for i in range(self.config.layers)]
        dt = self.dtype

        def build():
            stacks = [torch.stack([b[j] for b in blocks]) for j in range(12)]
            return tuple(s.to(dt) if j in MATRICES else s for j, s in enumerate(stacks))

        stacked = self._cache.get([p for b in blocks for p in b], dt, build)
        return (*stacked, self.ln_final.weight, self.ln_final.bias, self.text_projection)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        tp = getattr(self, "tp", None)
        if tp is not None:  # the lookup on this rank's features, then all of them
            from ppt_torch.parallel.sharding import gather_features

            return gather_features(self.token_embedding(tokens.long()), tp)
        return self.token_embedding(tokens.long())

    def forward(self, prompt_embeds: torch.Tensor, eot_positions: torch.Tensor) -> torch.Tensor:
        L = prompt_embeds.shape[1]
        if L > self.config.context_length:
            raise ValueError(
                f"prompt length {L} exceeds context_length {self.config.context_length}"
            )
        dt = self.dtype
        x = prompt_embeds.to(dt) + self.positional_embedding[:L].to(dt)
        fused = self.fused if getattr(self, "tp", None) is None else "off"  # shards: "off"
        if fused == "tower":
            eot_onehot = (torch.arange(L, device=x.device)[None, :]
                          == eot_positions.long()[:, None]).float()
            return fused_text_tower(x, eot_onehot, *self.stacked_weights(),
                                    self.config.heads).to(dt)
        mask = self.mask[:L, :L]
        stacked = self.stacked_weights()[:12] if fused == "block" else None
        for i in range(self.config.layers):
            weights = stacked and [s[i] for s in stacked]
            x = getattr(self, f"block_{i}")(x, mask, weights)
        x = self.ln_final(x)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot_positions.long()]
        return (pooled.float() @ self.text_projection).to(dt)
