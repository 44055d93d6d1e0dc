"""Cached-text evaluation for the contrastive cls path.

Counterpart of ``ppt_tpu/train/trainer.py:make_cached_text_eval``
(``:245-276``): the text tower runs once per validation pass, and each
batch then pays only for the point tower and one product.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch import nn

from ppt_torch.models.ulip import PromptArrays


def make_cached_text_eval(model: nn.Module) -> Tuple[Callable, Callable]:
    """Returns ``(embed_text(state, prompts) -> [C, E],
    eval_step(state, batch, text_embed) -> logits [B, C])``, where
    ``state`` is the model whose weights are evaluated (``model`` or a
    module of the same architecture)."""
    del model  # the weights come with `state`, as in the JAX contract

    @torch.no_grad()
    def embed_text(state: nn.Module, prompts: PromptArrays) -> torch.Tensor:
        return state.encode_text(prompts)

    @torch.no_grad()
    def eval_step(state: nn.Module, batch: Dict[str, torch.Tensor],
                  text_embed: torch.Tensor) -> torch.Tensor:
        pc_embed = state.encode_pc(batch["pc"])
        return torch.exp(state.logit_scale) * pc_embed @ text_embed.t()

    return embed_text, eval_step
