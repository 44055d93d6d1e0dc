"""PromptLearner: learnable context tokens spliced into class prompts.

Counterpart of ``ppt_tpu/prompt/learner.py``. The splice plan is built
once on the host (``build_prompt_spec``, plain numpy, identical arrays to
the reference); the forward pass is one ``torch.where(mask,
learnable[ctx_idx], base)`` select.

Layouts: ``end`` [SOT][ctx][name][. EOT pad]; ``front`` [SOT][name][ctx]
[. EOT pad]; ``middle`` [SOT][ctx:half][name][ctx half:][. EOT pad]. The
EOT pooling position is the argmax of the unrearranged token ids.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ppt_torch.prompt.tokenizer import CONTEXT_LENGTH, ClipTokenizer


@dataclasses.dataclass(frozen=True)
class PromptSpec:
    """Host-precomputed splice plan for a classname set."""

    tokens: np.ndarray  # [C, L] i32 — tokenization of the raw prompts
    perm_tokens: np.ndarray  # [C, L] i32 — token ids rearranged to output order
    ctx_mask: np.ndarray  # [C, L] bool — True where a learnable token goes
    ctx_idx: np.ndarray  # [C, L] i32 — which learnable token (0 where unused)
    eot_pos: np.ndarray  # [C] i32 — pooling positions
    n_ctx: int
    name_lengths: np.ndarray  # [C] i32 — BPE length of each classname


def build_prompt_spec(
    classnames: Sequence[str],
    n_ctx: int = 32,
    class_name_position: str = "end",
    template_init: str = "",
    tokenizer: Optional[ClipTokenizer] = None,
    context_length: int = CONTEXT_LENGTH,
) -> PromptSpec:
    if tokenizer is None:
        tokenizer = ClipTokenizer()
    if class_name_position not in ("front", "middle", "end"):
        raise ValueError(
            f"class_name_position={class_name_position!r} not in ['front', 'middle', 'end']"
        )
    if template_init:
        phrase = template_init.replace("_", " ")
        n_ctx = len(phrase.split(" "))
        prefix = phrase
    else:
        prefix = " ".join(["X"] * n_ctx)

    names = [name.replace("_", " ") for name in classnames]
    name_lengths = np.array([len(tokenizer.encode(n)) for n in names], dtype=np.int32)
    tokens = tokenizer([f"{prefix} {name}." for name in names], context_length)
    C, L = tokens.shape
    half = n_ctx // 2
    perm_tokens = np.zeros_like(tokens)
    ctx_mask = np.zeros((C, L), dtype=bool)
    ctx_idx = np.zeros((C, L), dtype=np.int32)
    for c in range(C):
        ln = int(name_lengths[c])
        name_src = list(range(1 + n_ctx, 1 + n_ctx + ln))
        tail_src = list(range(1 + n_ctx + ln, L))
        ctx = [("ctx", k) for k in range(n_ctx)]
        if class_name_position == "end":
            plan = [("emb", 0)] + ctx + [("emb", s) for s in name_src + tail_src]
        elif class_name_position == "front":
            plan = [("emb", 0)] + [("emb", s) for s in name_src] + ctx + [
                ("emb", s) for s in tail_src]
        else:  # middle
            plan = (
                [("emb", 0)] + ctx[:half] + [("emb", s) for s in name_src] + ctx[half:]
                + [("emb", s) for s in tail_src]
            )
        if len(plan) != L:
            raise ValueError(f"prompt plan for {names[c]!r} has {len(plan)} != {L} slots")
        for p, (kind, v) in enumerate(plan):
            if kind == "emb":
                perm_tokens[c, p] = tokens[c, v]
            else:
                ctx_mask[c, p] = True
                ctx_idx[c, p] = v
    return PromptSpec(
        tokens=tokens,
        perm_tokens=perm_tokens,
        ctx_mask=ctx_mask,
        ctx_idx=ctx_idx,
        eot_pos=np.argmax(tokens, axis=1).astype(np.int32),
        n_ctx=n_ctx,
        name_lengths=name_lengths,
    )


class PromptLearner(nn.Module):
    """Holds the learnable context vectors and splices them into the
    embedded prompt base ``[C, L, width]``."""

    def __init__(self, n_ctx: int, width: int = 512):
        super().__init__()
        self.learnable_tokens = nn.Parameter(torch.zeros(n_ctx, width))

    def forward(self, base_embeds: torch.Tensor, ctx_mask: torch.Tensor,
                ctx_idx: torch.Tensor) -> torch.Tensor:
        spliced = self.learnable_tokens.to(base_embeds.dtype)[ctx_idx.long()]
        return torch.where(ctx_mask[..., None], spliced, base_embeds)
