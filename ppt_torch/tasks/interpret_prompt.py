"""Prompt interpretation: the vocabulary words nearest each learned context
vector.

Counterpart of ``ppt_tpu/tasks/interpret_prompt.py``: the Euclidean
distances from each of the ``n_ctx`` learned vectors to the rows of the
token-embedding table (49408 x 512 for CLIP) in the expanded form
``|c|^2 + |t|^2 - 2 c.t`` in f32, one ``[n_ctx, V]`` product on the
tensors' device; the ``topk`` nearest rows, a tie going to the lower index
(as ``lax.top_k`` orders them), decoded through the CLIP tokenizer with
``</w>`` stripped. ``main`` reads the prompt from the port's checkpoint at
``--fpath`` (``checkpoint_best.pt`` or its directory) and the table from
``<pretrained_dir>/slip_text.msgpack``.

    python -m ppt_torch.tasks.interpret_prompt --fpath outputs/cls \
        [--pretrained_dir data/pretrained_models] [--topk 5] [--device cpu]
"""

from __future__ import annotations

import logging
import os
import sys
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ppt_torch.ops.geometry import nearest_first
from ppt_torch.prompt.tokenizer import ClipTokenizer
from ppt_torch.tasks.args import TaskArgs, parse_args
from ppt_torch.train.checkpoint import FILE, load_params_file
from ppt_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

PROMPT_KEY = "prompt_learner.learnable_tokens"


def nearest_indices(ctx: torch.Tensor, table: torch.Tensor,
                    topk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indices [n_ctx, topk], distances [n_ctx, topk]) of the ``topk``
    rows of ``table`` [V, D] nearest each row of ``ctx`` [n_ctx, D], on
    their device, nearest first, ties to the lower index."""
    ctx, table = ctx.float(), table.float()
    d2 = (ctx * ctx).sum(-1)[:, None] + (table * table).sum(-1)[None, :] - 2.0 * ctx @ table.t()
    d2k, idx = nearest_first(d2, topk)
    return idx, torch.sqrt(torch.clamp_min(d2k, 0.0))


def nearest_words(learnable_tokens, token_embedding, topk: int = 5,
                  tokenizer: Optional[ClipTokenizer] = None) -> List[List[Tuple[str, float]]]:
    """Per context vector: the ``topk`` nearest (word, distance) pairs.
    Tensors stay on their device; numpy arrays are read on the CPU."""
    if tokenizer is None:
        tokenizer = ClipTokenizer()
    idx, dists = nearest_indices(torch.as_tensor(learnable_tokens),
                                 torch.as_tensor(token_embedding), topk)
    idx, dists = idx.cpu().numpy(), dists.cpu().numpy()
    return [[(tokenizer.decoder.get(int(i), "<unk>").replace("</w>", ""), float(d))
             for i, d in zip(irow, drow)] for irow, drow in zip(idx, dists)]


def load_prompt(path: str) -> torch.Tensor:
    """The learned context vectors [n_ctx, D] of a checkpoint the port
    wrote (``checkpoint_best.pt`` or the directory holding it)."""
    if os.path.isdir(path):
        path = os.path.join(path, FILE)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return payload["trainable"][PROMPT_KEY]


def main(args: Optional[Union[TaskArgs, Sequence[str]]] = None):
    """Print each context vector's nearest words (``ctx[ i]: 'word'(d.ddd),
    ...``); returns them."""
    if not isinstance(args, TaskArgs):
        args = parse_args(args)
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device or None)
    learnable = load_prompt(args.fpath).to(device)
    slip = load_params_file(os.path.join(args.pretrained_dir, "slip_text.msgpack"))
    table = torch.from_numpy(np.asarray(
        slip["params"]["text"]["token_embedding"]["embedding"], np.float32)).to(device)
    results = nearest_words(learnable, table, topk=args.topk)
    for i, row in enumerate(results):
        words = ", ".join(f"{w!r}({d:.3f})" for w, d in row)
        print(f"ctx[{i:2d}]: {words}")
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
