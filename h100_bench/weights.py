"""Seeded weights on the device, in the layout the benchmark hands out.

Both towers' weights are named as ``ppt_torch``'s ``state_dict`` names
them (``Dense`` kernels ``[in, out]``), so the program takes them with a
strict ``load_state_dict`` and the references look them up by the same
names. Every tensor comes out of one normal draw on the card: Dense
kernels lecun-normal (std ``1 / sqrt(fan_in)``), biases and embeddings
small, norm scales near 1 and running variances near 1, so that no part of
a check sees a zero or a one where a bug could hide.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

WEIGHT_SALT = 1 << 40  # the weights' stream, apart from the clouds'

Shapes = Dict[str, Tuple[int, ...]]


def _rule(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(mean, std) of the normal draw for ``name``."""
    if name.endswith("pc_projection"):
        # std 1 / fan_in keeps the unnormalised point embedding near unit
        # norm, so 14.3 x its cosines leave the 40-way softmax unsaturated;
        # at 1 / sqrt(fan_in) the logits reach tens and a rounding flips a
        # cloud's top class, which no precision comparison survives
        return 0.0, 1.0 / shape[0]
    if name.endswith(".kernel") or name.endswith("text_projection"):
        return 0.0, 1.0 / math.sqrt(shape[0])
    if name.endswith("running_var"):
        return 1.0, 0.1
    if name.endswith(".weight") and len(shape) == 1:  # LayerNorm and BatchNorm scales
        return 1.0, 0.1
    if name.endswith("logit_scale"):
        return math.log(1.0 / 0.07), 0.0
    if name.endswith("cls_pos"):
        return 0.0, 1.0
    if name.endswith("positional_embedding"):
        return 0.0, 0.01
    if name.endswith("running_mean"):
        return 0.0, 0.1
    return 0.0, 0.02  # biases, the token embedding, prompt tokens, the class token


def make(shapes: Shapes, seed: int, device) -> Dict[str, torch.Tensor]:
    """``{name: f32 tensor}`` from one draw of ``torch.randn`` on ``device``."""
    sizes = [math.prod(s) for s in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(seed + WEIGHT_SALT)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, off = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        mean, std = _rule(name, shape)
        out[name] = flat[off:off + n].view(shape) * std + mean
        off += n
    return out


def dense(shapes: Shapes, name: str, n_in: int, n_out: int, bias: bool = True) -> None:
    shapes[name + ".kernel"] = (n_in, n_out)
    if bias:
        shapes[name + ".bias"] = (n_out,)


def norm(shapes: Shapes, name: str, width: int, running: bool = False) -> None:
    shapes[name + ".weight"] = (width,)
    shapes[name + ".bias"] = (width,)
    if running:
        shapes[name + ".running_mean"] = (width,)
        shapes[name + ".running_var"] = (width,)


def ulip_shapes(text: Dict, n_ctx: int, feat_dims: int) -> Shapes:
    """The prompt-tuned CLIP text tower, the projection and the logit scale."""
    W, E = text["width"], text["embed_dim"]
    s: Shapes = {"pc_projection": (feat_dims, E), "logit_scale": (),
                 "text.positional_embedding": (text["context_length"], W),
                 "text.text_projection": (W, E),
                 "text.token_embedding.weight": (text["vocab_size"], W)}
    for i in range(text["layers"]):
        p = f"text.block_{i}."
        norm(s, p + "ln_1", W)
        dense(s, p + "attn.in_proj", W, 3 * W)
        dense(s, p + "attn.out_proj", W, W)
        norm(s, p + "ln_2", W)
        dense(s, p + "c_fc", W, 4 * W)
        dense(s, p + "c_proj", 4 * W, W)
    norm(s, "text.ln_final", W)
    s["prompt_learner.learnable_tokens"] = (n_ctx, W)
    return s
