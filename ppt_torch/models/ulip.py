"""The ULIP composite: point encoder + prompt-tuned CLIP text tower.

Counterpart of ``ppt_tpu/models/ulip.py`` (PointBERT only in this
slice). Forward contract (classification)::

    pc_embed   = point_encoder(pc) @ pc_projection                 # [B, E]
    text_embed = normalize(text_tower(splice(prompts))[eot] @ proj) # [C, E]
    logits     = exp(logit_scale) * pc_embed @ text_embed.T

``text_embed`` is L2-normalised and ``pc_embed`` is NOT
(``ULIP_models.py:276-281``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ppt_torch.nn.layers import Dense
from ppt_torch.nn.pointbert import PointBert, PointBertConfig
from ppt_torch.nn.text import TextConfig, TextTransformer
from ppt_torch.prompt.learner import PromptLearner, PromptSpec
from ppt_torch.utils.device import resolve_device, resolve_dtype


@dataclasses.dataclass(frozen=True)
class PromptArrays:
    """Device-side view of a PromptSpec, passed to the model per call."""

    perm_tokens: torch.Tensor  # [C, L] int
    ctx_mask: torch.Tensor  # [C, L] bool
    ctx_idx: torch.Tensor  # [C, L] int
    eot_pos: torch.Tensor  # [C] int

    @classmethod
    def from_spec(cls, spec: PromptSpec, device=None) -> "PromptArrays":
        """Device tensors with the context TRUNCATED to ``max(eot) + 1``
        rounded up to 16: the tower is causal and pools at EOT, so later
        positions never reach the output (``models/ulip.py:76-87``)."""
        dev = resolve_device(device)
        used = int(spec.eot_pos.max()) + 1
        L = min(spec.perm_tokens.shape[1], ((used + 15) // 16) * 16)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        return cls(
            perm_tokens=t(spec.perm_tokens[:, :L].astype(np.int64)),
            ctx_mask=t(spec.ctx_mask[:, :L]),
            ctx_idx=t(spec.ctx_idx[:, :L].astype(np.int64)),
            eot_pos=t(spec.eot_pos.astype(np.int64)),
        )


class Ulip(nn.Module):
    """Composite prompt-tuned multimodal model (cls task)."""

    def __init__(self, point_encoder: nn.Module, pc_feat_dims: int, n_ctx: int = 32,
                 text_config: TextConfig = TextConfig(), dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.text = TextTransformer(text_config, dtype=dtype)
        self.prompt_learner = PromptLearner(n_ctx, text_config.width)
        self.pc_projection = nn.Parameter(torch.zeros(pc_feat_dims, text_config.embed_dim))
        self.logit_scale = nn.Parameter(torch.tensor(float(np.log(1.0 / 0.07))))
        self.point_encoder = point_encoder

    def encode_text(self, prompts: PromptArrays) -> torch.Tensor:
        """All-class text embeddings, L2-normalised, [C, E] f32."""
        base = self.text.embed(prompts.perm_tokens)
        spliced = self.prompt_learner(base, prompts.ctx_mask, prompts.ctx_idx)
        emb = self.text(spliced, prompts.eot_pos).float()
        return emb / torch.linalg.norm(emb, dim=-1, keepdim=True)

    def encode_pc(self, pc: torch.Tensor, train: bool = False,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Point embeddings [B, E] f32, deliberately NOT normalised.
        ``train`` puts the point tower in training mode (batch statistics,
        DropPath from ``generator``) whether or not its weights train."""
        feat = self.point_encoder(pc, train=train, generator=generator)
        return feat.float() @ self.pc_projection

    def forward(self, pc: torch.Tensor, prompts: PromptArrays, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        pc_embed = self.encode_pc(pc, train=train, generator=generator)
        text_embed = self.encode_text(prompts)
        return torch.exp(self.logit_scale) * pc_embed @ text_embed.t()


@torch.no_grad()
def init_weights(model: Ulip, seed: int) -> Ulip:
    """Random weights from ``seed`` (on the CPU generator, so every device
    gets the same values), with the reference's initialiser families:
    lecun-normal Dense kernels, zero biases, normal embeddings."""
    gen = torch.Generator().manual_seed(seed)

    def normal_(p: torch.Tensor, std: float) -> None:
        p.copy_(torch.randn(p.shape, generator=gen) * std)

    for mod in model.modules():
        if isinstance(mod, Dense):
            normal_(mod.kernel, 1.0 / math.sqrt(mod.kernel.shape[0]))
            if mod.bias is not None:
                mod.bias.zero_()
    text = model.text
    normal_(text.token_embedding.weight, 0.02)
    normal_(text.positional_embedding, 0.01)
    normal_(text.text_projection, text.config.width ** -0.5)
    normal_(model.prompt_learner.learnable_tokens, 0.02)
    normal_(model.pc_projection, 512 ** -0.5)
    if isinstance(model.point_encoder, PointBert):
        normal_(model.point_encoder.cls_pos, 1.0)
    return model


@dataclasses.dataclass
class ModelSpec:
    model: Ulip
    pc_feat_dims: int
    name: str


def _make(name: str, encoder: nn.Module, pc_feat_dims: int, args, dtype) -> ModelSpec:
    model = Ulip(
        point_encoder=encoder,
        pc_feat_dims=pc_feat_dims,
        n_ctx=getattr(args, "num_learnable_prompt_tokens", 32),
        text_config=getattr(args, "text_config", None) or TextConfig(),
        dtype=dtype,
    )
    return ModelSpec(model=model, pc_feat_dims=pc_feat_dims, name=name)


def ulip_pointbert(args) -> ModelSpec:
    """ULIP-PointBERT (PPT-Base). ``args.pointbert_config`` may override
    the PointBERT config (tests shrink it)."""
    dt = resolve_dtype(getattr(args, "compute_dtype", "float32"))
    cfg = getattr(args, "pointbert_config", None) or PointBertConfig()
    return _make("ULIP_PointBERT", PointBert(cfg, dtype=dt), 2 * cfg.trans_dim, args, dt)


MODEL_REGISTRY: Dict[str, Callable[..., ModelSpec]] = {"ULIP_PointBERT": ulip_pointbert}


# ---------------------------------------------------------------------------
# Freeze partition (``models/ulip.py:295-361``)
# ---------------------------------------------------------------------------

# PointAdapter: the progressively unfrozen tensors of the last PointBERT
# block, by head type.
_HEAD_TYPE_UNFREEZE: Dict[int, Tuple[Tuple[str, ...], ...]] = {
    1: (("point_encoder", "block_11", "norm2"), ("point_encoder", "block_11", "mlp", "fc2")),
    2: (("point_encoder", "block_11", "norm1"), ("point_encoder", "block_11", "mlp", "fc1")),
    3: (("point_encoder", "block_11", "attn", "qkv"),
        ("point_encoder", "block_11", "attn", "proj")),
}

# partseg: the point encoder's subtrees outside the pretrained trunk train.
# Listed for the part-segmentation slice; no model of the port has them yet.
_PARTSEG_TRAINABLE_SUBTREES = ("propagation_0", "propagation_1", "propagation_2",
                               "dgcnn_pro_1", "dgcnn_pro_2", "conv1", "bn1")


def trainable_mask(model: nn.Module, head_type: int = 0, task: str = "cls") -> Dict[str, bool]:
    """Which parameters train, by ``named_parameters`` name.

    Prompt tasks (cls, fewshot): always ``prompt_learner.*``; head types
    1 to 3 progressively add the PointAdapter leaves of ``block_11``.
    ``task='pretrain'`` instead trains the point encoder, ``pc_projection``
    and ``logit_scale`` against the frozen text tower."""
    if task == "partseg":
        raise NotImplementedError("the partseg trainable subtrees "
                                  f"{_PARTSEG_TRAINABLE_SUBTREES} are not ported yet")

    def is_trainable(path: Tuple[str, ...]) -> bool:
        if task == "pretrain":
            return path[0] in ("point_encoder", "pc_projection", "logit_scale")
        if "prompt_learner" in path:
            return True
        return any(path[:len(prefix)] == prefix
                   for ht, prefixes in _HEAD_TYPE_UNFREEZE.items() if head_type >= ht
                   for prefix in prefixes)

    return {name: is_trainable(tuple(name.split("."))) for name, _ in model.named_parameters()}


def apply_trainable_mask(model: nn.Module, mask: Dict[str, bool]) -> Dict[str, nn.Parameter]:
    """Set ``requires_grad`` from ``mask``; returns the trainable
    parameters by name. Frozen leaves get no gradient at all (not the
    [49408, 512] token embedding either): gradients only flow THROUGH them."""
    trainable = {}
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            trainable[name] = p
    return trainable


def build_model(name: str, args, device=None, seed: Optional[int] = None) -> ModelSpec:
    """Build ``name`` on ``device`` (the card unless told otherwise), in
    eval mode, with weights drawn from ``seed`` (default ``args.seed``)."""
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {sorted(MODEL_REGISTRY)}")
    dev = resolve_device(device)
    spec = MODEL_REGISTRY[name](args)
    init_weights(spec.model, getattr(args, "seed", 0) if seed is None else seed)
    spec.model.to(dev).eval()
    return spec
