"""The ULIP composite: point encoder + prompt-tuned CLIP text tower.

Counterpart of ``ppt_tpu/models/ulip.py`` with every entry of its
registry: PointBERT, PointBERT's part-segmentation trunk, PointNet++ SSG
and MSG, PointMLP, PointNeXt-S, PointNet with and without T-Nets, DGCNN,
PCT and CurveNet, and the template factory ``ulip_customized`` for a
caller's own tower. Forward contract (classification; ULIP pretraining
pairs ``encode_pc`` with ``encode_captions``)::

    pc_embed   = point_encoder(pc) @ pc_projection                 # [B, E]
    text_embed = normalize(text_tower(splice(prompts))[eot] @ proj) # [C, E]
    logits     = exp(logit_scale) * pc_embed @ text_embed.T

Part segmentation (``task="partseg"``) conditions the point tower on the
object category's one-hot and embeds every point: ``pc_embed`` is
``[B, N, E]`` and the logits ``[B, N, C]`` over the part prompts.

``text_embed`` is L2-normalised and ``pc_embed`` is NOT
(``ULIP_models.py:276-281``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ppt_torch.nn.classic import DgcnnClassifier, PointNetClassic, PointNetEncoder
from ppt_torch.nn.curvenet import CurveNet, CurveNetConfig, Walk
from ppt_torch.nn.layers import init_dense_
from ppt_torch.nn.pct import Pct
from ppt_torch.nn.pointbert import PointBert, PointBertConfig, PointBertPartSeg
from ppt_torch.nn.pointmlp import PointMLP, PointMLPConfig
from ppt_torch.nn.pointnet2 import PointNet2Msg, PointNet2Ssg
from ppt_torch.nn.pointnext import PointNext, PointNextConfig
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
    """Composite prompt-tuned multimodal model; ``task`` is "cls" or
    "partseg" (the point tower then takes the category one-hot)."""

    def __init__(self, point_encoder: nn.Module, pc_feat_dims: int, n_ctx: int = 32,
                 text_config: TextConfig = TextConfig(), dtype: torch.dtype = torch.float32,
                 text_fused: str = "off", task: str = "cls"):
        super().__init__()
        self.dtype = dtype
        self.task = task
        self.text = TextTransformer(text_config, dtype=dtype, fused=text_fused)
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

    def encode_captions(self, tokens: torch.Tensor) -> torch.Tensor:
        """Raw caption tokens [B, 77] -> L2-normalised text embeddings [B, E]
        f32 (``models/ulip.py:124-134``): ULIP pretraining's path, no prompt
        learner, pooled at the EOT token (the largest id), on whichever text
        route the model was built with."""
        tokens = tokens.long()
        emb = self.text(self.text.embed(tokens), tokens.argmax(-1)).float()
        return emb / torch.linalg.norm(emb, dim=-1, keepdim=True)

    def encode_pc(self, pc: torch.Tensor, train: bool = False,
                  generator: Optional[torch.Generator] = None,
                  cls_onehot: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Point embeddings f32, deliberately NOT normalised: [B, E], or
        [B, N, E] for partseg, whose tower also takes ``cls_onehot`` [B, 16].
        ``train`` puts the point tower in training mode (batch statistics,
        DropPath and dropout from ``generator``) whether or not its weights
        train."""
        if self.task == "partseg":
            feat = self.point_encoder(pc, cls_onehot, train=train, generator=generator)
        else:
            feat = self.point_encoder(pc, train=train, generator=generator)
        return feat.float() @ self.pc_projection

    def forward(self, pc: torch.Tensor, prompts: PromptArrays, train: bool = False,
                generator: Optional[torch.Generator] = None,
                cls_onehot: Optional[torch.Tensor] = None) -> torch.Tensor:
        pc_embed = self.encode_pc(pc, train=train, generator=generator, cls_onehot=cls_onehot)
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

    init_dense_(model, gen)
    for mod in model.modules():
        if isinstance(mod, Walk):  # CurveNet's walks keep their kernels as direct parameters
            for p in (mod.agent_kernel, mod.momentum_kernel):
                normal_(p, p.shape[0] ** -0.5)
    text = model.text
    normal_(text.token_embedding.weight, 0.02)
    normal_(text.positional_embedding, 0.01)
    normal_(text.text_projection, text.config.width ** -0.5)
    normal_(model.prompt_learner.learnable_tokens, 0.02)
    normal_(model.pc_projection, 512 ** -0.5)
    if isinstance(model.point_encoder, PointBert):  # PointBertPartSeg is one too
        normal_(model.point_encoder.cls_pos, 1.0)
    return model


@dataclasses.dataclass
class ModelSpec:
    model: Ulip
    pc_feat_dims: int
    name: str


def _make(name: str, encoder: nn.Module, pc_feat_dims: int, args, dtype,
          text_fused: str, task: str = "cls") -> ModelSpec:
    model = Ulip(
        point_encoder=encoder,
        pc_feat_dims=pc_feat_dims,
        n_ctx=getattr(args, "num_learnable_prompt_tokens", 32),
        text_config=getattr(args, "text_config", None) or TextConfig(),
        dtype=dtype,
        text_fused=text_fused,
        task=task,
    )
    return ModelSpec(model=model, pc_feat_dims=pc_feat_dims, name=name)


def _xyz_only(name: str, args) -> None:
    """The reference lets flax infer a 4-wide first layer and then samples
    and groups in 4-D; the port's grouping kernels take xyz, so a tower that
    has no use for the height refuses it by name."""
    if getattr(args, "use_height", False):
        raise NotImplementedError(f"--use_height appends the height as a 4th channel, and "
                                  f"{name} takes xyz only")


def ulip_pointbert(args, text_fused: str = "off") -> ModelSpec:
    """ULIP-PointBERT (PPT-Base). ``args.pointbert_config`` may override
    the PointBERT config (tests shrink it) and ``args.point_route`` the
    trunk's route (``nn/pointbert.py``, "block" without it; ``cls.setup``
    sets it from the reference's switches); ``text_fused`` is the text
    tower's route (``nn/text.py``)."""
    _xyz_only("ULIP_PointBERT", args)
    dt = resolve_dtype(getattr(args, "compute_dtype", "float32"))
    cfg = getattr(args, "pointbert_config", None) or PointBertConfig()
    route = getattr(args, "point_route", "block")
    return _make("ULIP_PointBERT", PointBert(cfg, dtype=dt, route=route), 2 * cfg.trans_dim,
                 args, dt, text_fused)


def ulip_pointbert_partseg(args, text_fused: str = "off") -> ModelSpec:
    """ULIP-PointBERT for part segmentation (``ppt_tpu/models/ulip.py:
    222-226``): the dense trunk, 128-d per-point features projected against
    the part prompts. ``args.pointbert_config`` and ``args.point_route`` as
    in ``ulip_pointbert``."""
    _xyz_only("ULIP_PointBERT_partseg", args)
    dt = resolve_dtype(getattr(args, "compute_dtype", "float32"))
    cfg = getattr(args, "pointbert_config", None) or PointBertConfig()
    route = getattr(args, "point_route", "block")
    return _make("ULIP_PointBERT_partseg", PointBertPartSeg(cfg, dtype=dt, route=route), 128,
                 args, dt, text_fused, task="partseg")


def ulip_pn_ssg(args, text_fused: str = "off") -> ModelSpec:
    """ULIP over the PointNet++ single-scale trunk."""
    _xyz_only("ULIP_PN_SSG", args)
    dt = resolve_dtype(getattr(args, "compute_dtype", "float32"))
    return _make("ULIP_PN_SSG", PointNet2Ssg(dtype=dt), 256, args, dt, text_fused)


def ulip_pn_msg(args, text_fused: str = "off") -> ModelSpec:
    """ULIP over the PointNet++ multi-scale trunk."""
    _xyz_only("ULIP_PN_MSG", args)
    dt = resolve_dtype(getattr(args, "compute_dtype", "float32"))
    return _make("ULIP_PN_MSG", PointNet2Msg(dtype=dt), 256, args, dt, text_fused)


def ulip_pn_mlp(args, text_fused: str = "off") -> ModelSpec:
    """ULIP over PointMLP (the reference's ``pointMLP()``), the compute
    dtype threaded into the tower. ``args.pointmlp_config`` may override
    the config (tests shrink it)."""
    _xyz_only("ULIP_PN_MLP", args)
    dt = resolve_dtype(getattr(args, "compute_dtype", "float32"))
    cfg = getattr(args, "pointmlp_config", None) or PointMLPConfig()
    return _make("ULIP_PN_MLP", PointMLP(cfg, dtype=dt), 256, args, dt, text_fused)


def ulip_pn_next(args, text_fused: str = "off") -> ModelSpec:
    """ULIP over PointNeXt-S. The stem is as wide as the input: 4 channels
    with ``--use_height`` (the published network), else 3, as the
    reference's shape inference has it. ``args.pointnext_config`` may
    override the config (tests shrink it)."""
    dt = resolve_dtype(getattr(args, "compute_dtype", "float32"))
    cfg = getattr(args, "pointnext_config", None) or PointNextConfig(
        in_channels=4 if getattr(args, "use_height", False) else 3)
    return _make("ULIP_PN_NEXT", PointNext(cfg, dtype=dt), cfg.head_mlps[-1], args, dt,
                 text_fused)


def ulip_customized(args, encoder: nn.Module, pc_feat_dims: int = 512,
                    text_fused: str = "off") -> ModelSpec:
    """Template factory for a caller's own point tower (``ULIP_CUSTOMIZED``,
    ``ppt_tpu/models/ulip.py:232-241``): any module mapping ``(pc, train=,
    generator=)`` to ``[B, pc_feat_dims]``. The encoder keeps the dtype it
    was built with; ``args.compute_dtype`` sets the text tower's. The
    weights are as constructed: draw them with ``init_weights`` and place
    the model as ``build_model`` does."""
    dt = resolve_dtype(getattr(args, "compute_dtype", "float32"))
    return _make("ULIP_CUSTOMIZED", encoder, pc_feat_dims, args, dt, text_fused)


def _in_channels(args) -> int:
    """The point tower's input width: 4 with ``--use_height``, else 3."""
    return 4 if getattr(args, "use_height", False) else 3


def ulip_pointnet(args, text_fused: str = "off") -> ModelSpec:
    """ULIP over the vanilla PointNet (``ppt_tpu/models/ulip.py:244-247``).
    Its first layer is as wide as the input (4 channels with
    ``--use_height``), as the reference's shape inference makes it: no
    kernel on this tower needs xyz alone."""
    dt = resolve_dtype(getattr(args, "compute_dtype", "float32"))
    return _make("ULIP_PointNet", PointNetClassic(_in_channels(args), dtype=dt), 256, args, dt,
                 text_fused)


def ulip_pointnet_stn(args, text_fused: str = "off") -> ModelSpec:
    """ULIP over PointNet with T-Nets (``ppt_tpu/models/ulip.py:250-253``),
    its 1024-d max-pooled feature projected; the input STN turns the 3
    coordinates of however many channels."""
    dt = resolve_dtype(getattr(args, "compute_dtype", "float32"))
    return _make("ULIP_PointNet_STN", PointNetEncoder(_in_channels(args), dtype=dt), 1024, args,
                 dt, text_fused)


def ulip_dgcnn(args, text_fused: str = "off") -> ModelSpec:
    """ULIP over the DGCNN classifier (``ppt_tpu/models/ulip.py:256-259``);
    with ``--use_height`` its first graph is over the 4 channels, as the
    reference's."""
    dt = resolve_dtype(getattr(args, "compute_dtype", "float32"))
    return _make("ULIP_DGCNN", DgcnnClassifier(_in_channels(args), dtype=dt), 256, args, dt,
                 text_fused)


def ulip_pct(args, text_fused: str = "off") -> ModelSpec:
    """ULIP over PCT (``ppt_tpu/models/ulip.py:262-265``); its FPS kernel
    takes xyz, so ``--use_height`` is refused by name."""
    _xyz_only("ULIP_PCT", args)
    dt = resolve_dtype(getattr(args, "compute_dtype", "float32"))
    return _make("ULIP_PCT", Pct(dtype=dt), 256, args, dt, text_fused)


def ulip_curvenet(args, text_fused: str = "off") -> ModelSpec:
    """ULIP over CurveNet (``ppt_tpu/models/ulip.py:268-271``); it serves in
    eval, and its train step refuses by name (``nn/curvenet.py``). Its FPS
    kernel takes xyz, so ``--use_height`` is refused by name.
    ``args.curvenet_config`` may override the config (tests shrink it)."""
    _xyz_only("ULIP_CurveNet", args)
    dt = resolve_dtype(getattr(args, "compute_dtype", "float32"))
    cfg = getattr(args, "curvenet_config", None) or CurveNetConfig()
    return _make("ULIP_CurveNet", CurveNet(cfg, dtype=dt), 256, args, dt, text_fused)


MODEL_REGISTRY: Dict[str, Callable[..., ModelSpec]] = {
    "ULIP_PN_SSG": ulip_pn_ssg,
    "ULIP_PN_MSG": ulip_pn_msg,
    "ULIP_PN_MLP": ulip_pn_mlp,
    "ULIP_PointBERT": ulip_pointbert,
    "ULIP_PointBERT_partseg": ulip_pointbert_partseg,
    "ULIP_PN_NEXT": ulip_pn_next,
    "ULIP_PointNet": ulip_pointnet,
    "ULIP_PointNet_STN": ulip_pointnet_stn,
    "ULIP_DGCNN": ulip_dgcnn,
    "ULIP_PCT": ulip_pct,
    "ULIP_CurveNet": ulip_curvenet,
}


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

# partseg: the point encoder's subtrees outside the pretrained trunk train
# (the reference keeps what the checkpoint lacks trainable, ULIP_models.py:550-566).
_PARTSEG_TRAINABLE_SUBTREES = ("propagation_0", "propagation_1", "propagation_2",
                               "dgcnn_pro_1", "dgcnn_pro_2", "conv1", "bn1")


def trainable_mask(model: nn.Module, head_type: int = 0, task: str = "cls") -> Dict[str, bool]:
    """Which parameters train, by ``named_parameters`` name.

    Prompt tasks (cls, fewshot, partseg): always ``prompt_learner.*``; head
    types 1 to 3 progressively add the PointAdapter leaves of ``block_11``;
    partseg adds the segmentation head's subtrees. ``task='pretrain'``
    instead trains the point encoder, ``pc_projection`` and ``logit_scale``
    against the frozen text tower."""

    def is_trainable(path: Tuple[str, ...]) -> bool:
        if task == "pretrain":
            return path[0] in ("point_encoder", "pc_projection", "logit_scale")
        if "prompt_learner" in path:
            return True
        if any(path[:len(prefix)] == prefix
               for ht, prefixes in _HEAD_TYPE_UNFREEZE.items() if head_type >= ht
               for prefix in prefixes):
            return True
        return (task == "partseg" and path[0] == "point_encoder" and len(path) > 1
                and path[1] in _PARTSEG_TRAINABLE_SUBTREES)

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


def build_model(name: str, args, device=None, seed: Optional[int] = None,
                text_fused: str = "off") -> ModelSpec:
    """Build ``name`` on ``device`` (the card unless told otherwise), in
    eval mode, with weights drawn from ``seed`` (default ``args.seed``) and
    the text tower on the route ``text_fused`` ("off", "block", "tower")."""
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {sorted(MODEL_REGISTRY)}")
    dev = resolve_device(device)
    spec = MODEL_REGISTRY[name](args, text_fused=text_fused)
    init_weights(spec.model, getattr(args, "seed", 0) if seed is None else seed)
    spec.model.to(dev).eval()
    return spec
