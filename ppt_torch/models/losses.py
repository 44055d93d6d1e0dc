"""Losses of the task scripts (counterpart of ``ppt_tpu/models/losses.py``):
the tasks' label-smoothed cross entropy, PointBERT's smoothing variant,
the soft-target cross entropy and Hinton distillation of the openpoints
recipes, and ULIP pretraining's symmetric InfoNCE. The port runs on one
card, so the batch products below see the whole batch as they are (the
reference's ``GatherLayer`` has nothing to gather)."""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F


def smoothed_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           smoothing: float = 0.0) -> torch.Tensor:
    """Mean label-smoothed cross entropy in f32: the target is
    ``1 - s`` on the true class plus ``s / K`` uniform
    (``models/losses.py:23-35``), written out rather than handed to
    ``F.cross_entropy`` so that it follows the reference op by op."""
    num_classes = logits.shape[-1]
    logp = F.log_softmax(logits.float(), dim=-1)
    onehot = F.one_hot(labels.long(), num_classes).to(torch.float32)
    target = onehot * (1.0 - smoothing) + smoothing / num_classes
    return -(target * logp).sum(-1).mean()


def pointbert_smoothed_ce(logits: torch.Tensor, labels: torch.Tensor,
                          eps: float = 0.2) -> torch.Tensor:
    """PointBERT's own smoothing (``point_encoder.py:185-199``): the true
    class gets ``1 - eps`` and each of the other ``K - 1`` classes
    ``eps / (K - 1)``; mean over the batch, in f32."""
    num_classes = logits.shape[-1]
    logp = F.log_softmax(logits.float(), dim=-1)
    onehot = F.one_hot(labels.long(), num_classes).to(torch.float32)
    target = onehot * (1.0 - eps) + (1.0 - onehot) * eps / (num_classes - 1)
    return -(target * logp).sum(-1).mean()


def soft_target_cross_entropy(logits: torch.Tensor, target_probs: torch.Tensor) -> torch.Tensor:
    """Cross entropy against a soft target distribution (openpoints'
    SoftTarget CE), mean over the batch, in f32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -(target_probs.float() * logp).sum(-1).mean()


def distillation_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                      labels: torch.Tensor, alpha: float = 0.5,
                      temperature: float = 4.0) -> torch.Tensor:
    """Hinton KD, ``alpha * T^2 * KL(teacher_T || student_T) + (1 - alpha) *
    CE(student, labels)`` (openpoints' DistillCls criterion), with the KL
    written as the reference writes it: the cross term less the teacher's
    entropy, ``p * log(p + 1e-10)`` (``ppt_tpu/models/losses.py:59-75``)."""
    t = temperature
    s = F.log_softmax(student_logits.float() / t, dim=-1)
    p = F.softmax(teacher_logits.float() / t, dim=-1)
    kd = -(p * s).sum(-1).mean() - (-(p * torch.log(p + 1e-10)).sum(-1).mean())
    ce = smoothed_cross_entropy(student_logits, labels)
    return alpha * t * t * kd + (1.0 - alpha) * ce


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=-1, keepdim=True)


def ulip_contrastive_loss(pc_embed: torch.Tensor, text_embed: torch.Tensor,
                          image_embed: Optional[torch.Tensor],
                          logit_scale: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric InfoNCE across (pc, text) and, with ``image_embed``, (pc,
    image) (``models/losses.py:82-118``, ``ULIPWithImageLoss.forward``): all
    embeddings ``[B, E]``, positives on the diagonal, normalised in f32.
    Returns ``loss`` and the retrieval accuracies in percent
    (``pc_text_acc``, and ``pc_image_acc`` with images)."""
    labels = torch.arange(pc_embed.shape[0], device=pc_embed.device)
    pc = _l2_normalize(pc_embed.float())
    tx = _l2_normalize(text_embed.float())

    def pair_loss(a, b):
        logits_ab = logit_scale * a @ b.t()
        logits_ba = logit_scale * b @ a.t()
        ce = smoothed_cross_entropy
        return (ce(logits_ab, labels) + ce(logits_ba, labels)) / 2.0, logits_ab

    loss, logits_pt = pair_loss(pc, tx)
    out = {"pc_text_acc": 100.0 * (logits_pt.argmax(-1) == labels).float().mean()}
    if image_embed is not None:
        loss_pi, logits_pi = pair_loss(pc, _l2_normalize(image_embed.float()))
        loss = loss + loss_pi
        out["pc_image_acc"] = 100.0 * (logits_pi.argmax(-1) == labels).float().mean()
    out["loss"] = loss
    return out
