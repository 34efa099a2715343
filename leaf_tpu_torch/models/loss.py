"""Contrastive losses on one card (port of `leaf_tpu/models/loss.py`):
symmetric InfoNCE, the SigLIP sigmoid loss and InfoNCE with knowledge
distillation from a teacher.

The JAX package gathers features across a mesh axis (`axis_name`) and,
with `local_loss`, keeps only this shard's logit rows; on one card the
gathered batch is the batch and the local rows are all rows, so both
arguments are gone and `--local-loss` computes the same loss.  Callers
pass fp32 features: the losses compute in the features' dtype.  CoCa's
captioning loss comes with the CoCa model (ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.nn import functional as F


def _logits(image_features: torch.Tensor, text_features: torch.Tensor,
            logit_scale: torch.Tensor) -> torch.Tensor:
    """logit_scale * image_features @ text_features.T, [B, B]."""
    return logit_scale * image_features @ text_features.T


def symmetric_cross_entropy(logits: torch.Tensor) -> torch.Tensor:
    """The mean of image->text and text->image cross-entropies with the
    diagonal as the labels."""
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (F.cross_entropy(logits, labels)
            + F.cross_entropy(logits.T, labels)) / 2


def clip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
              logit_scale: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE over the batch."""
    return symmetric_cross_entropy(_logits(image_features, text_features, logit_scale))


def siglip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
                logit_scale: torch.Tensor,
                logit_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sigmoid loss: -sum(log sigmoid(label * logit)) / B, the labels +1
    on the diagonal and -1 elsewhere."""
    logits = _logits(image_features, text_features, logit_scale)
    if logit_bias is not None:
        logits = logits + logit_bias
    n, m = logits.shape
    labels = 2 * torch.eye(n, m, dtype=logits.dtype, device=logits.device) - 1
    return -F.logsigmoid(labels * logits).sum() / n


def distill_clip_loss(image_features: torch.Tensor,
                      text_features: torch.Tensor, logit_scale: torch.Tensor,
                      dist_image_features: torch.Tensor,
                      dist_text_features: torch.Tensor,
                      dist_logit_scale: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(InfoNCE, distillation): the distillation term is the cross-entropy
    of the student's logits against the teacher's softmax, both ways,
    averaged."""
    li = _logits(image_features, text_features, logit_scale)
    dli = _logits(dist_image_features, dist_text_features, dist_logit_scale)

    def dist_loss(teacher, student):
        return -(teacher.softmax(dim=1)
                 * student.log_softmax(dim=1)).sum(dim=1).mean()

    distill = (dist_loss(dli, li) + dist_loss(dli.T, li.T)) / 2
    return symmetric_cross_entropy(li), distill


def create_loss(args):
    """The loss of a parsed command line: distillation, SigLIP or InfoNCE
    (CoCa's raises)."""
    if getattr(args, "distill", False):
        return distill_clip_loss
    if getattr(args, "siglip", False):
        return siglip_loss
    if "coca" in (getattr(args, "model", "") or "").lower():
        raise NotImplementedError(
            "the CoCa captioning loss (coca_loss) is not ported to "
            "leaf_tpu_torch yet: ROADMAP Queue 1 item 11")
    return clip_loss
