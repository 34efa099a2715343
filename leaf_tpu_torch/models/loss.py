"""Contrastive losses (port of `leaf_tpu/models/loss.py`): symmetric
InfoNCE, the SigLIP sigmoid loss, InfoNCE with knowledge distillation
from a teacher, and CoCa's InfoNCE plus captioning loss.

Across ranks a loss takes the process group (`parallel.distributed.
group()`), as the JAX package's take `axis_name`: InfoNCE gathers the
features of every rank (`distributed.all_gather`, differentiable) and,
with `local_loss`, keeps only this rank's logit rows, their labels offset
by `B * rank`; SigLIP passes the text features round the ring of world - 1
neighbour exchanges (`distributed.neighbour_exchange`).  A loss returns
this rank's own value (the JAX package returns its `pmean`, which the
trainers log through `distributed.pmean`); its backward, with the
optimizer's gradient mean, gives the gradient of the mean over ranks.
With `group` None (one rank) each is the one-card code below, and
`--local-loss` computes the global loss.  Callers pass fp32 features and
logits: the losses compute in their dtype.
"""
from __future__ import annotations

import functools

from typing import Optional, Tuple

import torch
from torch.nn import functional as F

from leaf_tpu_torch.parallel import distributed


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


def _gathered_logits(image_features: torch.Tensor,
                     text_features: torch.Tensor, logit_scale: torch.Tensor,
                     local_loss: bool):
    """(logits_per_image, logits_per_text, labels) over the gathered
    features (the JAX package's `_gathered_logits` under an axis)."""
    all_image = distributed.all_gather(image_features)
    all_text = distributed.all_gather(text_features)
    if local_loss:
        B = image_features.shape[0]
        labels = torch.arange(B, device=image_features.device) \
            + B * distributed.rank()
        return (_logits(image_features, all_text, logit_scale),
                _logits(text_features, all_image, logit_scale), labels)
    li = _logits(all_image, all_text, logit_scale)
    return li, li.T, torch.arange(li.shape[0], device=li.device)


def _two_way_cross_entropy(li, lt, labels) -> torch.Tensor:
    return (F.cross_entropy(li, labels) + F.cross_entropy(lt, labels)) / 2


def clip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
              logit_scale: torch.Tensor, group=None,
              local_loss: bool = True) -> torch.Tensor:
    """Symmetric InfoNCE over the batch, or over the ranks' gathered
    batch under `group`."""
    if group is None:
        return symmetric_cross_entropy(
            _logits(image_features, text_features, logit_scale))
    return _two_way_cross_entropy(*_gathered_logits(
        image_features, text_features, logit_scale, local_loss))


def _siglip_pair_loss(image_features, text_features, logit_scale,
                      logit_bias, negative_only: bool) -> torch.Tensor:
    logits = _logits(image_features, text_features, logit_scale)
    if logit_bias is not None:
        logits = logits + logit_bias
    n, m = logits.shape
    if negative_only:
        labels = -torch.ones_like(logits)
    else:
        labels = 2 * torch.eye(n, m, dtype=logits.dtype,
                               device=logits.device) - 1
    return -F.logsigmoid(labels * logits).sum() / n


def siglip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
                logit_scale: torch.Tensor,
                logit_bias: Optional[torch.Tensor] = None,
                group=None) -> torch.Tensor:
    """Sigmoid loss: -sum(log sigmoid(label * logit)) / B, the labels +1
    on the diagonal and -1 elsewhere.  Under `group`, this rank's images
    also meet every other rank's texts as negatives, passed round the
    ring in world - 1 hops (rank i's texts go to rank i + 1 each hop)."""
    loss = _siglip_pair_loss(image_features, text_features, logit_scale,
                             logit_bias, negative_only=False)
    if group is not None:
        neighbour_text = text_features
        for _ in range(distributed.world_size() - 1):
            neighbour_text = distributed.neighbour_exchange(neighbour_text)
            loss = loss + _siglip_pair_loss(image_features, neighbour_text,
                                            logit_scale, logit_bias,
                                            negative_only=True)
    return loss


def distill_clip_loss(image_features: torch.Tensor,
                      text_features: torch.Tensor, logit_scale: torch.Tensor,
                      dist_image_features: torch.Tensor,
                      dist_text_features: torch.Tensor,
                      dist_logit_scale: torch.Tensor, group=None,
                      local_loss: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(InfoNCE, distillation): the distillation term is the cross-entropy
    of the student's logits against the teacher's softmax, both ways,
    averaged; under `group` both over the gathered features."""

    def dist_loss(teacher, student):
        return -(teacher.softmax(dim=1)
                 * student.log_softmax(dim=1)).sum(dim=1).mean()

    if group is None:
        li = _logits(image_features, text_features, logit_scale)
        dli = _logits(dist_image_features, dist_text_features,
                      dist_logit_scale)
        distill = (dist_loss(dli, li) + dist_loss(dli.T, li.T)) / 2
        return symmetric_cross_entropy(li), distill
    li, lt, labels = _gathered_logits(image_features, text_features,
                                      logit_scale, local_loss)
    dli, dlt, _ = _gathered_logits(dist_image_features, dist_text_features,
                                   dist_logit_scale, local_loss)
    distill = (dist_loss(dli, li) + dist_loss(dlt, lt)) / 2
    return _two_way_cross_entropy(li, lt, labels), distill


def coca_loss(image_features: torch.Tensor, text_features: torch.Tensor,
              caption_logits: torch.Tensor, caption_labels: torch.Tensor,
              logit_scale: torch.Tensor, caption_loss_weight: float = 2.0,
              clip_loss_weight: float = 1.0, pad_id: int = 0, group=None,
              local_loss: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(contrastive, caption): the weighted InfoNCE (under `group`, over
    the gathered features), and the weighted cross-entropy of
    `caption_logits` [B, S, V] against `caption_labels` [B, S] averaged
    over this rank's labels that are not `pad_id`."""
    contrastive = torch.zeros((), device=caption_logits.device)
    if clip_loss_weight:
        contrastive = clip_loss_weight * clip_loss(
            image_features, text_features, logit_scale, group, local_loss)
    logp = caption_logits.log_softmax(dim=-1)
    nll = -logp.gather(-1, caption_labels.long()[..., None])[..., 0]
    mask = (caption_labels != pad_id).to(nll.dtype)
    caption = caption_loss_weight * (nll * mask).sum() \
        / mask.sum().clamp_min(1)
    return contrastive, caption


def create_loss(args):
    """The loss of a parsed command line: distillation, SigLIP, CoCa's
    (for a `coca` model name, with the command line's weights) or
    InfoNCE; `--local-loss` is the trainers' to pass with the group."""
    if getattr(args, "distill", False):
        return distill_clip_loss
    if getattr(args, "siglip", False):
        return siglip_loss
    if "coca" in (getattr(args, "model", "") or "").lower():
        return functools.partial(
            coca_loss,
            caption_loss_weight=getattr(args, "coca_caption_loss_weight", 2.0),
            clip_loss_weight=getattr(args, "coca_contrastive_loss_weight",
                                     1.0))
    return clip_loss
