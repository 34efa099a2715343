"""The contrastive CLIP train steps and the val eval (port of
`leaf_tpu/train/contrastive.py`).

Both towers train: InfoNCE (or the SigLIP loss) on the normalised
features of one batch, backward, the optimizer's update, then
`logit_scale` clamped to [0, ln 100].  Gradient accumulation over k
microbatches is the feature-cache step: a no-grad pass caches every
microbatch's features, then each microbatch runs again with the gradient,
its features spliced into the cached matrix, so that it sees the whole
effective batch as negatives.  Each chunk's loss is a mean over that whole
batch, so the SUM of the chunk gradients (k `backward()` calls into
`.grad`) is the full batch's gradient for the towers; `logit_scale` is in
every chunk, and its gradient comes out k times, as in the JAX step.  The
update is one `Optimizer.update` with `accum_freq` 1 (not its averaging
accumulation).

`make_coca_train_step` trains a CoCa model on `coca_loss`: the InfoNCE of
its latents plus the captioning cross-entropy of its decoder, teacher
forced, AdamW on every parameter and the same clamp.

Across ranks (`parallel.distributed`) each rank steps on its own rows of
the global batch: the losses gather the features (or pass SigLIP's ring)
under the process group, `--local-loss` keeps a rank's own logit rows,
patch dropout takes the rank's rows of the global batch's scores, and the
logged loss is the mean over ranks.  The feature-cache step gathers the
cache of every rank (no gradient) and each microbatch's live features
(with it), so that every rank computes the loss of the whole global
effective batch, as the JAX step does on its global arrays.

`evaluate_contrastive` gives the val loss and the image<->text recall
metrics over a loader of (normalised images, captions).  The JAX package
compiles each step with `jax.jit`; here they are Python functions on a
state that holds the model, updated in place.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from leaf_tpu_torch.models.clip import CLIP, patch_dropout_scores
from leaf_tpu_torch.models.loss import (clip_loss, coca_loss, siglip_loss,
                                        symmetric_cross_entropy)
from leaf_tpu_torch.parallel import distributed
from leaf_tpu_torch.train.optim import Optimizer


@dataclasses.dataclass
class ContrastiveState:
    """The model (both towers trained; a `CLIP` or a `CoCa`), its
    optimizer and the count of updates."""
    model: CLIP
    optimizer: Optimizer
    step: int = 0


def fp32_features(out: Dict[str, torch.Tensor]):
    """(image features, text features, logit scale) of `CLIP.forward`'s
    dict, in fp32."""
    return (out["image_features"].float(), out["text_features"].float(),
            out["logit_scale"].float())


def contrastive_loss_fn(model: CLIP, images: torch.Tensor,
                        tokens: torch.Tensor, siglip: bool = False,
                        dropout: Optional[torch.Tensor] = None,
                        local_loss: bool = False) -> torch.Tensor:
    """The loss of one batch, in fp32 on the towers' features; the
    sigmoid loss takes the model's `logit_bias` where it has one (SigLIP),
    as the JAX step does (`leaf_tpu/train/contrastive.py:56-58`).
    `dropout`: patch-dropout scores (`models.clip.patch_dropout_scores`).
    Across ranks, this rank's loss under the process group."""
    out = model(images, tokens, dropout)
    img_f, txt_f, scale = fp32_features(out)
    group = distributed.group()
    if siglip:
        bias = out.get("logit_bias")
        return siglip_loss(img_f, txt_f, scale,
                           None if bias is None else bias.float(),
                           group=group)
    return clip_loss(img_f, txt_f, scale, group, local_loss)


def clamp_logit_scale(model: CLIP) -> None:
    """logit_scale to [0, ln 100], in place, after every update."""
    with torch.no_grad():
        model.logit_scale.clamp_(0.0, math.log(100.0))


def apply_update(state: ContrastiveState) -> None:
    """The optimizer's update from the gradients on the parameters, the
    clamp, the step count."""
    state.optimizer.update(state.step)
    clamp_logit_scale(state.model)
    state.step += 1


def step_metrics(state: ContrastiveState, loss: torch.Tensor):
    """A step's metrics, device tensors: its loss (the mean over ranks)
    and exp(logit_scale)."""
    return {"loss": distributed.pmean(loss.detach()),
            "logit_scale": state.model.logit_scale.detach().exp()}


def make_contrastive_train_step(siglip: bool = False,
                                dropout_seed: Optional[int] = None,
                                local_loss: bool = False) -> Callable:
    """step(state, images [B, H, W, 3], tokens [B, C]) -> (state, metrics
    {loss, logit_scale}), both device tensors.  With `dropout_seed` and a
    config with `patch_dropout > 0`, each step drops patches with scores
    drawn from (dropout_seed, state.step): across ranks, this rank's rows
    of the global batch's scores."""

    def step_fn(state: ContrastiveState, images: torch.Tensor,
                tokens: torch.Tensor):
        vcfg = state.model.cfg.vision
        dropout = None
        if dropout_seed is not None and vcfg.patch_dropout > 0:
            dropout = distributed.ranks_rows(patch_dropout_scores(
                dropout_seed, state.step,
                images.shape[0] * distributed.world_size(),
                vcfg.grid_size ** 2, images.device))
        loss = contrastive_loss_fn(state.model, images, tokens, siglip,
                                   dropout, local_loss)
        loss.backward()
        apply_update(state)
        return state, step_metrics(state, loss)

    return step_fn


def make_accum_contrastive_train_step() -> Callable:
    """step(state, images [k, b, H, W, 3], tokens [k, b, C]) -> (state,
    metrics {loss (the mean of the k chunk losses), logit_scale}).
    Across ranks microbatch j of the global batch is every rank's j-th, in
    rank order, and each rank computes every chunk's global loss: the
    gradient mean then gives each tower parameter the sum over ranks of
    its live rows' gradients, and `logit_scale` the chunk's gradient, as
    in the JAX step."""

    def step_fn(state: ContrastiveState, images: torch.Tensor,
                tokens: torch.Tensor):
        model = state.model
        k = images.shape[0]
        b = images.shape[1] * distributed.world_size()
        with torch.no_grad():
            cached = [fp32_features(model(images[j], tokens[j]))
                      for j in range(k)]
        all_img = torch.cat([distributed.all_gather_no_grad(c[0])
                             for c in cached])
        all_txt = torch.cat([distributed.all_gather_no_grad(c[1])
                             for c in cached])
        loss_sum = torch.zeros((), device=images.device)
        for j in range(k):
            img_f, txt_f, scale = fp32_features(model(images[j], tokens[j]))
            img_f = distributed.all_gather(img_f)
            txt_f = distributed.all_gather(txt_f)
            lo, hi = j * b, (j + 1) * b
            img = torch.cat([all_img[:lo], img_f, all_img[hi:]])
            txt = torch.cat([all_txt[:lo], txt_f, all_txt[hi:]])
            loss = symmetric_cross_entropy(scale * img @ txt.T)
            loss.backward()
            loss_sum = loss_sum + loss.detach()
        apply_update(state)
        return state, step_metrics(state, loss_sum / k)

    return step_fn


def make_coca_train_step(caption_loss_weight: float = 2.0,
                         clip_loss_weight: float = 1.0,
                         local_loss: bool = False) -> Callable:
    """step(state, images [B, H, W, 3], tokens [B, C]) -> (state, metrics
    {loss, logit_scale}) for a CoCa model: `coca_loss` on its fp32
    latents, logits and the labels tokens[:, 1:], summed, then the
    update."""

    def step_fn(state: ContrastiveState, images: torch.Tensor,
                tokens: torch.Tensor):
        out = state.model(images, tokens)
        contrastive, caption = coca_loss(
            out["image_features"].float(), out["text_features"].float(),
            out["logits"].float(), out["labels"], out["logit_scale"].float(),
            caption_loss_weight=caption_loss_weight,
            clip_loss_weight=clip_loss_weight,
            pad_id=state.model.cfg.pad_id, group=distributed.group(),
            local_loss=local_loss)
        loss = contrastive + caption
        loss.backward()
        apply_update(state)
        return state, step_metrics(state, loss)

    return step_fn


def get_clip_metrics(image_features, text_features,
                     logit_scale: float) -> Dict[str, float]:
    """Mean rank, median rank and R@1/5/10 both ways, on the host."""
    image_features = np.asarray(image_features)
    text_features = np.asarray(text_features)
    logits_per_image = float(logit_scale) * image_features @ text_features.T
    logits = {"image_to_text": logits_per_image,
              "text_to_image": logits_per_image.T}
    metrics = {}
    ground_truth = np.arange(image_features.shape[0])[:, None]
    for name, logit in logits.items():
        ranking = np.argsort(-logit, axis=1)
        preds = np.where(ranking == ground_truth)[1]
        metrics[f"{name}_mean_rank"] = float(preds.mean() + 1)
        metrics[f"{name}_median_rank"] = float(np.floor(np.median(preds)) + 1)
        for k in (1, 5, 10):
            metrics[f"{name}_R@{k}"] = float((preds < k).mean())
    return metrics


@contextlib.contextmanager
def computing_in(model: CLIP, dtype: Optional[torch.dtype]):
    """Both towers compute in `dtype` inside the block (None: as they
    are); their `compute_dtype`s are restored after."""
    saved = (model.text.compute_dtype, model.visual.compute_dtype)
    if dtype is not None:
        model.text.compute_dtype = model.visual.compute_dtype = dtype
    try:
        yield
    finally:
        model.text.compute_dtype, model.visual.compute_dtype = saved


def _on(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


@torch.no_grad()
def evaluate_contrastive(model: CLIP, loader: Iterable, tokenizer,
                         dtype: Optional[torch.dtype] = None
                         ) -> Dict[str, float]:
    """Val contrastive loss (`clip_val_loss`, the batch-size-weighted mean
    of each batch's InfoNCE) and `get_clip_metrics` over all of the
    loader's (images, texts) batches, with `num_samples`; {} for an empty
    loader.  `dtype`: the towers' compute dtype during the eval."""
    device = model.logit_scale.device
    all_img, all_txt = [], []
    total_loss, n = 0.0, 0
    with computing_in(model, dtype):
        for images, texts in loader:
            tokens = _on(tokenizer(texts), device)
            out = model(_on(images, device), tokens)
            img_f, txt_f = out["image_features"], out["text_features"]
            loss = symmetric_cross_entropy(out["logit_scale"].float() * img_f.float()
                                 @ txt_f.float().T)
            total_loss += float(loss) * img_f.shape[0]
            n += img_f.shape[0]
            all_img.append(img_f.float().cpu().numpy())
            all_txt.append(txt_f.float().cpu().numpy())
    if n == 0:
        return {}
    metrics = get_clip_metrics(np.concatenate(all_img),
                               np.concatenate(all_txt),
                               float(model.logit_scale.exp()))
    metrics["clip_val_loss"] = total_loss / n
    metrics["num_samples"] = n
    return metrics
