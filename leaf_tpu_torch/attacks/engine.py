"""Device-side candidate scoring engine (port of
`leaf_tpu/attacks/engine.py`).

Every scoring call is one computation over a fixed-shape [B, N, C]
candidate token buffer:

    encode B*N candidates (one batch of packed rows)
      -> objective vs anchors -> per-row argmax -> best features

Padded slots are masked to -inf before the argmax, so selection matches
the reference exactly.  Only the winning indices return to the host
between rounds.  Scoring runs under `torch.no_grad()`.

Objectives:
  l2      maximise ||f - a||^2          (unnormalised features)
  negl2   minimise ||f - a||^2
  sim     maximise <f^, a^>             (normalised)
  dissim  minimise <f^, a^>

Context-length bucketing: with a causal mask and argmax-EOT pooling,
tokens after the EOT position cannot influence the pooled feature, so
slicing the [., 77] buffer down to the smallest bucket >= max(EOT)+1 is
exact: same features, a fraction of the work.

Bounded device batches: the JAX package encodes a whole candidate buffer
in one jitted call.  Here a scoring call encodes it in chunks whose
largest activation (the MLP's hidden layer, [tokens, mlp_width] in the
tower's compute dtype) stays within `SCORE_CHUNK_BYTES`: the chunk is
decided from the buffer's shape and the tower's dtype before anything is
launched.  Losses are written into one buffer on the device and each
row's winner is taken from the chunk that holds it, so argmaxes and
winner features are those of a single call (each sequence's features
depend on its own row alone: `models.clip._pack_groups`).

Not carried over from the JAX package: the mesh plumbing (`host_local`,
`_put*`, `_get`, `bucket_tokens_coordinated`), which belongs to the
multi-GPU slice.  Where the JAX scorer takes a parameter pytree, this one
takes the tower itself: a `models.clip.TextTower`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from leaf_tpu_torch.models.clip import TextTower
from leaf_tpu_torch.models.config import CLIPConfig

OBJECTIVES = ("l2", "negl2", "sim", "dissim")
CONTEXT_BUCKETS = (16, 32, 48, 64, 77)
# The byte budget of a scoring encode's MLP hidden layer.  At ViT-L's text
# width (mlp 3072) that is 699,050 tokens a chunk in bf16 and 349,525 in
# fp32: above every buffer the trainer encodes in one call (the unfused
# loop's 6,400 candidates at bucket 64 are 409,600 tokens, bf16), while the
# Charmer's candidate grids (up to 128 x 4,800 candidates) are cut.
SCORE_CHUNK_BYTES = 4 << 30
# chunk lengths are multiples of this, so that a chunk packs as many
# sequences per row as the whole buffer would (`clip._pack_groups`)
_CHUNK_ALIGN = 8


def bucket_tokens(tokens, buckets=CONTEXT_BUCKETS, need=None):
    """Slice a [..., C] token buffer to the smallest safe bucket.

    `need` overrides the locally computed max(EOT)+1."""
    arr = np.asarray(tokens)
    if need is None:
        need = int(arr.argmax(-1).max()) + 1  # EOT is the max id per row
    for b in buckets:
        if need <= b <= arr.shape[-1]:
            return arr[..., :b]
    return arr


def bucket_need(tokens) -> int:
    """The bucket requirement of a token buffer: max(EOT)+1."""
    return int(np.asarray(tokens).argmax(-1).max()) + 1


def bucket_tokens_coordinated(tokens, buckets=CONTEXT_BUCKETS):
    """`bucket_tokens` with the width agreed across all ranks (one small
    all-reduce a call; `bucket_tokens` itself on one rank)."""
    from leaf_tpu_torch.parallel.distributed import global_max_int32
    arr = np.asarray(tokens)
    need = int(global_max_int32([bucket_need(arr)])[0])
    return bucket_tokens(arr, buckets, need=need)


def can_bucket(cfg) -> bool:
    """Bucketing is feature-invariant only for causal towers with
    argmax-EOT pooling.  `cfg` is a CLIPConfig."""
    return (not cfg.text.no_causal_mask) and cfg.text.pool_type == "argmax"


def objective_loss(feats: torch.Tensor, anchors: torch.Tensor,
                   objective: str) -> torch.Tensor:
    """feats [..., N, D], anchors [..., D] -> loss [..., N]."""
    a = anchors[..., None, :]
    if objective == "l2":
        return (feats - a).square().sum(dim=-1)
    if objective == "negl2":
        return -(feats - a).square().sum(dim=-1)
    if objective == "sim":
        return (feats * a).sum(dim=-1)
    if objective == "dissim":
        return -(feats * a).sum(dim=-1)
    raise ValueError(f"unknown objective {objective!r}")


def chunk_rows(text_cfg, dtype: torch.dtype, seq_len: int) -> int:
    """Sequences of `seq_len` tokens per scoring encode of a text tower
    (`text_cfg`, a TextConfig) computing in `dtype`: as many as keep the
    MLP's hidden layer within `SCORE_CHUNK_BYTES`, a multiple of 8."""
    hidden = (int(text_cfg.width * text_cfg.mlp_ratio) * seq_len
              * torch.finfo(dtype).bits // 8)
    return max(_CHUNK_ALIGN,
               SCORE_CHUNK_BYTES // hidden // _CHUNK_ALIGN * _CHUNK_ALIGN)


def margin_loss(logits: torch.Tensor, label) -> torch.Tensor:
    """max_{j != y} logits_j - logits_y."""
    label = torch.as_tensor(label, device=logits.device).long()
    is_true = torch.nn.functional.one_hot(label, logits.shape[-1]).bool()
    other = logits.masked_fill(is_true, float("-inf")).amax(dim=-1)
    return other - logits.gather(-1, label[..., None])[..., 0]


class CandidateScorer:
    """Batched text-candidate scorer for one model config on one device.

    All methods take numpy (or tensor) token buffers and anchor features;
    the tower is passed per call so the same scorer serves trainable and
    frozen towers (or two different models, as in the dual-encoder mode).
    Features come out in the tower's compute dtype; losses are fp32.
    `counts` records the scoring calls, the encodes they made (one per
    chunk) and the candidates they encoded, padding included.
    """

    def __init__(self, cfg: CLIPConfig, device, bucket: int = 256):
        self.cfg = cfg
        self.device = torch.device(device)
        self.bucket = bucket
        self._can_bucket = can_bucket(cfg)
        self.counts = {"calls": 0, "encodes": 0, "candidates": 0}

    def _bucket(self, tokens):
        return bucket_tokens(tokens) if self._can_bucket else np.asarray(tokens)

    def _put(self, x, dtype=None) -> torch.Tensor:
        """Host array or tensor -> this scorer's device."""
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
            if not (x.flags.writeable and x.flags.c_contiguous):
                x = np.array(x, order="C")   # torch wants a writable array
            x = torch.from_numpy(x)
        return x.to(self.device, dtype)

    def _encode_chunks(self, text: TextTower, flat: torch.Tensor,
                       normalize: bool):
        """Yield (start, features) over the chunks of a [n, C] buffer."""
        step = chunk_rows(text.cfg, text.dtype, flat.shape[1])
        self.counts["calls"] += 1
        self.counts["candidates"] += flat.shape[0]
        for start in range(0, flat.shape[0], step):
            self.counts["encodes"] += 1
            yield start, text.encode_text(flat[start:start + step], normalize)

    # -- raw text encode ---------------------------------------------------

    @torch.no_grad()
    def encode_text(self, text: TextTower, tokens,
                    normalize: bool = False) -> torch.Tensor:
        return text.encode_text(self._put(self._bucket(tokens)), normalize)

    # -- batch-parallel scoring (LEAF training attack) ---------------------

    @torch.no_grad()
    def score_rows(self, text: TextTower, tokens: np.ndarray, anchors,
                   objective: str, mask: Optional[np.ndarray] = None
                   ) -> Tuple[np.ndarray, torch.Tensor, torch.Tensor]:
        """tokens [B, N, C], anchors [B, D] -> (best_idx [B] numpy,
        best_feats [B, D] on the device, loss [B, N] on the device).

        If `objective` normalises features, anchors must already be
        normalised (the attacks do this once up front)."""
        tokens = self._put(self._bucket(tokens))
        B, N, C = tokens.shape
        normalize = objective in ("sim", "dissim")
        anchors = self._put(anchors, torch.float32)
        valid = (None if mask is None else
                 self._put(np.asarray(mask, bool)).reshape(B * N))
        loss = torch.full((B * N,), float("-inf"), device=self.device)
        winners = []
        for s, feats in self._encode_chunks(text, tokens.reshape(B * N, C),
                                            normalize):
            e = s + feats.shape[0]
            flat = torch.arange(s, e, device=self.device)
            part = objective_loss(feats.float()[:, None],
                                  anchors[flat // N], objective)[:, 0]
            if valid is not None:
                part = part.masked_fill(~valid[s:e], float("-inf"))
            loss[s:e] = part
            # each row's best candidate so far (the rest of the buffer is
            # still -inf), and its features where it lies in this chunk
            r0, r1 = s // N, (e - 1) // N + 1
            col = loss[r0 * N:r1 * N].view(r1 - r0, N).argmax(dim=-1)
            pos = torch.arange(r0, r1, device=self.device) * N + col - s
            col = col.masked_fill((pos < 0) | (pos >= e - s), -1)
            winners.append((r0, r1, col, feats[pos.clamp(0, e - s - 1)]))
        loss = loss.view(B, N)
        best = loss.argmax(dim=-1)
        best_feats = winners[0][3].new_zeros(B, winners[0][3].shape[-1])
        for r0, r1, col, feats in winners:
            # a row's winner lies in the chunk whose best it was
            hit = (best[r0:r1] == col)[:, None]
            best_feats[r0:r1] = torch.where(hit, feats, best_feats[r0:r1])
        return best.cpu().numpy(), best_feats, loss

    # -- single-sentence scoring with bucketing (Charmer/bruteforce) -------

    def _pad(self, tokens: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        n = tokens.shape[0]
        padded_n = max(self.bucket, int(np.ceil(n / self.bucket)) * self.bucket)
        if padded_n != n:
            pad = np.broadcast_to(tokens[0], (padded_n - n,) + tokens.shape[1:])
            tokens = np.concatenate([tokens, pad], axis=0)
        mask = np.zeros(padded_n, dtype=bool)
        mask[:n] = True
        return tokens, mask

    def _score_flat(self, text: TextTower, tokens: torch.Tensor, anchor,
                    objective: str) -> torch.Tensor:
        # the "_normfeat" suffix scores l2/negl2 on NORMALIZED candidate
        # features against the raw anchor: the reference's
        # constrained-retrieval phase-1 quirk
        base = objective.replace("_normfeat", "")
        normalize = objective != base or base in ("sim", "dissim")
        anchor = self._put(anchor, torch.float32)[None]
        return torch.cat([
            objective_loss(feats.float()[None], anchor, base)[0]
            for _, feats in self._encode_chunks(text, tokens, normalize)])

    @torch.no_grad()
    def score_flat(self, text: TextTower, tokens: np.ndarray, anchor,
                   objective: str, anchor2=None,
                   text2: Optional[TextTower] = None,
                   scorer2: Optional["CandidateScorer"] = None) -> np.ndarray:
        """tokens [N, C], anchor [D] -> loss [N] (numpy).

        Supports the dual-encoder mode (average of two models' losses)
        via (text2, anchor2).  When the second model's architecture
        differs, pass its own `scorer2`."""
        n = tokens.shape[0]
        padded, _ = self._pad(self._bucket(tokens))
        padded = self._put(padded)
        loss = self._score_flat(text, padded, anchor, objective)
        if text2 is not None:
            s2 = scorer2 or self
            loss2 = s2._score_flat(text2, padded, anchor2, objective)
            loss = (loss + loss2) / 2
        return loss.cpu().numpy()[:n]

    # -- classification scoring (margin loss vs class anchors) -------------

    def _classify(self, text: TextTower, flat: torch.Tensor, class_feats,
                  labels: torch.Tensor, per_row: int):
        """Margin losses and predictions [n] of a flat [n, C] buffer whose
        candidate i belongs to label row i // per_row."""
        class_feats = self._put(class_feats, torch.float32)
        loss, preds = [], []
        for s, feats in self._encode_chunks(text, flat, True):
            logits = feats.float() @ class_feats.T
            rows = torch.arange(s, s + len(feats), device=self.device)
            loss.append(margin_loss(logits, labels[rows // per_row]))
            preds.append(logits.argmax(dim=-1))
        return torch.cat(loss), torch.cat(preds)

    @torch.no_grad()
    def score_classification_rows(self, text: TextTower, tokens: np.ndarray,
                                  class_feats, labels,
                                  mask: Optional[np.ndarray] = None
                                  ) -> Tuple[np.ndarray, np.ndarray]:
        """tokens [B, N, C], labels [B] -> (margin loss [B, N] with -inf
        on masked slots, predictions [B, N]), both numpy."""
        tokens = self._put(self._bucket(tokens))
        B, N, C = tokens.shape
        loss, preds = self._classify(text, tokens.reshape(B * N, C),
                                     class_feats,
                                     self._put(np.asarray(labels)).long(), N)
        loss = loss.view(B, N)
        if mask is not None:
            loss = loss.masked_fill(~self._put(np.asarray(mask, bool)),
                                    float("-inf"))
        return loss.cpu().numpy(), preds.view(B, N).cpu().numpy()

    @torch.no_grad()
    def score_classification(self, text: TextTower, tokens: np.ndarray,
                             class_feats, label: int
                             ) -> Tuple[np.ndarray, np.ndarray]:
        """tokens [N, C], class_feats [K, D] (normalised) -> (margin loss
        [N], predictions [N]), both numpy."""
        n = tokens.shape[0]
        padded, _ = self._pad(self._bucket(tokens))
        loss, preds = self._classify(
            text, self._put(padded), class_feats,
            torch.full((1,), int(label), device=self.device), len(padded))
        return loss.cpu().numpy()[:n], preds.cpu().numpy()[:n]
