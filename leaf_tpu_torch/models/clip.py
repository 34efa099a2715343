"""CLIP text and vision towers (port of `leaf_tpu/models/clip.py`).

The towers are `nn.Module`s whose parameter names follow the JAX pytree
(`text.token_embedding`, `text.blocks.<i>.attn.qkv_w`,
`visual.patch_embedding`, ...).  A tower's working dtype is the dtype of
its embedding weights: for serving the factory casts matrix weights and
embeddings once, and LayerNorm parameters stay fp32.  For training the
text tower keeps fp32 master weights and is given a `compute_dtype`:
embeddings, block weights and the projection are then cast where they
are used, and the gradient flows back through the cast.  The vision
tower has the same `compute_dtype` for FARE, which trains it in bf16 on
fp32 master weights; everywhere else it computes in its weights' dtype.

Text: short sequences are packed G per row (`_pack_groups`, target 128
tokens as in the JAX package) under a block-diagonal causal pattern;
every block then runs the fused attention sub-block with
`packed=(S, causal)`.  Vision: the CLIP-ViT branch (class token, ln_pre,
token pool, projection) runs every block with `packed=(T, False)`, one
sequence per row.  Images are NHWC, and the patch embedding is a reshape
plus one matmul (the stride-p conv of OpenCLIP, `patchify`).

Train-time patch dropout keeps the class token and a random subset of the
patch tokens after the positional embedding (`keep_patches`, given the
uniform scores that `patch_dropout_scores` draws).  `CLIP.forward` is the
joint forward of the contrastive trainer.

Not ported yet (the port's configs cannot ask for them): the SigLIP
attention-pool head, timm MLP heads, text projection biases and CLIPA's
pool-then-LN ordering.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from leaf_tpu_torch.models import layers
from leaf_tpu_torch.models.config import CLIPConfig, TextConfig, VisionConfig
from leaf_tpu_torch.ops.packed_attention import block_mask


# ---------------------------------------------------------------------------
# Masks & pooling
# ---------------------------------------------------------------------------

@functools.lru_cache()
def causal_mask(seq_len: int) -> np.ndarray:
    """Additive causal mask [S, S]; -inf above the diagonal (a host
    constant, read-only)."""
    m = np.triu(np.full((seq_len, seq_len), -np.inf, np.float32), k=1)
    m.flags.writeable = False
    return m


@functools.lru_cache()
def packed_block_mask(seq_len: int, groups: int, causal: bool) -> np.ndarray:
    """Additive mask [G*S, G*S] for G sequences packed along the length
    axis: (causal) attention within each S-block, -inf across blocks.
    The mask that `packed=(seq_len, causal)` stands for: the additive form
    of `ops.packed_attention.block_mask`."""
    allowed = block_mask(groups * seq_len, seq_len, causal).numpy()
    m = np.where(allowed, 0.0, -np.inf).astype(np.float32)
    m.flags.writeable = False
    return m


def _pack_groups(batch: int, seq_len: int, target: int = 128) -> int:
    """Largest G dividing `batch` with G*S <= target."""
    g = max(1, target // seq_len)
    while g > 1 and batch % g:
        g -= 1
    return g


def text_pool(x: torch.Tensor, tokens: torch.Tensor,
              pool_type: str) -> torch.Tensor:
    """Pool token features [B, S, D] -> [B, D].  'argmax' takes the EOT
    position (EOT has the highest token id in every sequence)."""
    if pool_type == "argmax":
        eot = tokens.argmax(dim=-1)
        return x[torch.arange(x.shape[0], device=x.device), eot]
    if pool_type == "first":
        return x[:, 0]
    if pool_type == "last":
        return x[:, -1]
    raise ValueError(f"unsupported pool_type {pool_type!r}")


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps), as torch's F.normalize."""
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / norm.clamp_min(eps)


def _act(quick_gelu: bool):
    return layers.quick_gelu if quick_gelu else layers.gelu


# ---------------------------------------------------------------------------
# Text tower
# ---------------------------------------------------------------------------

class TextTower(nn.Module):
    def __init__(self, cfg: TextConfig, quick_gelu: bool = False):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.token_embedding = nn.Parameter(torch.zeros(cfg.vocab_size, w))
        self.positional_embedding = nn.Parameter(
            torch.zeros(cfg.context_length, w))
        self.blocks = layers.Transformer(w, cfg.layers, cfg.heads,
                                         int(w * cfg.mlp_ratio),
                                         _act(quick_gelu), cfg.ln_eps)
        self.ln_final = layers.LayerNorm(w, cfg.ln_eps)
        self.text_projection = nn.Parameter(torch.zeros(w, cfg.output_dim))
        # None: compute in the stored weights' dtype
        self.compute_dtype: Optional[torch.dtype] = None

    @property
    def dtype(self) -> torch.dtype:
        """The dtype of activations and features."""
        return self.compute_dtype or self.token_embedding.dtype

    def init_weights(self, generator: torch.Generator) -> None:
        layers.normal_(self.token_embedding, 0.02, generator)
        layers.normal_(self.positional_embedding, 0.01, generator)
        self.blocks.init_weights(generator)
        layers.normal_(self.text_projection, self.cfg.width ** -0.5, generator)

    def _packed(self, seq_len: int):
        """The `packed` declaration of rows of `seq_len`-token sequences."""
        return seq_len, not self.cfg.no_causal_mask

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token ids [B, S] -> embeddings [B, S, D] (the PEZ hook)."""
        return self.token_embedding[tokens.long()].to(self.dtype)

    def encode_text_embedding(self, embeds: torch.Tensor,
                              tokens: torch.Tensor,
                              normalize: bool = False,
                              remat: bool = False) -> torch.Tensor:
        """Text forward from embeddings [B, S, D], one sequence per row
        (tokens only drive the EOT pool)."""
        S = embeds.shape[1]
        x = embeds + self.positional_embedding[:S].to(embeds.dtype)
        x = self.blocks(x, packed=self._packed(S), remat=remat)
        return self._text_tail(x, tokens, normalize)

    def _text_tail(self, x: torch.Tensor, tokens: torch.Tensor,
                   normalize: bool) -> torch.Tensor:
        """ln_final -> pool -> projection -> normalize, shared by the
        packed and unpacked paths."""
        x = self.ln_final(x)
        if x.shape[0] != tokens.shape[0]:
            x = x.reshape(tokens.shape[0], tokens.shape[1], x.shape[-1])
        pooled = text_pool(x, tokens, self.cfg.pool_type)
        pooled = pooled @ self.text_projection.to(pooled.dtype)
        return l2_normalize(pooled) if normalize else pooled

    def encode_text(self, tokens: torch.Tensor, normalize: bool = False,
                    pack: bool = True, remat: bool = False) -> torch.Tensor:
        """Token ids [B, S] -> text features [B, output_dim].

        Short sequences are packed G per row (`_pack_groups`); the packed
        block-diagonal computation equals the unpacked one.  `remat`
        recomputes each block in the backward pass."""
        B, S = tokens.shape
        G = _pack_groups(B, S) if (pack and S < 128) else 1
        if G <= 1:
            return self.encode_text_embedding(self.embed_tokens(tokens),
                                              tokens, normalize, remat)
        x = self.embed_tokens(tokens)
        x = x + self.positional_embedding[:S].to(x.dtype)
        x = x.reshape(B // G, G * S, x.shape[-1])
        x = self.blocks(x, packed=self._packed(S), remat=remat)
        return self._text_tail(x, tokens, normalize)


# ---------------------------------------------------------------------------
# Vision tower
# ---------------------------------------------------------------------------

def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """NHWC images [B, H, W, 3] -> patches [B, gh*gw, p*p*3], pixels in
    (ph, pw, c) order.  Sizes that do not divide crop the right/bottom
    edge, like a stride-p conv."""
    B, H, W, C = images.shape
    p = patch_size
    gh, gw = H // p, W // p
    x = images[:, :gh * p, :gw * p].reshape(B, gh, p, gw, p, C)
    x = x.permute(0, 1, 3, 2, 4, 5)          # [B, gh, gw, p, p, C]
    return x.reshape(B, gh * gw, p * p * C)


def keep_patches(x: torch.Tensor, rate: float,
                 scores: torch.Tensor) -> torch.Tensor:
    """Patch dropout of tokens [B, 1 + N, D] (class token first): the class
    token and, per sample, the `max(1, int(N * (1 - rate)))` patches of
    lowest `scores` [B, N], in that order of scores (the JAX package's
    `patch_dropout` with its uniform draw passed in)."""
    num_keep = max(1, int(scores.shape[1] * (1 - rate)))
    keep = torch.argsort(scores, dim=-1, stable=True)[:, :num_keep] + 1
    patches = torch.gather(x, 1, keep[..., None].expand(-1, -1, x.shape[-1]))
    return torch.cat([x[:, :1], patches], dim=1)


def patch_dropout_scores(seed: int, step: int, batch: int, num_patches: int,
                         device) -> torch.Tensor:
    """Uniform scores [batch, num_patches] for `keep_patches`, drawn on
    `device` from a generator seeded from (`seed`, `step`)."""
    mixed = int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0])
    g = torch.Generator(device=device).manual_seed(mixed)
    return torch.rand(batch, num_patches, generator=g, device=device)


class VisionTower(nn.Module):
    """CLIP-ViT vision tower: patch embedding, class token, ln_pre,
    transformer, ln_post, class-token pool, projection."""

    def __init__(self, cfg: VisionConfig, quick_gelu: bool = False):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.patch_embedding = nn.Parameter(
            torch.zeros(cfg.patch_size * cfg.patch_size * 3, w))
        self.class_embedding = nn.Parameter(torch.zeros(w))
        self.positional_embedding = nn.Parameter(torch.zeros(cfg.num_tokens, w))
        self.ln_pre = layers.LayerNorm(w, cfg.ln_eps)
        self.blocks = layers.Transformer(w, cfg.layers, cfg.heads,
                                         int(w * cfg.mlp_ratio),
                                         _act(quick_gelu), cfg.ln_eps)
        self.ln_post = layers.LayerNorm(w, cfg.ln_eps)
        self.proj = nn.Parameter(torch.zeros(w, cfg.output_dim))
        # None: compute in the stored weights' dtype
        self.compute_dtype: Optional[torch.dtype] = None

    @property
    def dtype(self) -> torch.dtype:
        """The dtype of activations and features."""
        return self.compute_dtype or self.patch_embedding.dtype

    def init_weights(self, generator: torch.Generator) -> None:
        scale = self.cfg.width ** -0.5
        layers.normal_(self.patch_embedding, scale, generator)
        layers.normal_(self.class_embedding, scale, generator)
        layers.normal_(self.positional_embedding, scale, generator)
        self.blocks.init_weights(generator)
        layers.normal_(self.proj, scale, generator)

    def encode_image(self, images: torch.Tensor, normalize: bool = False,
                     remat: bool = False,
                     dropout: Optional[torch.Tensor] = None) -> torch.Tensor:
        """NHWC images [B, H, W, 3] -> image features [B, output_dim].
        `remat` recomputes each block in the backward pass.  `dropout`, the
        scores [B, num patches] of `patch_dropout_scores`, applies the
        config's `patch_dropout` (none at rate 0)."""
        dtype = self.dtype
        x = patchify(images.to(dtype), self.cfg.patch_size) \
            @ self.patch_embedding.to(dtype)
        cls = self.class_embedding.to(dtype).expand(x.shape[0], 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dtype)
        if dropout is not None and self.cfg.patch_dropout > 0:
            x = keep_patches(x, self.cfg.patch_dropout, dropout)
        x = self.ln_pre(x)
        x = self.blocks(x, packed=(x.shape[1], False), remat=remat)
        pooled = self.ln_post(x)[:, 0] @ self.proj.to(dtype)
        return l2_normalize(pooled) if normalize else pooled


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

class CLIP(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        self.text = TextTower(cfg.text, cfg.quick_gelu)
        self.visual = VisionTower(cfg.vision, cfg.quick_gelu)
        self.logit_scale = nn.Parameter(torch.tensor(cfg.init_logit_scale))

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's init distributions, drawn from `generator`."""
        self.text.init_weights(generator)
        self.visual.init_weights(generator)

    def encode_text(self, tokens: torch.Tensor, normalize: bool = False,
                    pack: bool = True) -> torch.Tensor:
        return self.text.encode_text(tokens, normalize, pack)

    def encode_image(self, images: torch.Tensor,
                     normalize: bool = False) -> torch.Tensor:
        return self.visual.encode_image(images, normalize)

    def forward(self, images: Optional[torch.Tensor] = None,
                tokens: Optional[torch.Tensor] = None,
                dropout: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """The joint forward: {image_features, text_features} (normalised,
        each present when its input is) and `logit_scale` = exp of the
        parameter.  `dropout`: `VisionTower.encode_image`'s patch scores."""
        out = {"logit_scale": self.logit_scale.exp()}
        if images is not None:
            out["image_features"] = self.visual.encode_image(
                images, True, dropout=dropout)
        if tokens is not None:
            out["text_features"] = self.text.encode_text(tokens, True)
        return out

    def get_logits(self, images: torch.Tensor, tokens: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(image logits [B_img, B_txt], text logits [B_txt, B_img]): the
        scaled cosine similarities of the normalised features."""
        out = self(images, tokens)
        image_logits = (out["logit_scale"] * out["image_features"]
                        @ out["text_features"].T)
        return image_logits, image_logits.T
