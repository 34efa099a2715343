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
tokens as in the JAX package) under a block-diagonal pattern, causal
unless the config has `no_causal_mask` (SigLIP, CLIPA, MobileCLIP-S1/S2);
every block then runs the fused attention sub-block with `packed=(S,
causal)`.  The projection may carry a bias (`proj_bias`, SigLIP).

Vision: the ViT tower of every ViT family.  Its parts follow the config:
an optional patch bias (timm towers), class token (none in SigLIP and the
timm gap-ViT) and `ln_pre` (none in timm towers and CLIPA); every block
runs with `packed=(T, False)`, one image per row; then the pool, one of
the SigLIP MAP head (`AttnPool`), the class token ('tok'), the mean of all
tokens ('avg') or of the tokens after the first ('avg_patch'), with
`ln_post` before it or, for CLIPA (`final_ln_after_pool`), after it; last
the head, which is whatever the weights carry, as in the JAX package: a
projection with an optional bias, timm's MLP head (`head_mlp`), or none
(features at the trunk's width).  Images are NHWC, and the patch
embedding is a reshape plus one matmul (the stride-p conv of OpenCLIP,
`patchify`).  The other towers are built from the config, as the JAX
package's `init_clip` and `encode_image_model` dispatch: a ModifiedResNet
where `cfg.resnet` is set (`models/resnet.py`), a ConvNeXt where
`cfg.convnext` is (`models/convnext.py`), and a timm trunk (MobileCLIP,
EVA, ViTamin, Swin, RelPos-ViT) where `cfg.trunk` is, through
`models/trunks.py`; each has the same `encode_image`.  The text tower is
an HF encoder with its pooler and head (`models/hf_text.HFTextTower`,
fp32, the JAX package's CustomTextCLIP route) where `cfg.text.
hf_model_name` is set; `encode_text` dispatches to it.

Train-time patch dropout keeps the class token, where the tower has one,
and a random subset of the patch tokens after the positional embedding
(`keep_patches`, given the uniform scores that `patch_dropout_scores`
draws).  `CLIP.forward` is the joint forward of the contrastive trainer;
with a `logit_bias` (SigLIP) it returns it, and `get_logits` adds it.
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
        self.text_projection_bias = (nn.Parameter(torch.zeros(cfg.output_dim))
                                     if cfg.proj_bias else None)
        # None: compute in the stored weights' dtype
        self.compute_dtype: Optional[torch.dtype] = None
        # a `parallel.sharding.Grid` once the tower holds its shards
        self.tp = None

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
        if self.tp is not None:
            from leaf_tpu_torch.parallel.sharding import embed_tokens
            return embed_tokens(self, tokens)
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
        """ln_final -> pool -> projection (+ bias) -> normalize, shared by the
        packed and unpacked paths."""
        x = self.ln_final(x)
        if x.shape[0] != tokens.shape[0]:
            x = x.reshape(tokens.shape[0], tokens.shape[1], x.shape[-1])
        pooled = text_pool(x, tokens, self.cfg.pool_type)
        pooled = pooled @ self.text_projection.to(pooled.dtype)
        if self.text_projection_bias is not None:
            pooled = pooled + self.text_projection_bias.to(pooled.dtype)
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


def keep_patches(x: torch.Tensor, rate: float, scores: torch.Tensor,
                 cls_token: bool = True) -> torch.Tensor:
    """Patch dropout of tokens [B, 1 + N, D] (class token first), or [B, N,
    D] without `cls_token`: the class token, if any, and, per sample, the
    `max(1, int(N * (1 - rate)))` patches of lowest `scores` [B, N], in that
    order of scores (the JAX package's `patch_dropout` with its uniform draw
    passed in)."""
    lead = 1 if cls_token else 0
    num_keep = max(1, int(scores.shape[1] * (1 - rate)))
    keep = torch.argsort(scores, dim=-1, stable=True)[:, :num_keep] + lead
    patches = torch.gather(x, 1, keep[..., None].expand(-1, -1, x.shape[-1]))
    return torch.cat([x[:, :1], patches], dim=1) if cls_token else patches


def patch_dropout_scores(seed: int, step: int, batch: int, num_patches: int,
                         device) -> torch.Tensor:
    """Uniform scores [batch, num_patches] for `keep_patches`, drawn on
    `device` from a generator seeded from (`seed`, `step`)."""
    mixed = int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0])
    g = torch.Generator(device=device).manual_seed(mixed)
    return torch.rand(batch, num_patches, generator=g, device=device)


class AttnPool(nn.Module):
    """The MAP attention-pooling head of SigLIP towers (timm's
    `AttentionPoolLatent`, the JAX package's `attn_pool`): a learned probe
    token cross-attends over all tokens with fp32 logits and softmax, then
    an LN + GELU-MLP residual refines the pooled vector.  Plain PyTorch, as
    the JAX package computes it outside any Pallas kernel; its LayerNorm is
    the LayerNorm op.  The MLP inherits the trunk's `mlp_ratio` (SO400M:
    4,304 hidden units)."""

    def __init__(self, width: int, heads: int, mlp_ratio: float,
                 ln_eps: float):
        super().__init__()
        self.n_heads = heads
        self.probe = nn.Parameter(torch.zeros(1, width))
        self.q_w = nn.Parameter(torch.zeros(width, width))
        self.q_b = nn.Parameter(torch.zeros(width))
        self.kv_w = nn.Parameter(torch.zeros(width, 2 * width))
        self.kv_b = nn.Parameter(torch.zeros(2 * width))
        self.proj_w = nn.Parameter(torch.zeros(width, width))
        self.proj_b = nn.Parameter(torch.zeros(width))
        self.ln = layers.LayerNorm(width, ln_eps)
        self.mlp = layers.Mlp(width, int(width * mlp_ratio), layers.gelu)

    def init_weights(self, generator: torch.Generator) -> None:
        scale = self.probe.shape[1] ** -0.5
        for t in (self.probe, self.q_w, self.kv_w, self.proj_w,
                  self.mlp.fc_w, self.mlp.proj_w):
            layers.normal_(t, scale, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Tokens [B, S, D] -> pooled [B, D]."""
        B, S, D = x.shape
        hd = D // self.n_heads
        dt = x.dtype
        q = self.probe.to(dt) @ self.q_w.to(dt) + self.q_b.to(dt)   # [1, D]
        q = q.expand(B, D).reshape(B, 1, self.n_heads, hd)
        k, v = (x @ self.kv_w.to(dt) + self.kv_b.to(dt)).split(D, dim=-1)
        k = k.reshape(B, S, self.n_heads, hd)
        v = v.reshape(B, S, self.n_heads, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
            * (hd ** -0.5)
        probs = torch.softmax(logits, dim=-1).to(dt)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, 1, D)
        out = out @ self.proj_w.to(dt) + self.proj_b.to(dt)
        out = out + self.mlp(self.ln(out))
        return out[:, 0]


class VisionTower(nn.Module):
    """The ViT tower of every ViT family (the JAX package's
    `encode_image`): patch embedding (+ bias), class token, positions,
    ln_pre, transformer, then the pool and the head, each part as the
    config and the weights have it (the module docstring)."""

    def __init__(self, cfg: VisionConfig, quick_gelu: bool = False):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.patch_embedding = nn.Parameter(
            torch.zeros(cfg.patch_size * cfg.patch_size * 3, w))
        self.patch_bias = (nn.Parameter(torch.zeros(w)) if cfg.patch_bias
                           else None)
        self.class_embedding = (nn.Parameter(torch.zeros(w)) if cfg.cls_token
                                else None)
        self.positional_embedding = nn.Parameter(torch.zeros(cfg.num_tokens, w))
        self.ln_pre = layers.LayerNorm(w, cfg.ln_eps) if cfg.ln_pre else None
        self.blocks = layers.Transformer(w, cfg.layers, cfg.heads,
                                         int(w * cfg.mlp_ratio),
                                         _act(quick_gelu), cfg.ln_eps)
        self.ln_post = layers.LayerNorm(w, cfg.ln_eps)
        self.attn_pool = (AttnPool(w, cfg.heads, cfg.mlp_ratio, cfg.ln_eps)
                          if cfg.attn_pool else None)
        # the head: the seeded init has the projection alone, as the JAX
        # package's; a checkpoint brings its own (`_load_from_state_dict`)
        self.proj = nn.Parameter(torch.zeros(w, cfg.output_dim))
        self.register_parameter("proj_bias", None)
        self.head_mlp: Optional[nn.ParameterDict] = None
        # None: compute in the stored weights' dtype
        self.compute_dtype: Optional[torch.dtype] = None

    @property
    def dtype(self) -> torch.dtype:
        """The dtype of activations and features."""
        return self.compute_dtype or self.patch_embedding.dtype

    def init_weights(self, generator: torch.Generator) -> None:
        scale = self.cfg.width ** -0.5
        layers.normal_(self.patch_embedding, scale, generator)
        if self.class_embedding is not None:
            layers.normal_(self.class_embedding, scale, generator)
        layers.normal_(self.positional_embedding, scale, generator)
        self.blocks.init_weights(generator)
        layers.normal_(self.proj, scale, generator)
        if self.attn_pool is not None:
            self.attn_pool.init_weights(generator)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        """Take the head the weights carry: `proj` with or without
        `proj_bias`, timm's `head_mlp.{fc_w, fc_b, proj_w[, proj_b]}`, or
        none of them (features at the tower's width).  A head part whose
        name and shape the weights share is kept as it is (an optimizer may
        hold it)."""
        like = self.patch_embedding

        def param(t):
            return nn.Parameter(torch.empty(t.shape, dtype=like.dtype,
                                            device=like.device))

        for name in ("proj", "proj_bias"):
            t, cur = state_dict.get(prefix + name), getattr(self, name)
            if t is None:
                self.register_parameter(name, None)
            elif cur is None or cur.shape != t.shape:
                self.register_parameter(name, param(t))
        mlp = {k[len(prefix) + len("head_mlp."):]: v
               for k, v in state_dict.items()
               if k.startswith(prefix + "head_mlp.")}
        have = ({} if self.head_mlp is None else
                {k: v.shape for k, v in self.head_mlp.items()})
        if have != {k: v.shape for k, v in mlp.items()}:
            self.head_mlp = (nn.ParameterDict({k: param(v) for k, v in
                                               mlp.items()})
                             if mlp else None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def _pool(self, x: torch.Tensor) -> torch.Tensor:
        if self.attn_pool is not None:
            return self.attn_pool(x)
        if self.cfg.pool_type == "tok":
            return x[:, 0]
        if self.cfg.pool_type == "avg":
            return x.mean(dim=1)
        if self.cfg.pool_type == "avg_patch":   # timm global_pool='avg'
            return x[:, 1:].mean(dim=1)
        raise ValueError(f"unsupported pool_type {self.cfg.pool_type!r}")

    def _head(self, pooled: torch.Tensor) -> torch.Tensor:
        dt = pooled.dtype
        if self.head_mlp is not None:          # timm proj='mlp'
            h = self.head_mlp
            pooled = layers.gelu(pooled @ h["fc_w"].to(dt) + h["fc_b"].to(dt))
            pooled = pooled @ h["proj_w"].to(dt)
            if "proj_b" in h:
                pooled = pooled + h["proj_b"].to(dt)
        elif self.proj is not None:
            pooled = pooled @ self.proj.to(dt)
            if self.proj_bias is not None:
                pooled = pooled + self.proj_bias.to(dt)
        return pooled

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
        if self.patch_bias is not None:
            x = x + self.patch_bias.to(dtype)
        if self.class_embedding is not None:
            cls = self.class_embedding.to(dtype).expand(x.shape[0], 1,
                                                        x.shape[-1])
            x = torch.cat([cls, x], dim=1)
        x = x + self.positional_embedding.to(dtype)
        if dropout is not None and self.cfg.patch_dropout > 0:
            x = keep_patches(x, self.cfg.patch_dropout, dropout,
                             self.class_embedding is not None)
        if self.ln_pre is not None:
            x = self.ln_pre(x)
        x = self.blocks(x, packed=(x.shape[1], False), remat=remat)
        if self.cfg.final_ln_after_pool and self.attn_pool is None:
            pooled = self.ln_post(self._pool(x))   # CLIPA
        else:
            pooled = self._pool(self.ln_post(x))
        pooled = self._head(pooled)
        return l2_normalize(pooled) if normalize else pooled


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

class CLIP(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.text.hf_model_name:
            # CustomTextCLIP: an HF encoder, its pooler and head, fp32
            from leaf_tpu_torch.models.hf_text import HFTextTower
            self.text = HFTextTower(cfg.text.hf_model_name, cfg.embed_dim,
                                    cfg.text.hf_pooler_type,
                                    cfg.text.hf_proj_type)
        else:
            self.text = TextTower(cfg.text, cfg.quick_gelu)
        if cfg.resnet is not None:
            from leaf_tpu_torch.models.resnet import ModifiedResNet
            self.visual = ModifiedResNet(cfg.resnet)
        elif cfg.convnext is not None:
            from leaf_tpu_torch.models.convnext import ConvNeXt
            self.visual = ConvNeXt(cfg.convnext)
        elif cfg.trunk is not None:
            from leaf_tpu_torch.models import trunks
            self.visual = trunks.build(cfg.trunk)
        else:
            self.visual = VisionTower(cfg.vision, cfg.quick_gelu)
        self.logit_scale = nn.Parameter(torch.tensor(cfg.init_logit_scale))
        self.logit_bias = (None if cfg.init_logit_bias is None else
                           nn.Parameter(torch.tensor(float(cfg.init_logit_bias))))

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
        each present when its input is), `logit_scale` = exp of the
        parameter and, where the model has one, `logit_bias`.  `dropout`:
        `VisionTower.encode_image`'s patch scores."""
        out = {"logit_scale": self.logit_scale.exp()}
        if images is not None:
            out["image_features"] = self.visual.encode_image(
                images, True, dropout=dropout)
        if tokens is not None:
            out["text_features"] = self.text.encode_text(tokens, True)
        if self.logit_bias is not None:
            out["logit_bias"] = self.logit_bias
        return out

    def get_logits(self, images: torch.Tensor, tokens: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(image logits [B_img, B_txt], text logits [B_txt, B_img]): the
        scaled cosine similarities of the normalised features, plus the
        logit bias where the model has one."""
        out = self(images, tokens)
        image_logits = (out["logit_scale"] * out["image_features"]
                        @ out["text_features"].T)
        if "logit_bias" in out:
            image_logits = image_logits + out["logit_bias"]
        return image_logits, image_logits.T
