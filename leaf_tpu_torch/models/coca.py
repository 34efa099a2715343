"""CoCa, the contrastive captioner (port of `leaf_tpu/models/coca.py`).

  * the vision tower with a 256-query attentional pooler: the contrastive
    latent is pooled token 0, the image embeddings tokens 1..n;
  * the text tower with a CLS embedding appended at the END of the
    sequence, pooled there with `ln_final` after the pool, under a
    per-sample additive mask: causal, and pad columns masked in the CLS
    row alone (`cls_mask`);
  * the multimodal decoder: per layer a causal self-attention block, then
    a cross-attention block over the image embeddings (`ln_1_kv` on the
    keys and values), `ln_final` and the projection to the vocabulary.

Parameter names follow the JAX pytree (`visual.attn_pool.q_w`,
`text.cls_emb`, `text_decoder.cross_blocks.<i>.ln_1_kv.scale`, ...), so
`coca_interop.coca_params_from_jax` carries JAX weights across.  Weights
stay fp32; a tower computes in its `compute_dtype` (fp32 unless set) and
casts each weight where it uses it, as the JAX functions' `dtype` does.

Which kernels run: the vision stack goes through `layers.Transformer`
with `packed=(T, False)`, so on a card every block is one
`ops.fused_attention_block` call, and every LayerNorm of the three towers
(the pooler's `ln_k`/`ln_q` included) is the `ops.packed_attention.
layer_norm` op.  The text stack, the decoder, the cross-attention, the
pooler's attention and the cached attention of `decode_one` are plain
PyTorch: the JAX package computes them with plain `einsum` and `softmax`
outside any Pallas kernel.

Generation keeps a KV cache (`init_generation_cache`, `decode_one`):
both the text tower and the decoder are causal in their token positions
(the CLS sits at the end and ordinary positions never see it), so caching
is exact.  `generate` (greedy, top-k, top-p) and `generate_beamsearch`
(group beam search) run a Python loop over the fixed number of positions,
as JAX's scan does, on preallocated caches, with no read of a device value
inside the loop.  An HF text tower (`coca_roberta-*`: RoBERTa,
`models/hf_text.py`, fp32, mean-pooled over its bidirectional encoder) is
not prefix-stable, so its configs re-encode the whole sequence at every
step, as the JAX package's `use_cache=False` does.  No module-level tower
cache is kept: each `CoCa` owns its tower.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Tuple

import torch
from torch import nn

from leaf_tpu_torch.models import layers
from leaf_tpu_torch.models.clip import (TextTower, VisionTower, _act,
                                        l2_normalize, patchify)
from leaf_tpu_torch.models.config import TextConfig, VisionConfig
from leaf_tpu_torch.models.hf_text import HFTextTower

LOG = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class MultimodalConfig:
    context_length: int = 76
    width: int = 512
    heads: int = 8
    layers: int = 12
    mlp_ratio: float = 4.0
    vocab_size: int = 49408
    ln_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class CoCaConfig:
    name: str
    embed_dim: int
    text: TextConfig
    vision: VisionConfig
    multimodal: MultimodalConfig
    n_queries: int = 256
    attn_pooler_heads: int = 8
    quick_gelu: bool = False
    init_logit_scale: float = 2.6592
    pad_id: int = 0
    # generation's special ids (the CLIP BPE's; roberta's are 0 / 2 / 1)
    sot_token_id: int = 49406
    eos_token_id: int = 49407
    # set: the text tower is this HF model (`models/hf_text.py`)
    hf_text_name: Optional[str] = None
    hf_pooler: str = "mean_pooler"
    hf_proj: Optional[str] = "linear"
    image_mean: Optional[Tuple[float, float, float]] = None
    image_std: Optional[Tuple[float, float, float]] = None


# -- registry (OpenCLIP's `model_configs/coca_*.json`) -----------------------

def coca_vit_b_32() -> CoCaConfig:
    return CoCaConfig(
        name="coca_ViT-B-32", embed_dim=512,
        text=TextConfig(context_length=76, width=512, heads=8, layers=12,
                        output_dim=512),
        vision=VisionConfig(image_size=224, patch_size=32, width=768,
                            layers=12, output_dim=512),
        multimodal=MultimodalConfig(context_length=76, width=512, heads=8,
                                    layers=12))


def coca_vit_l_14() -> CoCaConfig:
    return CoCaConfig(
        name="coca_ViT-L-14", embed_dim=768,
        text=TextConfig(context_length=76, width=768, heads=12, layers=12,
                        output_dim=768),
        vision=VisionConfig(image_size=224, patch_size=14, width=1024,
                            layers=24, output_dim=768),
        multimodal=MultimodalConfig(context_length=76, width=768, heads=12,
                                    layers=12))


def coca_base() -> CoCaConfig:
    """The 64k-vocabulary paper config: 288 px, patch 18, width-768 towers."""
    return CoCaConfig(
        name="coca_base", embed_dim=512,
        text=TextConfig(context_length=76, vocab_size=64000, width=768,
                        heads=12, layers=12, output_dim=512),
        vision=VisionConfig(image_size=288, patch_size=18, width=768,
                            layers=12, output_dim=512),
        multimodal=MultimodalConfig(context_length=76, vocab_size=64000,
                                    width=768, heads=12, layers=12),
        n_queries=256, attn_pooler_heads=8)


def coca_roberta_vit_b_32() -> CoCaConfig:
    """roberta-base text tower, ViT-B-32 vision, width-768 decoder.  As in
    OpenCLIP (and the JAX package), the decoder's cross-attention is
    768 wide while the pooler emits 512-wide image embeddings, so the
    captioning forward and generation fail on the shapes; the contrastive
    towers work."""
    return CoCaConfig(
        name="coca_roberta-ViT-B-32", embed_dim=512,
        text=TextConfig(context_length=76, width=768, heads=12, layers=12,
                        output_dim=512),
        vision=VisionConfig(image_size=224, patch_size=32, width=768,
                            layers=12, output_dim=512),
        multimodal=MultimodalConfig(context_length=76, width=768, heads=8,
                                    layers=12),
        hf_text_name="roberta-base",
        pad_id=1, sot_token_id=0, eos_token_id=2)


def coca_roberta_tiny_test() -> CoCaConfig:
    """A 2-layer roberta tower at test size, with widths that agree (embed
    = decoder width = HF hidden size), so captioning runs."""
    return CoCaConfig(
        name="coca-roberta-tiny-test", embed_dim=64,
        text=TextConfig(context_length=16, width=64, heads=2, layers=2,
                        output_dim=64),
        vision=VisionConfig(image_size=64, patch_size=16, width=64,
                            layers=2, head_width=32, output_dim=64),
        multimodal=MultimodalConfig(context_length=16, width=64, heads=2,
                                    layers=2, vocab_size=100),
        n_queries=8, attn_pooler_heads=2,
        hf_text_name="_tiny_roberta_test")


def coca_tiny_test() -> CoCaConfig:
    """Test size (not an OpenCLIP config; mirrors ViT-tiny-test)."""
    return CoCaConfig(
        name="coca-tiny-test", embed_dim=64,
        text=TextConfig(context_length=16, width=64, heads=2, layers=2,
                        output_dim=64),
        vision=VisionConfig(image_size=64, patch_size=16, width=64,
                            layers=2, head_width=32, output_dim=64),
        multimodal=MultimodalConfig(context_length=16, width=64, heads=2,
                                    layers=2),
        n_queries=8, attn_pooler_heads=2)


COCA_CONFIGS = {"coca_ViT-B-32": coca_vit_b_32, "coca_ViT-L-14": coca_vit_l_14,
                "coca_base": coca_base, "coca-tiny-test": coca_tiny_test,
                "coca_roberta-ViT-B-32": coca_roberta_vit_b_32,
                "coca-roberta-tiny-test": coca_roberta_tiny_test}


def get_coca_config(name: str) -> CoCaConfig:
    if name not in COCA_CONFIGS:
        raise KeyError(f"unknown CoCa model {name!r}; "
                       f"available: {sorted(COCA_CONFIGS)}")
    return COCA_CONFIGS[name]()


# -- masks and attention -------------------------------------------------------

def causal_mask(seq_len: int, device=None) -> torch.Tensor:
    """Additive causal mask [S, S], -inf above the diagonal."""
    return torch.full((seq_len, seq_len), float("-inf"),
                      device=device).triu(1)


def cls_mask(tokens: torch.Tensor, pad_id: int) -> torch.Tensor:
    """Per-sample additive mask [B, S+1, S+1]: only the appended CLS row
    (the last query) masks pad columns; the token rows are governed by the
    causal mask alone, so that the pad positions' activations equal the
    JAX package's (and OpenCLIP's)."""
    B, S = tokens.shape
    col_ok = torch.cat([torch.ones(B, 1, dtype=torch.bool,
                                   device=tokens.device), tokens != pad_id], 1)
    add = torch.zeros(B, S + 1, S + 1, device=tokens.device)
    add[:, S] = torch.where(col_ok, 0.0, float("-inf"))
    return add


def _split_heads(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    N, S, D = t.shape
    return t.reshape(N, S, n_heads, D // n_heads).transpose(1, 2)


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    N, H, S, hd = t.shape
    return t.transpose(1, 2).reshape(N, S, H * hd)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
            ) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd)) v on heads [N, H, *, hd], logits and
    softmax in fp32, the probabilities cast back to q's dtype."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        * (q.shape[-1] ** -0.5)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


class AttentionalPooler(nn.Module):
    """`n_queries` learned queries attending over the vision tokens:
    [B, N, context_dim] -> [B, n_queries, d_model] (OpenCLIP's
    AttentionalPooler: LayerNorms on queries and keys, one multi-head
    attention with separate q/k/v weights)."""

    def __init__(self, d_model: int, context_dim: int, n_queries: int,
                 n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.query = nn.Parameter(torch.zeros(n_queries, d_model))
        self.ln_q = layers.LayerNorm(d_model)
        self.ln_k = layers.LayerNorm(context_dim)
        self.q_w = nn.Parameter(torch.zeros(d_model, d_model))
        self.k_w = nn.Parameter(torch.zeros(context_dim, d_model))
        self.v_w = nn.Parameter(torch.zeros(context_dim, d_model))
        self.qkv_b = nn.Parameter(torch.zeros(3 * d_model))
        self.out_w = nn.Parameter(torch.zeros(d_model, d_model))
        self.out_b = nn.Parameter(torch.zeros(d_model))

    def init_weights(self, generator: torch.Generator) -> None:
        s = self.q_w.shape[1] ** -0.5
        layers.normal_(self.query, 1.0, generator)
        for w in (self.q_w, self.k_w, self.v_w, self.out_w):
            layers.normal_(w, s, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype, B = x.dtype, x.shape[0]
        keys = self.ln_k(x)
        q_in = self.ln_q(self.query.to(dtype)[None])
        b_q, b_k, b_v = self.qkv_b.to(dtype).chunk(3)
        q = _split_heads(q_in @ self.q_w.to(dtype) + b_q, self.n_heads)
        k = _split_heads(keys @ self.k_w.to(dtype) + b_k, self.n_heads)
        v = _split_heads(keys @ self.v_w.to(dtype) + b_v, self.n_heads)
        out = _merge_heads(_attend(q.expand(B, -1, -1, -1), k, v))
        return out @ self.out_w.to(dtype) + self.out_b.to(dtype)


# -- towers --------------------------------------------------------------------

class CoCaVisionTower(VisionTower):
    """The CLIP vision tower with the attentional pooler in place of the
    class-token pool: `ln_post` and `proj` act on `embed_dim`."""

    def __init__(self, cfg: CoCaConfig):
        super().__init__(cfg.vision, cfg.quick_gelu)
        e = cfg.embed_dim
        self.ln_post = layers.LayerNorm(e, cfg.vision.ln_eps)
        self.proj = nn.Parameter(torch.zeros(e, e))
        self.attn_pool = AttentionalPooler(e, cfg.vision.width, cfg.n_queries,
                                           cfg.attn_pooler_heads)

    def init_weights(self, generator: torch.Generator) -> None:
        super().init_weights(generator)
        layers.normal_(self.proj, self.proj.shape[0] ** -0.5, generator)
        self.attn_pool.init_weights(generator)

    def encode(self, images: torch.Tensor, normalize: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC images -> (latent [B, embed_dim], image embeddings
        [B, n_queries - 1, embed_dim])."""
        dtype = self.dtype
        x = patchify(images.to(dtype), self.cfg.patch_size) \
            @ self.patch_embedding.to(dtype)
        cls = self.class_embedding.to(dtype).expand(x.shape[0], 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dtype)
        x = self.ln_pre(x)
        x = self.blocks(x, packed=(x.shape[1], False))
        x = self.ln_post(self.attn_pool(x))
        pooled = x[:, 0] @ self.proj.to(dtype)
        return (l2_normalize(pooled) if normalize else pooled), x[:, 1:]

    def encode_image(self, images: torch.Tensor,
                     normalize: bool = False) -> torch.Tensor:
        return self.encode(images, normalize)[0]


class CoCaTextTower(TextTower):
    """The CLIP text tower with a CLS embedding appended at the end (one
    more positional slot), run unpacked under `causal + cls_mask`."""

    def __init__(self, cfg: CoCaConfig):
        super().__init__(cfg.text, cfg.quick_gelu)
        w = cfg.text.width
        self.positional_embedding = nn.Parameter(
            torch.zeros(cfg.text.context_length + 1, w))
        self.cls_emb = nn.Parameter(torch.zeros(w))
        self.pad_id = cfg.pad_id

    def init_weights(self, generator: torch.Generator) -> None:
        super().init_weights(generator)
        layers.normal_(self.cls_emb, 0.01, generator)

    def encode(self, tokens: torch.Tensor, normalize: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Token ids [B, S] -> (latent [B, output_dim], token embeddings
        [B, S, width])."""
        dtype = self.dtype
        B, S = tokens.shape
        x = self.token_embedding[tokens.long()].to(dtype)
        cls = self.cls_emb.to(dtype).expand(B, 1, x.shape[-1])
        x = torch.cat([x, cls], dim=1) \
            + self.positional_embedding[:S + 1].to(dtype)
        mask = causal_mask(S + 1, tokens.device)[None] \
            + cls_mask(tokens, self.pad_id)
        x = self.blocks(x, mask)
        pooled = self.ln_final(x[:, -1].contiguous())
        pooled = pooled @ self.text_projection.to(dtype)
        return (l2_normalize(pooled) if normalize else pooled), x[:, :-1]

    def encode_text(self, tokens: torch.Tensor,
                    normalize: bool = False) -> torch.Tensor:
        return self.encode(tokens, normalize)[0]


class CoCaHFText(HFTextTower):
    """An HF text tower in a CoCa (the JAX package's `encode_text_coca` for
    `hf_text_name` configs): the pooled latent, normalised, and the token
    states, both cast to the CoCa's compute dtype."""

    def __init__(self, cfg: CoCaConfig):
        super().__init__(cfg.hf_text_name, output_dim=cfg.embed_dim,
                         pooler_type=cfg.hf_pooler, proj_type=cfg.hf_proj)

    def encode(self, tokens: torch.Tensor, normalize: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        pooled, token_embs = self.call_with_tokens(tokens)
        if normalize:
            pooled = l2_normalize(pooled)
        return pooled.to(self.dtype), token_embs.to(self.dtype)

    def encode_text(self, tokens: torch.Tensor,
                    normalize: bool = False) -> torch.Tensor:
        return self.encode(tokens, normalize)[0]


class CrossBlock(layers.ResidualBlock):
    """A decoder layer's cross-attention block: queries from `ln_1(h)`,
    keys and values from `ln_1_kv(image embeddings)` (the q / k / v column
    blocks of the fused `attn.qkv_w`, torch MultiheadAttention's packed
    layout), then the MLP."""

    def __init__(self, width: int, heads: int, mlp_width: int, act,
                 ln_eps: float):
        super().__init__(width, heads, mlp_width, act, ln_eps)
        self.ln_1_kv = layers.LayerNorm(width, ln_eps)

    def kv(self, image_embs: torch.Tensor, dtype: torch.dtype
           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The image side's keys and values, heads split [N, H, n, hd]."""
        D = image_embs.shape[-1]
        kv_in = self.ln_1_kv(image_embs.contiguous())
        w, b = self.attn["qkv_w"].to(dtype), self.attn["qkv_b"].to(dtype)
        k = kv_in @ w[:, D:2 * D] + b[D:2 * D]
        v = kv_in @ w[:, 2 * D:] + b[2 * D:]
        return _split_heads(k, self.n_heads), _split_heads(v, self.n_heads)

    def cross(self, h: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
        """h + cross-attention over (k, v), then h + MLP."""
        dtype, D = h.dtype, h.shape[-1]
        w, b = self.attn["qkv_w"].to(dtype), self.attn["qkv_b"].to(dtype)
        q = _split_heads(self.ln_1(h) @ w[:, :D] + b[:D], self.n_heads)
        o = _merge_heads(_attend(q, k, v))
        h = h + (o @ self.attn["out_w"].to(dtype) + self.attn["out_b"].to(dtype))
        return h + self.mlp(self.ln_2(h))

    def forward(self, h: torch.Tensor, image_embs: torch.Tensor
                ) -> torch.Tensor:
        return self.cross(h, *self.kv(image_embs, h.dtype))


class MultimodalDecoder(nn.Module):
    def __init__(self, cfg: CoCaConfig):
        super().__init__()
        m = cfg.multimodal
        act, mlp_w = _act(cfg.quick_gelu), int(m.width * m.mlp_ratio)
        self.heads = m.heads
        self.blocks = layers.Transformer(m.width, m.layers, m.heads, mlp_w,
                                         act, m.ln_eps)
        self.cross_blocks = nn.ModuleList(
            CrossBlock(m.width, m.heads, mlp_w, act, m.ln_eps)
            for _ in range(m.layers))
        self.ln_final = layers.LayerNorm(m.width, m.ln_eps)
        self.text_projection = nn.Parameter(torch.zeros(m.width, m.vocab_size))

    def init_weights(self, generator: torch.Generator) -> None:
        self.blocks.init_weights(generator)
        for block in self.cross_blocks:
            block.init_weights(generator, len(self.cross_blocks))
        layers.normal_(self.text_projection,
                       self.text_projection.shape[0] ** -0.5, generator)

    def forward(self, image_embs: torch.Tensor, token_embs: torch.Tensor
                ) -> torch.Tensor:
        """-> vocabulary logits [B, S, V] in the token embeddings' dtype."""
        x = token_embs.contiguous()
        image_embs = image_embs.to(x.dtype)
        mask = causal_mask(x.shape[1], x.device)
        for block, cross in zip(self.blocks, self.cross_blocks):
            x = cross(block(x, mask), image_embs)
        x = self.ln_final(x)
        return x @ self.text_projection.to(x.dtype)


class CoCa(nn.Module):
    def __init__(self, cfg: CoCaConfig):
        super().__init__()
        self.cfg = cfg
        self.text = CoCaHFText(cfg) if cfg.hf_text_name else CoCaTextTower(cfg)
        self.visual = CoCaVisionTower(cfg)
        self.text_decoder = MultimodalDecoder(cfg)
        self.logit_scale = nn.Parameter(torch.tensor(cfg.init_logit_scale))

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's init distributions, drawn from `generator`."""
        self.text.init_weights(generator)
        self.visual.init_weights(generator)
        self.text_decoder.init_weights(generator)

    def set_compute_dtype(self, dtype: Optional[torch.dtype]) -> None:
        """Every tower computes in `dtype` (None: its weights' dtype)."""
        self.text.compute_dtype = self.visual.compute_dtype = dtype

    def encode_image(self, images: torch.Tensor, normalize: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (image latent [B, D], image embeddings [B, n_queries-1, D])."""
        return self.visual.encode(images, normalize)

    def encode_text(self, tokens: torch.Tensor, normalize: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (text latent [B, D], token embeddings [B, S, width])."""
        return self.text.encode(tokens, normalize)

    def decode(self, image_embs: torch.Tensor,
               token_embs: torch.Tensor) -> torch.Tensor:
        return self.text_decoder(image_embs, token_embs.to(self.text.dtype))

    def forward(self, images: torch.Tensor, tokens: torch.Tensor) -> dict:
        """The training forward with teacher forcing: the labels are
        tokens[:, 1:], the decoder reads the token embeddings [:, :-1]."""
        image_latent, image_embs = self.encode_image(images)
        text_latent, token_embs = self.encode_text(tokens)
        logits = self.decode(image_embs, token_embs[:, :-1])
        return {"image_features": image_latent,
                "text_features": text_latent, "logits": logits,
                "labels": tokens[:, 1:], "logit_scale": self.logit_scale.exp()}


def create_coca_model(name: str, pretrained: Optional[str] = None,
                      seed: int = 0, *, device="cpu") -> CoCa:
    """A CoCa model by registry name on `device`, fp32, in eval mode:
    loaded from an OpenCLIP checkpoint file (`pretrained`) or a seeded
    init made on the CPU (so that a CPU copy and a card copy of one seed
    hold the same weights)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    cfg = get_coca_config(name)
    model = CoCa(cfg)
    if pretrained:
        from leaf_tpu_torch.models.coca_interop import coca_openclip_to_params
        from leaf_tpu_torch.models.interop import load_state_dict_file
        model.load_state_dict(coca_openclip_to_params(
            load_state_dict_file(pretrained), cfg))
    else:
        model.init_weights(torch.Generator().manual_seed(seed))
    return model.to(device).eval()


# -- KV-cached incremental decoding -------------------------------------------

def _cached_self_attention(block: layers.ResidualBlock, h: torch.Tensor,
                           cache_k: torch.Tensor, cache_v: torch.Tensor,
                           pos: int) -> torch.Tensor:
    """`block`'s self-attention of one position h [N, 1, D]: its key and
    value are written into the caches [N, H, S, hd] at `pos`, and its query
    attends over columns <= pos (the key set of the full causal row)."""
    dtype, H = h.dtype, block.n_heads
    attn = {k: v.to(dtype) for k, v in block.attn.items()}
    q, k, v = (block.ln_1(h) @ attn["qkv_w"] + attn["qkv_b"]).chunk(3, -1)
    cache_k[:, :, pos:pos + 1] = _split_heads(k, H)
    cache_v[:, :, pos:pos + 1] = _split_heads(v, H)
    o = _attend(_split_heads(q, H), cache_k[:, :, :pos + 1],
                cache_v[:, :, :pos + 1])
    return _merge_heads(o) @ attn["out_w"] + attn["out_b"]


def init_generation_cache(model: CoCa, image_embs: torch.Tensor) -> tuple:
    """The cache of `decode_one` for N rows: zeroed self-attention keys and
    values of the text tower and the decoder, [layers, N, H, S, hd] over
    the multimodal context, and each decoder layer's cross-attention keys
    and values, projected once from ln_1_kv(image_embs)."""
    cfg, dtype = model.cfg, model.text.dtype
    N, S = image_embs.shape[0], cfg.multimodal.context_length

    def zeros(c):
        return torch.zeros(c.layers, N, c.heads, S, c.width // c.heads,
                           dtype=dtype, device=image_embs.device)

    img = image_embs.to(dtype)
    kv = [b.kv(img, dtype) for b in model.text_decoder.cross_blocks]
    return (zeros(cfg.text), zeros(cfg.text), zeros(cfg.multimodal),
            zeros(cfg.multimodal), torch.stack([k for k, _ in kv]),
            torch.stack([v for _, v in kv]))


def decode_one(model: CoCa, tok: torch.Tensor, pos: int, cache: tuple
               ) -> torch.Tensor:
    """One cached step: token ids [N] at position `pos` -> vocabulary
    logits [N, V] for position pos + 1; the cache is updated in place.
    Numerically the row `pos` of `encode_text` -> `decode`."""
    tk, tv, dk, dv, ck, cv = cache
    text, dec = model.text, model.text_decoder
    x = text.token_embedding[tok.long()].to(text.dtype)[:, None] \
        + text.positional_embedding[pos:pos + 1].to(text.dtype)
    for i, block in enumerate(text.blocks):
        x = x + _cached_self_attention(block, x, tk[i], tv[i], pos)
        x = x + block.mlp(block.ln_2(x))
    for i, (block, cross) in enumerate(zip(dec.blocks, dec.cross_blocks)):
        x = x + _cached_self_attention(block, x, dk[i], dv[i], pos)
        x = x + block.mlp(block.ln_2(x))
        x = cross.cross(x, ck[i], cv[i])
    x = dec.ln_final(x)
    return (x @ dec.text_projection.to(x.dtype))[:, 0]


def _next_logits(model: CoCa, tokens: torch.Tensor, pos: int,
                 cache: Optional[tuple], image_embs: torch.Tensor
                 ) -> torch.Tensor:
    """The logits [N, V] of position `pos` given tokens [N, S] whose slots
    < pos are written: one cached step (`decode_one`), or, with no cache
    (an HF text tower), the whole sequence re-encoded and decoded."""
    if cache is not None:
        return decode_one(model, tokens[:, pos - 1], pos - 1, cache)
    _, token_embs = model.encode_text(tokens)
    return model.decode(image_embs, token_embs)[:, pos - 1]


def _generation_cache(model: CoCa, image_embs: torch.Tensor
                      ) -> Optional[tuple]:
    """`init_generation_cache`, or None where the text tower is not
    prefix-stable (HF)."""
    if model.cfg.hf_text_name:
        return None
    return init_generation_cache(model, image_embs)


def top_p_filter(logits: torch.Tensor, top_p: float,
                 min_tokens_to_keep: int = 1) -> torch.Tensor:
    """Nucleus filtering with HF's TopPLogitsWarper semantics: ascending
    stable sort, drop the tokens whose inclusive cumulative probability is
    <= 1 - top_p, always keeping the `min_tokens_to_keep` most probable;
    dropped logits become -inf."""
    if not 0.0 <= top_p <= 1.0:
        raise ValueError(f"top_p must be in [0, 1], got {top_p}")
    V = logits.shape[-1]
    sorted_logits, order = torch.sort(logits, dim=-1, stable=True)
    cum = torch.softmax(sorted_logits.float(), -1).cumsum(-1)
    remove_sorted = (cum <= 1.0 - top_p) \
        & (torch.arange(V, device=logits.device) < V - min_tokens_to_keep)
    remove = torch.empty_like(remove_sorted).scatter_(-1, order,
                                                      remove_sorted)
    return logits.masked_fill(remove, float("-inf"))


def _sample(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One categorical draw per row by the Gumbel-max rule (JAX's
    `random.categorical`), from `generator`, with no host sync."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_min(torch.finfo(u.dtype).tiny)
    return (logits.float() - torch.log(-torch.log(u))).argmax(-1)


def _repetition_penalty(cur: torch.Tensor, seen: torch.Tensor,
                        penalty: float) -> torch.Tensor:
    return torch.where(seen, torch.where(cur < 0, cur * penalty,
                                         cur / penalty), cur)


def _special_ids(cfg: CoCaConfig, sot, eos, pad):
    return (cfg.sot_token_id if sot is None else sot,
            cfg.eos_token_id if eos is None else eos,
            cfg.pad_id if pad is None else pad)


@torch.no_grad()
def generate(model: CoCa, images: torch.Tensor,
             generator: Optional[torch.Generator] = None, seq_len: int = 30,
             top_k: int = 1, temperature: float = 1.0,
             top_p: Optional[float] = None, min_seq_len: int = 5,
             repetition_penalty: float = 1.0,
             sot_token_id: Optional[int] = None,
             eos_token_id: Optional[int] = None,
             pad_id: Optional[int] = None) -> torch.Tensor:
    """Caption sampling (top_k 1 is greedy) with the JAX package's
    semantics: `seq_len` counts the SOT slot (seq_len - 1 tokens are
    generated), EOS is blocked while the sequence is shorter than
    `min_seq_len`, the final slot is forced to EOS for running rows, and
    the repetition penalty discounts every token already in the sequence,
    SOT included.  `top_p` selects nucleus sampling, its keep-set taken
    from the processed logits before the temperature.  -> token ids
    [B, context_length], pad after EOS.  Sampling draws from `generator`
    (a fresh one seeded 0 by default); the JAX package draws from its own
    generator, so sampled ids differ between the two."""
    if seq_len <= min_seq_len:
        raise ValueError("seq_len must be larger than min_seq_len")
    cfg = model.cfg
    sot, eos, pad = _special_ids(cfg, sot_token_id, eos_token_id, pad_id)
    S, V = cfg.multimodal.context_length, cfg.multimodal.vocab_size
    if seq_len > S:
        # OpenCLIP slides a window over the last S tokens; the fixed-size
        # cache caps at the context instead, and says so
        LOG.warning("generate: seq_len=%d exceeds the multimodal context "
                    "length %d; capping (captions will be shorter than "
                    "requested)", seq_len, S)
    seq_len = min(seq_len, S)
    B, device = images.shape[0], images.device
    if generator is None and (top_k > 1 or top_p is not None):
        generator = torch.Generator(device=device).manual_seed(0)
    _, image_embs = model.encode_image(images)
    cache = _generation_cache(model, image_embs)
    tokens = torch.full((B, S), pad, dtype=torch.long, device=device)
    tokens[:, 0] = sot
    seen = torch.zeros(B, V, dtype=torch.bool, device=device)
    seen[:, sot] = True
    done = torch.zeros(B, dtype=torch.bool, device=device)
    for pos in range(1, seq_len):
        cur = _next_logits(model, tokens, pos, cache, image_embs)
        if repetition_penalty != 1.0:
            cur = _repetition_penalty(cur, seen, repetition_penalty)
        if pos < min_seq_len:
            cur = cur.clone()
            cur[:, eos] -= float("inf")
        if top_p is not None:
            nxt = _sample(top_p_filter(cur, top_p) / temperature, generator)
        elif top_k > 1:
            cur = cur / temperature
            kth = cur.topk(top_k, dim=-1).values[:, -1:]
            nxt = _sample(cur.masked_fill(cur < kth, float("-inf")),
                          generator)
        else:
            nxt = cur.argmax(-1)
        if pos == seq_len - 1:
            nxt = torch.full_like(nxt, eos)
        nxt = torch.where(done, pad, nxt)
        seen.scatter_(1, nxt[:, None], True)
        done = done | (nxt == eos)
        tokens[:, pos] = nxt
    return tokens


def _pool_add(pool: tuple, add_mask: torch.Tensor, score_norm: torch.Tensor,
              hyp_tokens: torch.Tensor, hyp_len, bg: int) -> tuple:
    """HF's BeamHypotheses.add on every (image, group) at once: insert where
    the pool has room or the candidate beats the worst entry, evicting it.
    -inf marks an empty slot, so argmin finds empties first; ties go to the
    first index."""
    pool_s, pool_t, pool_l, pool_n = pool
    ok = add_mask & ((pool_n < bg) | (score_norm > pool_s.min(-1).values))
    slot = (torch.arange(bg, device=ok.device)
            == pool_s.argmin(-1, keepdim=True)) & ok[..., None]
    pool_s = torch.where(slot, score_norm[..., None], pool_s)
    pool_t = torch.where(slot[..., None], hyp_tokens[:, :, None, :], pool_t)
    pool_l = torch.where(slot, hyp_len, pool_l)
    pool_n = torch.where(ok, torch.clamp(pool_n + 1, max=bg), pool_n)
    return pool_s, pool_t, pool_l, pool_n


@torch.no_grad()
def generate_beamsearch(model: CoCa, images: torch.Tensor,
                        num_beams: int = 6, num_beam_groups: int = 3,
                        min_seq_len: int = 5, seq_len: int = 30,
                        length_penalty: float = 1.0,
                        repetition_penalty: float = 1.0,
                        sot_token_id: Optional[int] = None,
                        eos_token_id: Optional[int] = None,
                        pad_id: Optional[int] = None) -> torch.Tensor:
    """Group beam search, decision for decision the JAX package's
    `generate_beamsearch` (OpenCLIP's `_generate_beamsearch` on HF's
    BeamSearchScorer):

    - beam scores are sums of raw logits (never log-softmaxed), starting at
      -1e9 except each group's first beam at 0;
    - per group and step the sorted top `2 bg` of the `bg V` candidates are
      walked: EOS candidates of rank < bg go to the group's pool of bg
      hypotheses (the worst evicted, ties at the first index), scored
      over `cur_len ** length_penalty` with cur_len counting SOT and EOS;
      the other candidates fill the next bg live beams;
    - a group retires when its pool is full and the pool's worst score is
      >= the best candidate's over cur_len ** lp; retired groups emit pad
      at score 0;
    - EOS is blocked while the prefix (SOT included) is shorter than
      `min_seq_len`; the repetition penalty discounts every token in a
      beam's prefix;
    - finalize adds the live beams of the groups still running, then takes
      the best pooled hypothesis per image, ties across groups to the
      later group, with EOS appended where it fits.

    -> token ids [B, context_length], pad after the hypothesis."""
    cfg = model.cfg
    sot, eos, pad = _special_ids(cfg, sot_token_id, eos_token_id, pad_id)
    B, device = images.shape[0], images.device
    K, G = num_beams, num_beam_groups
    if K % G:
        raise ValueError("num_beams must divide into num_beam_groups")
    bg = K // G
    S, V = cfg.multimodal.context_length, cfg.multimodal.vocab_size
    steps = min(seq_len, S) - 1          # the SOT slot counts
    final_len, lp = steps + 1, length_penalty
    _, image_embs = model.encode_image(images)
    image_embs = image_embs.repeat_interleave(K, dim=0)
    cache = _generation_cache(model, image_embs)

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    tokens = full((B, G, bg, S), pad, torch.long)
    tokens[..., 0] = sot
    seen = full((B, G, bg, V), False, torch.bool)
    seen[..., sot] = True
    scores = torch.where(torch.arange(bg, device=device) == 0, 0.0, -1e9) \
        .expand(B, G, bg).contiguous()
    pool = (full((B, G, bg), float("-inf"), torch.float32),
            full((B, G, bg, S), pad, torch.long),
            full((B, G, bg), 0, torch.long), full((B, G), 0, torch.long))
    done = full((B, G), False, torch.bool)
    # the first row of each group of bg beams, for the beam reorder
    base = torch.arange(B * G, device=device)[:, None] * bg
    lanes = torch.arange(bg, device=device)

    for pos in range(1, steps + 1):
        cur = _next_logits(model, tokens.reshape(B * K, S), pos, cache,
                           image_embs).float().reshape(B, G, bg, V)
        if pos < min_seq_len:
            cur[..., eos] -= float("inf")
        if repetition_penalty != 1.0:
            cur = _repetition_penalty(cur, seen, repetition_penalty)
        cand_s, cand_i = (scores[..., None] + cur).reshape(
            B, G, bg * V).topk(2 * bg, dim=-1)
        cand_src, cand_tok = cand_i // V, cand_i % V
        cur_len = float(pos + 1)             # the prefix and the new token
        nb_s = full((B, G, bg), 0.0, torch.float32)
        nb_tok = full((B, G, bg), pad, torch.long)
        nb_src = full((B, G, bg), 0, torch.long)
        fill = full((B, G), 0, torch.long)
        for r in range(2 * bg):
            s, tok, src = cand_s[..., r], cand_tok[..., r], cand_src[..., r]
            is_eos = tok == eos
            if r < bg:
                hyp = tokens.gather(2, src[:, :, None, None].expand(
                    B, G, 1, S))[:, :, 0]
                pool = _pool_add(pool, ~done & is_eos, s / cur_len ** lp,
                                 hyp, pos, bg)
            put = ~done & ~is_eos & (fill < bg)
            sel = (lanes == fill[..., None]) & put[..., None]
            nb_s = torch.where(sel, s[..., None], nb_s)
            nb_tok = torch.where(sel, tok[..., None], nb_tok)
            nb_src = torch.where(sel, src[..., None], nb_src)
            fill = fill + put
        # retired groups emit pad at score 0 from their beam 0
        nb_s = nb_s.masked_fill(done[..., None], 0.0)
        nb_tok = nb_tok.masked_fill(done[..., None], pad)
        nb_src = nb_src.masked_fill(done[..., None], 0)
        pool_s, _, _, pool_n = pool
        done = done | ((pool_n >= bg) & (pool_s.min(-1).values
                                         >= cand_s[..., 0] / cur_len ** lp))
        # each surviving beam inherits its source beam's prefix, seen set
        # and cache rows (the cross keys and values are one per image)
        rows = (base + nb_src.reshape(B * G, bg)).reshape(B * K)
        tokens = tokens.reshape(B * K, S).index_select(0, rows) \
            .reshape(B, G, bg, S)
        tokens[..., pos] = nb_tok
        seen = seen.reshape(B * K, V).index_select(0, rows) \
            .reshape(B, G, bg, V)
        seen.scatter_(-1, nb_tok[..., None], True)
        for c in (cache or ())[:4]:
            c[:, :, :, :pos + 1] = c[:, :, :, :pos + 1].index_select(1, rows)
        scores = nb_s

    for k in range(bg):
        pool = _pool_add(pool, ~done, scores[..., k] / float(final_len) ** lp,
                         tokens[:, :, k], final_len, bg)
    pool_s, pool_t, pool_l, _ = pool
    # HF's tie-break (a stable sort, then pop): the last maximum wins
    best = G * bg - 1 - pool_s.reshape(B, G * bg).flip(1).argmax(1)
    hyp = pool_t.reshape(B, G * bg, S)[torch.arange(B, device=device), best]
    hyp_len = pool_l.reshape(B, G * bg)[torch.arange(B, device=device),
                                        best][:, None]
    col = torch.arange(S, device=device)[None]
    return torch.where((col == hyp_len) & (hyp_len < final_len), eos, hyp)
