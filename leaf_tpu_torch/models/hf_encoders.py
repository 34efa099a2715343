"""The HF text encoders that the JAX package takes from Flax `transformers`,
in PyTorch: RoBERTa/XLM-R (`model_type` `roberta`, `xlm-roberta`) and the
T5/mT5 encoder (`t5`, `mt5`).

The port does not import `transformers`: it keeps its own copy of the two
encoders, with HF's torch state-dict key names (`embeddings.word_embeddings.
weight`, `encoder.layer.0.attention.self.query.weight`, `shared.weight`,
`encoder.block.0.layer.0.SelfAttention.q.weight`, ...), so that a local HF
checkpoint directory (`config.json` with `pytorch_model.bin` or
`model.safetensors`, read by the port's own reader) loads by key
(`load_hf_weights`), and a config that is a plain dict (`hf_config`: HF's
defaults for the keys the file leaves out).

RoBERTa/XLM-R (HF `RobertaModel`): word + token-type row 0 + position
embeddings, position ids `cumsum(mask) * mask + padding_idx`, the embedding
LayerNorm; post-LN layers (attention with 1/sqrt(d) logits and the fp32
minimum on pad keys, residual, LayerNorm; exact GELU FFN, residual,
LayerNorm); the pooler (dense + tanh on token 0) only where it was asked
for (`add_pooling_layer`, the cls pooler).  Every LayerNorm is the port's
LayerNorm op (D 768 or 1024 at the registry's XLM-R towers).

T5/mT5 (HF `T5EncoderModel`): the token embedding with no scale; pre-norm
layers with an RMS norm (no mean, no bias, the variance in fp32); one
relative-position bias table, in layer 0, shared by every layer
(bidirectional buckets: 32 buckets, max distance 128); no 1/sqrt(d) on
the logits; a gated `gelu_new` (tanh) FFN for mT5's `gated-gelu`, ReLU for
T5's `relu`; untied embeddings and a final RMS norm.

Both run in fp32, plain PyTorch besides the LayerNorm op, as the JAX
package's Flax towers run outside any Pallas kernel; the weights are
drawn as HF's `_init_weights` draws them, from a `torch.Generator`.
"""
from __future__ import annotations

import logging
import math
from types import SimpleNamespace
from typing import Any, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from leaf_tpu_torch.models import layers
from leaf_tpu_torch.ops.packed_attention import layer_norm

LOG = logging.getLogger(__name__)

ROBERTA_TYPES = ("roberta", "xlm-roberta")
T5_TYPES = ("t5", "mt5")

# HF's defaults for the keys a config.json may leave out
_DEFAULTS = {
    "roberta": dict(vocab_size=50265, hidden_size=768, num_hidden_layers=12,
                    num_attention_heads=12, intermediate_size=3072,
                    hidden_act="gelu", max_position_embeddings=512,
                    type_vocab_size=2, initializer_range=0.02,
                    layer_norm_eps=1e-12, pad_token_id=1),
    "xlm-roberta": dict(vocab_size=30522, hidden_size=768,
                        num_hidden_layers=12, num_attention_heads=12,
                        intermediate_size=3072, hidden_act="gelu",
                        max_position_embeddings=512, type_vocab_size=2,
                        initializer_range=0.02, layer_norm_eps=1e-12,
                        pad_token_id=1),
    "t5": dict(vocab_size=32128, d_model=512, d_kv=64, d_ff=2048,
               num_layers=6, num_heads=8, relative_attention_num_buckets=32,
               relative_attention_max_distance=128, layer_norm_epsilon=1e-6,
               initializer_factor=1.0, feed_forward_proj="relu",
               pad_token_id=0),
    "mt5": dict(vocab_size=250112, d_model=512, d_kv=64, d_ff=1024,
                num_layers=8, num_heads=6, relative_attention_num_buckets=32,
                relative_attention_max_distance=128, layer_norm_epsilon=1e-6,
                initializer_factor=1.0, feed_forward_proj="gated-gelu",
                pad_token_id=0),
    "m2m_100": dict(vocab_size=128112, d_model=1024, encoder_layers=12,
                    encoder_ffn_dim=4096, encoder_attention_heads=16,
                    max_position_embeddings=1024, scale_embedding=True,
                    pad_token_id=1),
}


def hf_config(d: Any) -> SimpleNamespace:
    """An HF config as attributes: a dict (a `config.json`'s contents) or
    an object with `to_dict()` (a `transformers` config), its missing keys
    filled with HF's defaults for its `model_type`."""
    if hasattr(d, "to_dict"):
        d = d.to_dict()
    d = dict(d)
    mt = d.get("model_type")
    if mt not in _DEFAULTS:
        raise ValueError(f"HF text tower of model_type {mt!r}: the port has "
                         f"{sorted(_DEFAULTS)}")
    return SimpleNamespace(**{**_DEFAULTS[mt], **d})


def hidden_size(config) -> int:
    return getattr(config, "hidden_size", None) or config.d_model


_ACTS = {"gelu": F.gelu, "relu": F.relu, "silu": F.silu, "swish": F.silu,
         "gelu_new": lambda x: F.gelu(x, approximate="tanh")}


def _act(name: str):
    if name not in _ACTS:
        raise ValueError(f"activation {name!r}: the port has {sorted(_ACTS)}")
    return _ACTS[name]


def _key_bias(attention_mask: torch.Tensor) -> torch.Tensor:
    """[B, S] mask -> [B, 1, 1, S] additive fp32 key bias (0 or the fp32
    minimum, as HF's extended attention mask)."""
    return torch.where(attention_mask[:, None, None, :] > 0, 0.0,
                       torch.finfo(torch.float32).min)


class HFLayerNorm(nn.Module):
    """A LayerNorm with HF's parameter names, run by the LayerNorm op."""

    def __init__(self, width: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class Linear(nn.Module):
    """`nn.Linear`'s parameters and function, zero-initialised (the towers
    draw their own init)."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    """`nn.Embedding`'s parameter and lookup, zero-initialised."""

    def __init__(self, n: int, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(n, d))

    @property
    def num_embeddings(self) -> int:
        return self.weight.shape[0]

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.weight[ids]


# ---------------------------------------------------------------------------
# RoBERTa / XLM-R
# ---------------------------------------------------------------------------

class _RobertaEmbeddings(nn.Module):
    def __init__(self, c):
        super().__init__()
        D = c.hidden_size
        self.word_embeddings = Embedding(c.vocab_size, D)
        self.position_embeddings = Embedding(c.max_position_embeddings, D)
        self.token_type_embeddings = Embedding(c.type_vocab_size, D)
        self.LayerNorm = HFLayerNorm(D, c.layer_norm_eps)


class _RobertaSelfAttention(nn.Module):
    def __init__(self, c):
        super().__init__()
        D = c.hidden_size
        self.heads = c.num_attention_heads
        self.query = Linear(D, D)
        self.key = Linear(D, D)
        self.value = Linear(D, D)

    def forward(self, h: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        B, S, D = h.shape
        H = self.heads
        hd = D // H

        def heads(t):
            return t.reshape(B, S, H, hd).transpose(1, 2)

        q, k, v = heads(self.query(h)), heads(self.key(h)), heads(self.value(h))
        logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
            / math.sqrt(hd)
        probs = torch.softmax(logits + bias, dim=-1).to(h.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
        return out.transpose(1, 2).reshape(B, S, D)


class _DenseLN(nn.Module):
    """HF's `*Output`: dense, then LayerNorm(residual + dense)."""

    def __init__(self, d_in: int, d_out: int, eps: float):
        super().__init__()
        self.dense = Linear(d_in, d_out)
        self.LayerNorm = HFLayerNorm(d_out, eps)

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(self.dense(x) + residual)


class _RobertaLayer(nn.Module):
    def __init__(self, c):
        super().__init__()
        D, M = c.hidden_size, c.intermediate_size
        self.attention = nn.Module()
        self.attention.self = _RobertaSelfAttention(c)
        self.attention.output = _DenseLN(D, D, c.layer_norm_eps)
        self.intermediate = nn.Module()
        self.intermediate.dense = Linear(D, M)
        self.output = _DenseLN(M, D, c.layer_norm_eps)
        self.act = _act(c.hidden_act)

    def forward(self, h: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        a = self.attention.output(self.attention.self(h, bias), h)
        return self.output(self.act(self.intermediate.dense(a)), a)


class RobertaEncoder(nn.Module):
    """HF `RobertaModel` (and `XLMRobertaModel`): [B, S] ids ->
    (last hidden state [B, S, D], pooler output [B, D] or None)."""

    base_model_prefix = "roberta"

    def __init__(self, config, add_pooling_layer: bool = False):
        super().__init__()
        self.config = c = config
        self.embeddings = _RobertaEmbeddings(c)
        self.encoder = nn.Module()
        self.encoder.layer = nn.ModuleList(
            _RobertaLayer(c) for _ in range(c.num_hidden_layers))
        self.pooler = None
        if add_pooling_layer:
            self.pooler = nn.Module()
            self.pooler.dense = Linear(c.hidden_size, c.hidden_size)

    def init_weights(self, generator: torch.Generator) -> None:
        """HF's `_init_weights`: normal(initializer_range) Linear and
        Embedding weights, the embeddings' padding rows zeroed, zero
        biases, unit LayerNorms."""
        std, pad = self.config.initializer_range, self.config.pad_token_id
        for m in self.modules():
            if isinstance(m, (Linear, Embedding)):
                layers.normal_(m.weight, std, generator)
        e = self.embeddings
        with torch.no_grad():
            for emb in (e.word_embeddings, e.position_embeddings):
                if pad is not None and pad < emb.num_embeddings:
                    emb.weight[pad] = 0.0

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        from leaf_tpu_torch.models.m2m100 import position_ids_from_tokens
        ids = input_ids.long()
        e = self.embeddings
        pos = position_ids_from_tokens(ids, self.config.pad_token_id)
        h = (e.word_embeddings(ids) + e.token_type_embeddings.weight[0]
             + e.position_embeddings(pos))
        h = e.LayerNorm(h)
        bias = _key_bias(attention_mask)
        for layer in self.encoder.layer:
            h = layer(h, bias)
        pooled = (torch.tanh(self.pooler.dense(h[:, 0]))
                  if self.pooler is not None else None)
        return h, pooled


# ---------------------------------------------------------------------------
# T5 / mT5
# ---------------------------------------------------------------------------

class T5RMSNorm(nn.Module):
    """T5's LayerNorm: scale only, no mean and no bias, the variance in
    fp32."""

    def __init__(self, width: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(width))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.float().pow(2).mean(-1, keepdim=True)
        return self.weight * (x * torch.rsqrt(var + self.eps))


def relative_position_bucket(relative_position: torch.Tensor,
                             num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """T5's bidirectional bucket of each relative position (key minus
    query): half the buckets for each sign, exact below num_buckets / 4,
    logarithmic up to `max_distance`."""
    num_buckets //= 2
    buckets = (relative_position > 0).long() * num_buckets
    n = relative_position.abs()
    max_exact = num_buckets // 2
    large = max_exact + (
        torch.log(n.float() / max_exact) / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)).long()
    large = torch.minimum(large, torch.full_like(large, num_buckets - 1))
    return buckets + torch.where(n < max_exact, n, large)


class _T5SelfAttention(nn.Module):
    def __init__(self, c, has_bias: bool):
        super().__init__()
        inner = c.num_heads * c.d_kv
        self.heads, self.d_kv = c.num_heads, c.d_kv
        self.q = Linear(c.d_model, inner, bias=False)
        self.k = Linear(c.d_model, inner, bias=False)
        self.v = Linear(c.d_model, inner, bias=False)
        self.o = Linear(inner, c.d_model, bias=False)
        self.relative_attention_bias = (
            Embedding(c.relative_attention_num_buckets, c.num_heads)
            if has_bias else None)
        self.num_buckets = c.relative_attention_num_buckets
        self.max_distance = c.relative_attention_max_distance

    def position_bias(self, S: int, device) -> torch.Tensor:
        """[1, heads, S, S] fp32 bias from the layer's table."""
        pos = torch.arange(S, device=device)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None],
                                           self.num_buckets, self.max_distance)
        return self.relative_attention_bias(buckets).float() \
            .permute(2, 0, 1)[None]

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        B, S, _ = x.shape
        H, hd = self.heads, self.d_kv

        def heads(t):
            return t.reshape(B, S, H, hd).transpose(1, 2)

        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
        probs = torch.softmax(logits + bias, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
        return self.o(out.transpose(1, 2).reshape(B, S, H * hd))


class _T5FF(nn.Module):
    def __init__(self, c):
        super().__init__()
        proj = c.feed_forward_proj
        parts = proj.split("-")
        self.gated = parts[0] == "gated"
        self.act = _act("gelu_new" if proj == "gated-gelu" else parts[-1])
        if self.gated:
            self.wi_0 = Linear(c.d_model, c.d_ff, bias=False)
            self.wi_1 = Linear(c.d_model, c.d_ff, bias=False)
        else:
            self.wi = Linear(c.d_model, c.d_ff, bias=False)
        self.wo = Linear(c.d_ff, c.d_model, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.gated:
            return self.wo(self.act(self.wi_0(x)) * self.wi_1(x))
        return self.wo(self.act(self.wi(x)))


class _T5Block(nn.Module):
    def __init__(self, c, has_bias: bool):
        super().__init__()
        attn = nn.Module()
        attn.SelfAttention = _T5SelfAttention(c, has_bias)
        attn.layer_norm = T5RMSNorm(c.d_model, c.layer_norm_epsilon)
        ff = nn.Module()
        ff.DenseReluDense = _T5FF(c)
        ff.layer_norm = T5RMSNorm(c.d_model, c.layer_norm_epsilon)
        self.layer = nn.ModuleList([attn, ff])

    def forward(self, h: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        attn, ff = self.layer
        h = h + attn.SelfAttention(attn.layer_norm(h), bias)
        return h + ff.DenseReluDense(ff.layer_norm(h))


class T5Encoder(nn.Module):
    """HF `T5EncoderModel` / `MT5EncoderModel`: [B, S] ids -> (last hidden
    state [B, S, D], None)."""

    base_model_prefix = "transformer"

    def __init__(self, config):
        super().__init__()
        self.config = c = config
        self.shared = Embedding(c.vocab_size, c.d_model)
        self.encoder = nn.Module()
        self.encoder.block = nn.ModuleList(
            _T5Block(c, i == 0) for i in range(c.num_layers))
        self.encoder.final_layer_norm = T5RMSNorm(c.d_model,
                                                  c.layer_norm_epsilon)

    def init_weights(self, generator: torch.Generator) -> None:
        """HF's T5 `_init_weights`: each weight normal with its fan-in
        scale times `initializer_factor`, unit norms."""
        c, f = self.config, self.config.initializer_factor
        layers.normal_(self.shared.weight, f * 1.0, generator)
        for block in self.encoder.block:
            a = block.layer[0].SelfAttention
            layers.normal_(a.q.weight, f * (c.d_model * c.d_kv) ** -0.5,
                           generator)
            layers.normal_(a.k.weight, f * c.d_model ** -0.5, generator)
            layers.normal_(a.v.weight, f * c.d_model ** -0.5, generator)
            layers.normal_(a.o.weight, f * (c.num_heads * c.d_kv) ** -0.5,
                           generator)
            if a.relative_attention_bias is not None:
                layers.normal_(a.relative_attention_bias.weight,
                               f * c.d_model ** -0.5, generator)
            ff = block.layer[1].DenseReluDense
            for wi in ((ff.wi_0, ff.wi_1) if ff.gated else (ff.wi,)):
                layers.normal_(wi.weight, f * c.d_model ** -0.5, generator)
            layers.normal_(ff.wo.weight, f * c.d_ff ** -0.5, generator)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor
                ) -> Tuple[torch.Tensor, None]:
        h = self.shared(input_ids.long())
        blocks = self.encoder.block
        bias = blocks[0].layer[0].SelfAttention.position_bias(
            h.shape[1], h.device) + _key_bias(attention_mask)
        for block in blocks:
            h = block(h, bias)
        return self.encoder.final_layer_norm(h), None


# ---------------------------------------------------------------------------
# HF checkpoints
# ---------------------------------------------------------------------------

def load_hf_weights(module: nn.Module, sd: Mapping[str, torch.Tensor]
                    ) -> None:
    """Load an HF torch state dict into `module` by key: a task head's
    wrapper prefix (`roberta.`, `transformer.`) is dropped, keys the
    encoder has no use for (a decoder, an LM head, `position_ids`) are
    left out, T5's `encoder.embed_tokens.weight` stands in for a missing
    `shared.weight`, and a missing RoBERTa pooler keeps its init with a
    warning (as `from_pretrained` does).  Any other missing key raises."""
    prefix = module.base_model_prefix + "."
    if any(k.startswith(prefix) for k in sd):
        sd = {k[len(prefix):]: v for k, v in sd.items()
              if k.startswith(prefix)}
    sd = dict(sd)
    if "shared.weight" not in sd and "encoder.embed_tokens.weight" in sd:
        sd["shared.weight"] = sd["encoder.embed_tokens.weight"]
    own = module.state_dict()
    missing = [k for k in own if k not in sd]
    pooler = [k for k in missing if k.startswith("pooler.")]
    if pooler:
        LOG.warning("the checkpoint has no pooler: %s keep their init",
                    ", ".join(pooler))
    missing = [k for k in missing if k not in pooler]
    if missing:
        raise KeyError(f"HF checkpoint lacks {missing[:5]} "
                       f"({len(missing)} keys)")
    module.load_state_dict({k: sd[k] for k in own if k in sd}, strict=False)


def build_encoder(config, add_pooling_layer: bool = False) -> nn.Module:
    """The encoder module of `config`'s `model_type`, zero-initialised."""
    mt = config.model_type
    if mt in ROBERTA_TYPES:
        return RobertaEncoder(config, add_pooling_layer)
    if mt in T5_TYPES:
        return T5Encoder(config)
    if mt == "m2m_100":
        from leaf_tpu_torch.models.m2m100 import M2M100Encoder, M2M100Spec
        return M2M100Encoder(M2M100Spec.from_hf_config(config))
    raise ValueError(f"HF text tower of model_type {mt!r}: the port has "
                     f"{ROBERTA_TYPES + T5_TYPES + ('m2m_100',)}")
