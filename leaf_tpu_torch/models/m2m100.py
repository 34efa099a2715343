"""The M2M100 text encoder, the NLLB-CLIP text tower (port of
`leaf_tpu/models/m2m100.py`).

The nllb-clip registry entries wrap `facebook/nllb-200-distilled-{600M,
1.3B}`, whose encoder is HF's `M2M100Encoder`:

  * the token embedding scaled by sqrt(d_model) (`scale_embedding`);
  * sinusoidal positions ([sin | cos], the padding row zeroed, a table of
    `max_positions + 2` rows) indexed by pad-aware position ids: pads keep
    `padding_idx`, tokens count up from `padding_idx + 1`;
  * pre-norm layers: LN -> attention (q scaled by hd^-0.5 before QK, the
    logits formed in the model dtype and only then cast to fp32, keys
    masked with the fp32 minimum) -> residual; LN -> ReLU FFN -> residual;
  * a final LayerNorm after the stack.

The JAX package scans the layers; here each is a module.  Parameter names
follow the JAX pytree (`embed_tokens`, `layers.<i>.ln_attn.scale`,
`layers.<i>.attn.q_w` as [D, D] for y = x @ w, `layers.<i>.fc1_w`,
`ln_final`), so `m2m100_state_dict` carries that package's tree (and
`m2m100_from_torch`'s) by un-stacking the layer axis.  Every LayerNorm is
the LayerNorm op (fp32 statistics: the JAX package's `_ln`), at D 1024 for
both NLLB encoders; the attention and the FFN are plain PyTorch, as the
JAX package runs them outside any Pallas kernel.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from leaf_tpu_torch.models import layers

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class M2M100Spec:
    vocab_size: int
    d_model: int
    layers: int
    heads: int
    ffn_dim: int
    max_positions: int = 1024
    pad_token_id: int = 1
    scale_embedding: bool = True
    ln_eps: float = 1e-5

    @classmethod
    def from_hf_config(cls, config) -> "M2M100Spec":
        return cls(vocab_size=config.vocab_size, d_model=config.d_model,
                   layers=config.encoder_layers,
                   heads=config.encoder_attention_heads,
                   ffn_dim=config.encoder_ffn_dim,
                   max_positions=config.max_position_embeddings,
                   pad_token_id=config.pad_token_id,
                   scale_embedding=config.scale_embedding)


def sinusoid_table(n_pos: int, dim: int, padding_idx: int) -> np.ndarray:
    """HF `M2M100SinusoidalPositionalEmbedding.get_embedding`: [sin | cos]
    concatenated (not interleaved), the padding_idx row zeroed."""
    half = dim // 2
    freq = np.exp(np.arange(half, dtype=np.float64)
                  * -(math.log(10000.0) / (half - 1)))
    ang = np.arange(n_pos, dtype=np.float64)[:, None] * freq[None, :]
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=1)
    if dim % 2 == 1:
        emb = np.concatenate([emb, np.zeros((n_pos, 1))], axis=1)
    emb[padding_idx] = 0.0
    return emb.astype(np.float32)


def position_ids_from_tokens(input_ids: torch.Tensor,
                             pad: int) -> torch.Tensor:
    """HF `create_position_ids_from_input_ids`: pads -> pad, tokens ->
    pad + 1, pad + 2, ... (the same rule RoBERTa uses)."""
    mask = (input_ids != pad).long()
    return torch.cumsum(mask, dim=1) * mask + pad


class _Attention(nn.Module):
    def __init__(self, D: int):
        super().__init__()
        for n in "qkv":
            setattr(self, f"{n}_w", nn.Parameter(torch.zeros(D, D)))
            setattr(self, f"{n}_b", nn.Parameter(torch.zeros(D)))
        self.out_w = nn.Parameter(torch.zeros(D, D))
        self.out_b = nn.Parameter(torch.zeros(D))


class _Layer(nn.Module):
    def __init__(self, spec: M2M100Spec):
        super().__init__()
        D, H = spec.d_model, spec.ffn_dim
        self.heads = spec.heads
        self.ln_attn = layers.LayerNorm(D, spec.ln_eps)
        self.attn = _Attention(D)
        self.ln_mlp = layers.LayerNorm(D, spec.ln_eps)
        self.fc1_w = nn.Parameter(torch.zeros(D, H))
        self.fc1_b = nn.Parameter(torch.zeros(H))
        self.fc2_w = nn.Parameter(torch.zeros(H, D))
        self.fc2_b = nn.Parameter(torch.zeros(D))

    def forward(self, h: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        dt = h.dtype
        a = self.attn
        x = self.ln_attn(h)
        B, S, D = x.shape
        nh = self.heads
        hd = D // nh

        def heads(t):
            return t.reshape(B, S, nh, hd).transpose(1, 2)

        q = heads((x @ a.q_w.to(dt) + a.q_b.to(dt)) * (hd ** -0.5))
        k = heads(x @ a.k_w.to(dt) + a.k_b.to(dt))
        v = heads(x @ a.v_w.to(dt) + a.v_b.to(dt))
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float()
        w = torch.softmax(logits + bias, dim=-1).to(dt)
        o = torch.einsum("bhqk,bhkd->bhqd", w, v).transpose(1, 2)
        h = h + (o.reshape(B, S, D) @ a.out_w.to(dt) + a.out_b.to(dt))
        x = F.relu(self.ln_mlp(h) @ self.fc1_w.to(dt) + self.fc1_b.to(dt))
        return h + (x @ self.fc2_w.to(dt) + self.fc2_b.to(dt))


class M2M100Encoder(nn.Module):
    """`m2m100_encode` as a module: [B, S] ids -> [B, S, D] final hidden
    states, with no pooler output (the cls pooler then takes token 0)."""

    def __init__(self, spec: M2M100Spec):
        super().__init__()
        self.spec = spec
        D = spec.d_model
        self.embed_tokens = nn.Parameter(torch.zeros(spec.vocab_size, D))
        self.layers = nn.ModuleList(_Layer(spec) for _ in range(spec.layers))
        self.ln_final = layers.LayerNorm(D, spec.ln_eps)
        self.register_buffer("positions", torch.from_numpy(sinusoid_table(
            spec.max_positions + 2, D, spec.pad_token_id)), persistent=False)

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's `init_m2m100_encoder`: normal(0.02) weights,
        the padding row of the embedding zeroed, zero biases, unit
        LayerNorms."""
        for name, t in self.named_parameters():
            if name.endswith("_w") or name == "embed_tokens":
                layers.normal_(t, 0.02, generator)
        with torch.no_grad():
            self.embed_tokens[self.spec.pad_token_id] = 0.0

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None):
        """-> (last hidden state [B, S, D], None)."""
        spec = self.spec
        dt = self.embed_tokens.dtype
        input_ids = input_ids.long()
        if attention_mask is None:
            attention_mask = input_ids != spec.pad_token_id
        scale = math.sqrt(spec.d_model) if spec.scale_embedding else 1.0
        h = self.embed_tokens[input_ids] * scale
        h = h + self.positions.to(dt)[
            position_ids_from_tokens(input_ids, spec.pad_token_id)]
        bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0,
                           torch.finfo(torch.float32).min)
        for layer in self.layers:
            h = layer(h, bias)
        return self.ln_final(h), None


def m2m100_from_torch(sd: Mapping[str, Any], spec: M2M100Spec,
                      prefix: str = "model.") -> Params:
    """torch M2M100Model / nllb-clip state dict (its encoder) -> the JAX
    package's pytree (layers stacked), numpy.  `prefix` is everything
    before `encoder.`: `model.` for a saved `M2M100Model`, `` for a bare
    encoder, `text.transformer.model.` in an OpenCLIP nllb-clip file."""
    def g(k):
        v = sd[prefix + k]
        return (v.detach().cpu().float().numpy() if hasattr(v, "detach")
                else np.asarray(v, np.float32))

    emb_key = ("encoder.embed_tokens.weight"
               if prefix + "encoder.embed_tokens.weight" in sd
               else "shared.weight")

    def stack(fmt, transpose=False):
        per = [g(fmt.format(i)) for i in range(spec.layers)]
        return np.stack([w.T for w in per] if transpose else per)

    lf = "encoder.layers.{}."
    return {
        "embed_tokens": g(emb_key),
        "layers": {
            "ln_attn": {
                "scale": stack(lf + "self_attn_layer_norm.weight"),
                "bias": stack(lf + "self_attn_layer_norm.bias")},
            "attn": {
                "q_w": stack(lf + "self_attn.q_proj.weight", True),
                "q_b": stack(lf + "self_attn.q_proj.bias"),
                "k_w": stack(lf + "self_attn.k_proj.weight", True),
                "k_b": stack(lf + "self_attn.k_proj.bias"),
                "v_w": stack(lf + "self_attn.v_proj.weight", True),
                "v_b": stack(lf + "self_attn.v_proj.bias"),
                "out_w": stack(lf + "self_attn.out_proj.weight", True),
                "out_b": stack(lf + "self_attn.out_proj.bias")},
            "ln_mlp": {
                "scale": stack(lf + "final_layer_norm.weight"),
                "bias": stack(lf + "final_layer_norm.bias")},
            "fc1_w": stack(lf + "fc1.weight", True),
            "fc1_b": stack(lf + "fc1.bias"),
            "fc2_w": stack(lf + "fc2.weight", True),
            "fc2_b": stack(lf + "fc2.bias"),
        },
        "ln_final": {"scale": g("encoder.layer_norm.weight"),
                     "bias": g("encoder.layer_norm.bias")},
    }


def m2m100_state_dict(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's M2M100 pytree -> `M2M100Encoder`'s state_dict:
    every leaf under `layers` carries a leading layer axis, un-stacked into
    `layers.<i>.`."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, Mapping):
                yield from walk(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", np.asarray(v, np.float32)

    for name, arr in walk(tree, ""):
        if name.startswith("layers."):
            for i in range(arr.shape[0]):
                out[f"layers.{i}.{name[len('layers.'):]}"] = \
                    torch.from_numpy(np.array(arr[i], order="C", copy=True))
        else:
            out[name] = torch.from_numpy(np.array(arr, order="C", copy=True))
    return out


def load_m2m100(path: str, spec: M2M100Spec) -> Dict[str, torch.Tensor]:
    """A local M2M100 checkpoint (a saved `M2M100Model`'s directory or
    weights file: `model.encoder.*` keys, or a bare encoder's) ->
    `M2M100Encoder`'s state_dict."""
    from leaf_tpu_torch.models.interop import (load_state_dict_file,
                                               resolve_checkpoint_file)
    sd = load_state_dict_file(resolve_checkpoint_file(path))
    prefix = ("model." if any(k.startswith("model.encoder.") for k in sd)
              else "")
    return m2m100_state_dict(m2m100_from_torch(sd, spec, prefix=prefix))
