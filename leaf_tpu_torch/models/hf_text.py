"""HF text towers for CustomTextCLIP-style models (port of
`leaf_tpu/models/hf_text.py`).

An HF text encoder (`models/hf_encoders.py`: RoBERTa/XLM-R and T5/mT5, the
port's own copies of the Flax classes the JAX package takes from
`transformers`; `models/m2m100.py` for NLLB) as the CLIP text tower, with a
pooler (mean over the mask, max with -inf at pads, cls: the encoder's
pooler output where it has one, else token 0; cls_last_hidden_state:
token 0) and a bias-free head (`linear`, or `mlp`: Linear, exact GELU,
Linear).

Configs are plain dicts: `_offline_hf_config` has the published
`config.json` of each checkpoint the registry names, and a local
directory's `config.json` takes the place of `AutoConfig`.  Pretrained
weights load only from a local HF checkpoint directory; no step fetches.

Precision: the tower runs in fp32 whatever `--precision` says, as the JAX
package's `create_model` builds its HF tower without a dtype
(`leaf_tpu/models/factory.py:243-246`): the factory leaves its weights
fp32 and its features are fp32.  Its parameters are `hf.<HF key>` (the
encoder) and `proj.w` or `proj.w1`/`proj.w2` [in, out], the JAX package's
`{"hf": ..., "proj": ...}` tree.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import torch
from torch import nn

from leaf_tpu_torch.models import hf_encoders, layers
from leaf_tpu_torch.models.hf_encoders import hf_config, hidden_size

POOLERS = ("mean_pooler", "max_pooler", "cls_pooler",
           "cls_last_hidden_state_pooler")


def _offline_hf_config(name: str) -> Optional[dict]:
    """The published `config.json` of each checkpoint the registry names,
    as a dict (neither machine has a hub cache); None for other names."""
    if name == "roberta-base":
        return dict(model_type="roberta", vocab_size=50265, hidden_size=768,
                    num_hidden_layers=12, num_attention_heads=12,
                    intermediate_size=3072, max_position_embeddings=514,
                    type_vocab_size=1, layer_norm_eps=1e-5, pad_token_id=1,
                    bos_token_id=0, eos_token_id=2)
    if name == "_tiny_roberta_test":
        # the test-size stand-in coca-roberta-tiny-test names
        return dict(model_type="roberta", vocab_size=100, hidden_size=64,
                    num_hidden_layers=2, num_attention_heads=2,
                    intermediate_size=128, max_position_embeddings=40,
                    type_vocab_size=1, pad_token_id=1)
    if name in ("xlm-roberta-base", "xlm-roberta-large"):
        large = name.endswith("large")
        return dict(model_type="xlm-roberta", vocab_size=250002,
                    hidden_size=1024 if large else 768,
                    num_hidden_layers=24 if large else 12,
                    num_attention_heads=16 if large else 12,
                    intermediate_size=4096 if large else 3072,
                    max_position_embeddings=514, type_vocab_size=1,
                    layer_norm_eps=1e-5, pad_token_id=1, bos_token_id=0,
                    eos_token_id=2)
    if name in ("google/mt5-base", "google/mt5-xl"):
        xl = name.endswith("xl")
        return dict(model_type="mt5", vocab_size=250112,
                    d_model=2048 if xl else 768, d_kv=64,
                    d_ff=5120 if xl else 2048, num_layers=24 if xl else 12,
                    num_heads=32 if xl else 12,
                    relative_attention_num_buckets=32, dropout_rate=0.1,
                    layer_norm_epsilon=1e-6, feed_forward_proj="gated-gelu",
                    tie_word_embeddings=False, pad_token_id=0,
                    eos_token_id=1, decoder_start_token_id=0)
    if name in ("facebook/nllb-200-distilled-600M",
                "facebook/nllb-200-distilled-1.3B"):
        big = name.endswith("1.3B")
        return dict(model_type="m2m_100", vocab_size=256206, d_model=1024,
                    encoder_layers=24 if big else 12,
                    decoder_layers=24 if big else 12,
                    encoder_attention_heads=16, decoder_attention_heads=16,
                    encoder_ffn_dim=8192 if big else 4096,
                    decoder_ffn_dim=8192 if big else 4096,
                    max_position_embeddings=1024, activation_function="relu",
                    scale_embedding=True, pad_token_id=1, bos_token_id=0,
                    eos_token_id=2, decoder_start_token_id=2)
    return None


def resolve_hf_config(name: str):
    """The config of `name`: a local directory's `config.json`, else the
    published config of a checkpoint the registry names."""
    path = os.path.join(name, "config.json")
    if os.path.isfile(path):
        with open(path) as f:
            return hf_config(json.load(f))
    d = _offline_hf_config(name)
    if d is None:
        raise FileNotFoundError(
            f"HF text tower {name!r}: no local directory with a config.json "
            "and no published config in the port's table (no hub access)")
    return hf_config(d)


def _pool(last_hidden: torch.Tensor, pooler_output: Optional[torch.Tensor],
          attention_mask: torch.Tensor, pooler_type: str) -> torch.Tensor:
    mask = attention_mask.to(last_hidden.dtype)[..., None]
    if pooler_type == "mean_pooler":
        return (last_hidden * mask).sum(1) / mask.sum(1).clamp_min(1e-9)
    if pooler_type == "max_pooler":
        return torch.where(mask > 0, last_hidden,
                           torch.full_like(last_hidden, float("-inf"))
                           ).amax(dim=1)
    if pooler_type == "cls_pooler":
        return pooler_output if pooler_output is not None \
            else last_hidden[:, 0]
    if pooler_type == "cls_last_hidden_state_pooler":
        return last_hidden[:, 0]
    raise ValueError(f"unknown pooler {pooler_type!r}")


class HFTextTower(nn.Module):
    """An HF encoder + pooler + head (the JAX package's `HFTextTower`).

    `config_or_name`: a registry name (`roberta-base`, ...), a local HF
    checkpoint directory, a config dict or a `transformers` config.  The
    encoder is zero-initialised unless `pretrained` (its weights then load
    from the local directory `config_or_name`); `seed` draws every weight
    not loaded, as `init_weights` does."""

    def __init__(self, config_or_name, output_dim: int,
                 pooler_type: str = "mean_pooler",
                 proj_type: Optional[str] = "linear",
                 pretrained: bool = False, seed: Optional[int] = None):
        super().__init__()
        if pooler_type not in POOLERS:
            raise ValueError(f"unknown pooler {pooler_type!r}")
        self.config = (resolve_hf_config(config_or_name)
                       if isinstance(config_or_name, str)
                       else hf_config(config_or_name))
        self.pooler_type, self.proj_type = pooler_type, proj_type
        self.output_dim = output_dim
        self.vocab_size = getattr(self.config, "vocab_size", 0)
        self.context_length = getattr(self.config,
                                      "max_position_embeddings", 0)
        self.hf = hf_encoders.build_encoder(
            self.config, add_pooling_layer=(pooler_type == "cls_pooler"))
        d = hidden_size(self.config)
        # as the JAX package: 'linear' always has its (bias-free) Linear,
        # 'mlp' is bias-free Linear, exact GELU, Linear; None: identity
        if proj_type == "linear":
            shapes = {"w": (d, output_dim)}
        elif proj_type == "mlp":
            hidden = (d + output_dim) // 2
            shapes = {"w1": (d, hidden), "w2": (hidden, output_dim)}
        else:
            shapes = {}
        self.proj = nn.ParameterDict({k: nn.Parameter(torch.zeros(*s))
                                      for k, s in shapes.items()})
        self.pretrained = pretrained
        if seed is not None:
            self.init_weights(torch.Generator().manual_seed(seed))
        if pretrained:
            self.load_pretrained(config_or_name)
        # the dtype a CoCa casts the outputs to (None: fp32)
        self.compute_dtype: Optional[torch.dtype] = None

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or torch.float32

    def init_weights(self, generator: torch.Generator) -> None:
        """The encoder's HF init (unless its weights were loaded), then the
        head: normal with std fan_in^-0.5, as the JAX package's."""
        if not self.pretrained:
            self.hf.init_weights(generator)
        for w in self.proj.values():
            layers.normal_(w, w.shape[0] ** -0.5, generator)

    def load_pretrained(self, path: str) -> None:
        """The encoder's weights from a local HF checkpoint directory."""
        if not os.path.isdir(path):
            raise FileNotFoundError(
                f"HF text tower {path!r}: pretrained weights load from a "
                "local HF checkpoint directory only (no hub access)")
        if self.config.model_type == "m2m_100":
            from leaf_tpu_torch.models.m2m100 import load_m2m100
            self.hf.load_state_dict(load_m2m100(path, self.hf.spec))
        else:
            from leaf_tpu_torch.models.interop import (load_state_dict_file,
                                                       resolve_checkpoint_file)
            hf_encoders.load_hf_weights(
                self.hf, load_state_dict_file(resolve_checkpoint_file(path)))
        self.pretrained = True

    def _mask(self, input_ids: torch.Tensor,
              attention_mask: Optional[torch.Tensor]) -> torch.Tensor:
        if attention_mask is None:
            # as the JAX package: the mask from the tower's own pad id
            pad = getattr(self.config, "pad_token_id", 0) or 0
            return (input_ids != pad).long()
        return torch.as_tensor(attention_mask, device=input_ids.device)

    def _head(self, pooled: torch.Tensor) -> torch.Tensor:
        if "w" in self.proj:
            return pooled @ self.proj["w"]
        if "w1" in self.proj:
            return layers.gelu(pooled @ self.proj["w1"]) @ self.proj["w2"]
        return pooled

    def call_with_tokens(self, input_ids: torch.Tensor,
                         attention_mask: Optional[torch.Tensor] = None,
                         normalize: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(projected pooled [B, out], token states [B, S(-1), width]): the
        token states are not projected, and lose the cls position for the
        cls pooler alone (cls_last_hidden_state keeps every position)."""
        from leaf_tpu_torch.models.clip import l2_normalize
        mask = self._mask(input_ids, attention_mask)
        hidden, pooler_output = self.hf(input_ids, mask)
        pooled = self._head(_pool(hidden, pooler_output, mask,
                                  self.pooler_type))
        if normalize:
            pooled = l2_normalize(pooled)
        tokens = hidden[:, 1:] if self.pooler_type == "cls_pooler" else hidden
        return pooled, tokens

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                normalize: bool = False) -> torch.Tensor:
        """[B, S] ids (and an optional [B, S] mask) -> [B, output_dim] fp32
        features (the JAX package's `__call__`)."""
        return self.call_with_tokens(input_ids, attention_mask, normalize)[0]

    def encode_text(self, tokens: torch.Tensor, normalize: bool = False,
                    pack: bool = True, remat: bool = False) -> torch.Tensor:
        """The CLIP text tower's entry point; `pack` does not apply."""
        layers.refuse_training("HF text", remat, None)
        return self(tokens, None, normalize)


def create_custom_text_clip(vision_cfg, hf_text: HFTextTower, embed_dim: int,
                            seed: int = 0):
    """CustomTextCLIP-style bundle: the port's ViT vision tower beside an HF
    text tower -> (module, encode_image_fn, encode_text_fn), the module's
    state_dict the JAX package's `{"visual", "text", "logit_scale"}`."""
    from leaf_tpu_torch.models.clip import VisionTower

    module = nn.Module()
    module.visual = VisionTower(vision_cfg)
    module.text = hf_text
    module.logit_scale = nn.Parameter(torch.tensor(2.6592))
    module.visual.init_weights(torch.Generator().manual_seed(seed + 1))

    def encode_image(images, normalize=False):
        return module.visual.encode_image(images, normalize)

    def encode_text(input_ids, attention_mask=None, normalize=False):
        return module.text(input_ids, attention_mask, normalize)

    return module.eval(), encode_image, encode_text
