"""CoCa checkpoint interop (port of `leaf_tpu/models/coca_interop.py`):
an OpenCLIP CoCa `state_dict` to the port's, and the JAX package's CoCa
pytree to the port's.

OpenCLIP's CoCa keys: `text.*` (the text transformer with `cls_emb`),
`visual.*` (with `attn_pool`: a torch MultiheadAttention with kdim = vdim
= the vision width, so separate q/k/v projection weights) and
`text_decoder.*` (`resblocks.<i>` self-attention blocks, `cross_attn.<i>`
blocks with `ln_1_kv`).  The mapping rules are `interop`'s: `nn.Linear`
weights transposed to `y = x @ w`, the stride-p conv to the patch matmul.
A CoCa with an HF text tower (`coca_roberta-*`) has `text.transformer.<HF
torch keys>` and the bias-free `text.proj.weight` instead of the native
text tower: the port's `HFTextTower` keeps HF's keys (`text.hf.<key>`).
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from leaf_tpu_torch.models.coca import CoCaConfig
from leaf_tpu_torch.models.interop import (StateDict, _np, _openclip_blocks,
                                           _tensor, params_from_jax)


def _ln(sd: Mapping[str, Any], src: str, dst: str, out: StateDict) -> None:
    out[f"{dst}.scale"] = _tensor(sd[f"{src}.weight"])
    out[f"{dst}.bias"] = _tensor(sd[f"{src}.bias"])


def coca_openclip_to_params(sd: Mapping[str, Any],
                            cfg: CoCaConfig) -> StateDict:
    """OpenCLIP `CoCa.state_dict()` -> the port's state_dict; a `module.`
    prefix (DDP checkpoints) is dropped."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    out: StateDict = {
        "visual.class_embedding": _tensor(sd["visual.class_embedding"]),
        "visual.positional_embedding": _tensor(
            sd["visual.positional_embedding"]),
        "visual.proj": _tensor(sd["visual.proj"]),
        "text_decoder.text_projection": _tensor(
            sd["text_decoder.text_projection"]),
        "logit_scale": _tensor(_np(sd["logit_scale"]).reshape(())),
    }
    if cfg.hf_text_name:
        tp = "text.transformer."
        out.update({"text.hf." + k[len(tp):]: _tensor(v)
                    for k, v in sd.items() if k.startswith(tp)})
        if "text.proj.weight" in sd:
            out["text.proj.w"] = _tensor(_np(sd["text.proj.weight"]).T)
    else:
        out.update({
            "text.token_embedding": _tensor(sd["text.token_embedding.weight"]),
            "text.positional_embedding": _tensor(
                sd["text.positional_embedding"]),
            "text.cls_emb": _tensor(sd["text.cls_emb"]),
            "text.text_projection": _tensor(sd["text.text_projection"])})
        _ln(sd, "text.ln_final", "text.ln_final", out)
        _openclip_blocks(sd, "text.transformer", cfg.text.layers,
                         "text.blocks", out)
    conv = _np(sd["visual.conv1.weight"])             # [D, 3, p, p]
    out["visual.patch_embedding"] = _tensor(
        conv.transpose(2, 3, 1, 0).reshape(-1, conv.shape[0]))
    for ln in ("ln_pre", "ln_post"):
        _ln(sd, f"visual.{ln}", f"visual.{ln}", out)
    _openclip_blocks(sd, "visual.transformer", cfg.vision.layers,
                     "visual.blocks", out)
    src, dst = "visual.attn_pool.", "visual.attn_pool."
    out[dst + "query"] = _tensor(sd[src + "query"])
    for ln in ("ln_q", "ln_k"):
        _ln(sd, src + ln, dst + ln, out)
    for p in "qkv":
        out[dst + f"{p}_w"] = _tensor(_np(sd[src + f"attn.{p}_proj_weight"]).T)
    out[dst + "qkv_b"] = _tensor(sd[src + "attn.in_proj_bias"])
    out[dst + "out_w"] = _tensor(_np(sd[src + "attn.out_proj.weight"]).T)
    out[dst + "out_b"] = _tensor(sd[src + "attn.out_proj.bias"])

    layers = cfg.multimodal.layers
    _openclip_blocks(sd, "text_decoder", layers, "text_decoder.blocks", out)
    for i in range(layers):
        src, dst = f"text_decoder.cross_attn.{i}.", \
            f"text_decoder.cross_blocks.{i}."
        for ln in ("ln_1", "ln_2", "ln_1_kv"):
            _ln(sd, src + ln, dst + ln, out)
        out[dst + "attn.qkv_w"] = _tensor(
            _np(sd[src + "attn.in_proj_weight"]).T)
        out[dst + "attn.qkv_b"] = _tensor(sd[src + "attn.in_proj_bias"])
        out[dst + "attn.out_w"] = _tensor(
            _np(sd[src + "attn.out_proj.weight"]).T)
        out[dst + "attn.out_b"] = _tensor(sd[src + "attn.out_proj.bias"])
        out[dst + "mlp.fc_w"] = _tensor(_np(sd[src + "mlp.c_fc.weight"]).T)
        out[dst + "mlp.fc_b"] = _tensor(sd[src + "mlp.c_fc.bias"])
        out[dst + "mlp.proj_w"] = _tensor(_np(sd[src + "mlp.c_proj.weight"]).T)
        out[dst + "mlp.proj_b"] = _tensor(sd[src + "mlp.c_proj.bias"])
    _ln(sd, "text_decoder.ln_final", "text_decoder.ln_final", out)
    return out


def coca_params_from_jax(tree: Mapping[str, Any]) -> StateDict:
    """The JAX package's CoCa pytree (nested dicts of arrays, each stack
    on a leading layer axis) -> the port's state_dict.  `interop.
    params_from_jax` un-stacks the `blocks` stacks; the decoder's
    `cross_blocks` stack (with its `ln_1_kv`) is un-stacked here into
    `text_decoder.cross_blocks.<i>.`."""
    decoder = dict(tree["text_decoder"])
    cross = decoder.pop("cross_blocks")
    out = params_from_jax({**tree, "text_decoder": decoder})
    for name, value in params_from_jax({"c": cross}).items():
        arr = value.numpy()
        for i in range(arr.shape[0]):
            out[f"text_decoder.cross_blocks.{i}.{name[2:]}"] = \
                torch.from_numpy(np.array(arr[i], order="C", copy=True))
    return out
