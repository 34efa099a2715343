"""Checkpoint interop (port of `leaf_tpu/models/interop.py` for the
families the port runs): HF `CLIPModel` and OpenCLIP state dicts to the
port's state_dict and back to HF, the activation a checkpoint declares,
and the position-grid resize.  OpenCLIP checkpoints with a ModifiedResNet
(`visual.attnpool.*`), a timm trunk (`visual.trunk.*`: ConvNeXt, timm
ViTs, SigLIP, MobileCLIP, EVA, ViTamin) and a `text.`-prefixed tower are
routed as in the JAX package.

Every converter returns the port's `state_dict`: a flat dict of fp32
tensors named like the JAX pytree, with each tower's `[layers, ...]`
stack un-stacked into `blocks.<i>.<name>`.  Mapping rules, as in the JAX
package:

  * torch `nn.Linear` stores weight [out, in]; the port computes
    y = x @ w, so w = weight.T.  In particular OpenCLIP's fused
    `attn.in_proj_weight` [3D, D] becomes `attn.qkv_w` [D, 3D], the
    layout the CUDA GEMM kernels read: the transpose happens here, once,
    never at run time;
  * the vision stride-p conv weight [width, 3, p, p] becomes the patch
    matmul weight [p*p*3, width] in (ph, pw, c) pixel order
    (`clip.patchify`);
  * HF splits the attention input projection into q, k and v; the port
    keeps them fused as the column blocks of `attn.qkv_w` [D, 3D];
  * the JAX package's convolution kernels (ResNet, ConvNeXt, ViTamin,
    MobileCLIP) are HWIO; the port's are OIHW: `params_from_jax`
    transposes every 4-D leaf of the vision tower, a stacked block's
    included.  BatchNorm statistics (`mean`, `var`) are buffers of the
    port's tower, carried like its parameters.
"""
from __future__ import annotations

import json
import logging
import math
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from leaf_tpu_torch.models.config import CLIPConfig

StateDict = Dict[str, torch.Tensor]


def _np(x) -> np.ndarray:
    """torch tensor / array -> float32 numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _tensor(x) -> torch.Tensor:
    # a contiguous copy of the same shape (`np.ascontiguousarray` would
    # turn a 0-d logit_scale into shape [1], which `load_state_dict` refuses)
    return torch.from_numpy(np.array(_np(x), order="C", copy=True))


# ---------------------------------------------------------------------------
# JAX pytree -> state_dict
# ---------------------------------------------------------------------------

def _leaf(x) -> np.ndarray:
    """A pytree leaf as numpy: integer arrays (the int8 MLP weights of
    `models.quantize`) keep their dtype, every other leaf becomes fp32."""
    a = np.asarray(x)
    return a if np.issubdtype(a.dtype, np.integer) else _np(a)


def _oihw(name: str, arr: np.ndarray) -> np.ndarray:
    """A vision tower's 4-D leaf is a convolution kernel: the JAX
    package's HWIO becomes the port's OIHW."""
    return arr.transpose(3, 2, 0, 1) if (
        arr.ndim == 4 and name.startswith("visual.")) else arr


def hf_text_params_from_jax(tree: Mapping[str, Any]) -> StateDict:
    """The JAX package's `HFTextTower` params, `{"hf": <encoder tree>,
    "proj": {...}}` as numpy -> `hf_text.HFTextTower`'s state_dict.  A Flax
    `transformers` tree (RoBERTa/XLM-R, T5/mT5) becomes HF's torch keys:
    the path joined by dots (layer keys `"0"`, ... kept), `kernel` [in,
    out] transposed into `weight` [out, in], `scale` (a LayerNorm's) and
    `embedding` renamed `weight`.  The native M2M100 tree un-stacks its
    `layers` axis (`m2m100.m2m100_state_dict`)."""
    hf = tree["hf"]
    if "embed_tokens" in hf and "layers" in hf:
        from leaf_tpu_torch.models.m2m100 import m2m100_state_dict
        enc = m2m100_state_dict(hf)
    else:
        enc = {}

        def walk(node, path):
            for k, v in node.items():
                if isinstance(v, Mapping):
                    walk(v, path + (str(k),))
                    continue
                arr, last = _np(v), str(k)
                if last == "kernel":
                    arr, last = arr.T, "weight"
                elif last in ("scale", "embedding"):
                    last = "weight"
                enc[".".join(path + (last,))] = _tensor(arr)

        walk(hf, ())
    out = {f"hf.{k}": v for k, v in enc.items()}
    for k, v in tree.get("proj", {}).items():
        out[f"proj.{k}"] = _tensor(v)
    return out


def params_from_jax(tree: Mapping[str, Any]) -> StateDict:
    """The JAX package's parameter pytree (nested dicts and lists of
    arrays) -> the port's state_dict.  Leaves under a `blocks` key carry a
    leading layer axis, which is un-stacked into `blocks.<i>.`; list items
    become `<i>.`; the vision tower's convolution kernels go from HWIO to
    OIHW (`_oihw`).  An int8-quantized pytree (`fc_w`/`proj_w` int8 beside
    their `_scale`) keeps its int8 leaves.  An HF text tower (`text` holding
    `hf`) goes through `hf_text_params_from_jax`."""
    text = tree.get("text") if isinstance(tree, Mapping) else None
    if isinstance(text, Mapping) and "hf" in text:
        rest = params_from_jax({k: v for k, v in tree.items()
                                if k != "text"})
        return {**rest, **{f"text.{k}": v for k, v in
                           hf_text_params_from_jax(text).items()}}
    out: StateDict = {}

    def leaves(node, prefix):
        items = (node.items() if isinstance(node, Mapping)
                 else enumerate(node))
        for k, v in items:
            if isinstance(v, (Mapping, list, tuple)):
                yield from leaves(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", v

    for name, value in leaves(tree, ""):
        if ".blocks." in f".{name}":
            head, rest = name.split("blocks.", 1)
            arr = _leaf(value)
            for i in range(arr.shape[0]):
                out[f"{head}blocks.{i}.{rest}"] = torch.from_numpy(
                    np.array(_oihw(name, arr[i]), order="C", copy=True))
        else:
            out[name] = _tensor(_oihw(name, _leaf(value)))
    return out


# ---------------------------------------------------------------------------
# HF transformers CLIPModel state dict <-> state_dict
# ---------------------------------------------------------------------------

def _hf_blocks(sd: Mapping[str, Any], prefix: str, layers: int,
               out_prefix: str, out: StateDict) -> None:
    for i in range(layers):
        src, dst = f"{prefix}.layers.{i}.", f"{out_prefix}.{i}."

        def get(name):
            return _np(sd[src + name])

        out[dst + "ln_1.scale"] = _tensor(get("layer_norm1.weight"))
        out[dst + "ln_1.bias"] = _tensor(get("layer_norm1.bias"))
        out[dst + "attn.qkv_w"] = _tensor(np.concatenate(
            [get(f"self_attn.{p}_proj.weight").T for p in "qkv"], axis=1))
        out[dst + "attn.qkv_b"] = _tensor(np.concatenate(
            [get(f"self_attn.{p}_proj.bias") for p in "qkv"]))
        out[dst + "attn.out_w"] = _tensor(get("self_attn.out_proj.weight").T)
        out[dst + "attn.out_b"] = _tensor(get("self_attn.out_proj.bias"))
        out[dst + "ln_2.scale"] = _tensor(get("layer_norm2.weight"))
        out[dst + "ln_2.bias"] = _tensor(get("layer_norm2.bias"))
        out[dst + "mlp.fc_w"] = _tensor(get("mlp.fc1.weight").T)
        out[dst + "mlp.fc_b"] = _tensor(get("mlp.fc1.bias"))
        out[dst + "mlp.proj_w"] = _tensor(get("mlp.fc2.weight").T)
        out[dst + "mlp.proj_b"] = _tensor(get("mlp.fc2.bias"))


def hf_text_to_params(sd: Mapping[str, Any], cfg: CLIPConfig) -> StateDict:
    """The text half of an HF `CLIPModel.state_dict()` -> the port's
    `text.*` entries.  A `text_projection.bias` (absent from HF's own
    CLIP) becomes `text.text_projection_bias`, as in the JAX package."""
    out: StateDict = {
        "text.token_embedding": _tensor(
            sd["text_model.embeddings.token_embedding.weight"]),
        "text.positional_embedding": _tensor(
            sd["text_model.embeddings.position_embedding.weight"]),
        "text.ln_final.scale": _tensor(
            sd["text_model.final_layer_norm.weight"]),
        "text.ln_final.bias": _tensor(sd["text_model.final_layer_norm.bias"]),
        "text.text_projection": _tensor(_np(sd["text_projection.weight"]).T),
    }
    _hf_blocks(sd, "text_model.encoder", cfg.text.layers, "text.blocks", out)
    if "text_projection.bias" in sd:
        out["text.text_projection_bias"] = _tensor(sd["text_projection.bias"])
    return out


def hf_vision_to_params(sd: Mapping[str, Any], cfg: CLIPConfig) -> StateDict:
    """The vision half of an HF `CLIPModel.state_dict()` -> the port's
    `visual.*` entries."""
    conv = _np(sd["vision_model.embeddings.patch_embedding.weight"])
    # HF spells it "pre_layrnorm" (sic)
    pre = ("vision_model.pre_layrnorm"
           if "vision_model.pre_layrnorm.weight" in sd
           else "vision_model.pre_layernorm")
    out: StateDict = {
        "visual.patch_embedding": _tensor(
            conv.transpose(2, 3, 1, 0).reshape(-1, conv.shape[0])),
        "visual.class_embedding": _tensor(
            sd["vision_model.embeddings.class_embedding"]),
        "visual.positional_embedding": _tensor(
            sd["vision_model.embeddings.position_embedding.weight"]),
        "visual.ln_pre.scale": _tensor(sd[f"{pre}.weight"]),
        "visual.ln_pre.bias": _tensor(sd[f"{pre}.bias"]),
        "visual.ln_post.scale": _tensor(
            sd["vision_model.post_layernorm.weight"]),
        "visual.ln_post.bias": _tensor(sd["vision_model.post_layernorm.bias"]),
        "visual.proj": _tensor(_np(sd["visual_projection.weight"]).T),
    }
    _hf_blocks(sd, "vision_model.encoder", cfg.vision.layers, "visual.blocks",
               out)
    return out


def hf_to_params(sd: Mapping[str, Any], cfg: CLIPConfig) -> StateDict:
    """A whole HF `CLIPModel.state_dict()` -> the port's state_dict."""
    return {**hf_text_to_params(sd, cfg), **hf_vision_to_params(sd, cfg),
            "logit_scale": _tensor(_np(sd["logit_scale"]).reshape(()))}


def params_to_hf(sd: Mapping[str, torch.Tensor],
                 cfg: CLIPConfig) -> Dict[str, torch.Tensor]:
    """The port's state_dict -> an HF `CLIPModel` state dict (fp32 CPU
    tensors, contiguous).  HF's CLIP has a mandatory `pre_layrnorm` and
    class embedding; a tower without them is refused."""
    out: Dict[str, torch.Tensor] = {}

    def put(key: str, value, transpose: bool = False) -> None:
        value = torch.as_tensor(value).detach().to("cpu", torch.float32)
        out[key] = (value.T if transpose else value).contiguous()

    put("text_model.embeddings.token_embedding.weight",
        sd["text.token_embedding"])
    put("text_model.embeddings.position_embedding.weight",
        sd["text.positional_embedding"])
    put("text_model.final_layer_norm.weight", sd["text.ln_final.scale"])
    put("text_model.final_layer_norm.bias", sd["text.ln_final.bias"])
    put("text_projection.weight", sd["text.text_projection"], True)

    if "visual.ln_pre.scale" not in sd or "visual.class_embedding" not in sd:
        raise ValueError(
            "transformers' CLIPModel has a mandatory pre_layrnorm and "
            "class embedding; this tower lacks them (CLIPA-style "
            "no_ln_pre / token-less) — export with --to openclip instead")
    p, width = cfg.vision.patch_size, cfg.vision.width
    conv = torch.as_tensor(sd["visual.patch_embedding"]).reshape(p, p, 3, width)
    put("vision_model.embeddings.patch_embedding.weight",
        conv.permute(3, 2, 0, 1))
    put("vision_model.embeddings.class_embedding",
        sd["visual.class_embedding"])
    put("vision_model.embeddings.position_embedding.weight",
        sd["visual.positional_embedding"])
    put("vision_model.pre_layrnorm.weight", sd["visual.ln_pre.scale"])
    put("vision_model.pre_layrnorm.bias", sd["visual.ln_pre.bias"])
    put("vision_model.post_layernorm.weight", sd["visual.ln_post.scale"])
    put("vision_model.post_layernorm.bias", sd["visual.ln_post.bias"])
    put("visual_projection.weight", sd["visual.proj"], True)
    put("logit_scale", sd["logit_scale"])

    for tower, prefix, n_layers in (
            ("text", "text_model.encoder", cfg.text.layers),
            ("visual", "vision_model.encoder", cfg.vision.layers)):
        for i in range(n_layers):
            src, dst = f"{tower}.blocks.{i}.", f"{prefix}.layers.{i}."
            qkv_w, qkv_b = sd[src + "attn.qkv_w"], sd[src + "attn.qkv_b"]
            D = qkv_w.shape[0]
            for j, name in enumerate("qkv"):
                put(dst + f"self_attn.{name}_proj.weight",
                    qkv_w[:, j * D:(j + 1) * D], True)
                put(dst + f"self_attn.{name}_proj.bias",
                    qkv_b[j * D:(j + 1) * D])
            put(dst + "self_attn.out_proj.weight", sd[src + "attn.out_w"], True)
            put(dst + "self_attn.out_proj.bias", sd[src + "attn.out_b"])
            put(dst + "layer_norm1.weight", sd[src + "ln_1.scale"])
            put(dst + "layer_norm1.bias", sd[src + "ln_1.bias"])
            put(dst + "layer_norm2.weight", sd[src + "ln_2.scale"])
            put(dst + "layer_norm2.bias", sd[src + "ln_2.bias"])
            put(dst + "mlp.fc1.weight", sd[src + "mlp.fc_w"], True)
            put(dst + "mlp.fc1.bias", sd[src + "mlp.fc_b"])
            put(dst + "mlp.fc2.weight", sd[src + "mlp.proj_w"], True)
            put(dst + "mlp.fc2.bias", sd[src + "mlp.proj_b"])
    return out


# ---------------------------------------------------------------------------
# OpenCLIP state dict -> state_dict
# ---------------------------------------------------------------------------

def _openclip_blocks(sd: Mapping[str, Any], prefix: str, layers: int,
                     out_prefix: str, out: StateDict) -> None:
    for i in range(layers):
        src, dst = f"{prefix}.resblocks.{i}.", f"{out_prefix}.{i}."
        for ln in ("ln_1", "ln_2"):
            out[dst + f"{ln}.scale"] = _tensor(sd[src + f"{ln}.weight"])
            out[dst + f"{ln}.bias"] = _tensor(sd[src + f"{ln}.bias"])
        out[dst + "attn.qkv_w"] = _tensor(_np(sd[src + "attn.in_proj_weight"]).T)
        out[dst + "attn.qkv_b"] = _tensor(sd[src + "attn.in_proj_bias"])
        out[dst + "attn.out_w"] = _tensor(_np(sd[src + "attn.out_proj.weight"]).T)
        out[dst + "attn.out_b"] = _tensor(sd[src + "attn.out_proj.bias"])
        out[dst + "mlp.fc_w"] = _tensor(_np(sd[src + "mlp.c_fc.weight"]).T)
        out[dst + "mlp.fc_b"] = _tensor(sd[src + "mlp.c_fc.bias"])
        out[dst + "mlp.proj_w"] = _tensor(_np(sd[src + "mlp.c_proj.weight"]).T)
        out[dst + "mlp.proj_b"] = _tensor(sd[src + "mlp.c_proj.bias"])


def _openclip_text(sd: Mapping[str, Any], cfg: CLIPConfig, tp: str,
                   out: StateDict) -> None:
    """The native text tower of an OpenCLIP state dict (its keys under
    `tp`) -> `text.*`: a `text_projection` matrix, or a Linear projection
    with its bias (SigLIP)."""
    out["text.token_embedding"] = _tensor(sd[tp + "token_embedding.weight"])
    out["text.positional_embedding"] = _tensor(sd[tp + "positional_embedding"])
    _openclip_blocks(sd, tp + "transformer", cfg.text.layers, "text.blocks",
                     out)
    out["text.ln_final.scale"] = _tensor(sd[tp + "ln_final.weight"])
    out["text.ln_final.bias"] = _tensor(sd[tp + "ln_final.bias"])
    if tp + "text_projection.weight" in sd:
        out["text.text_projection"] = _tensor(
            _np(sd[tp + "text_projection.weight"]).T)
        if tp + "text_projection.bias" in sd:
            out["text.text_projection_bias"] = _tensor(
                sd[tp + "text_projection.bias"])
    else:
        out["text.text_projection"] = _tensor(sd[tp + "text_projection"])


def openclip_to_params(sd: Mapping[str, Any], cfg: CLIPConfig) -> StateDict:
    """OpenCLIP `CLIP.state_dict()` or `CustomTextCLIP.state_dict()` -> the
    port's state_dict, the vision tower detected from the keys: a
    ModifiedResNet (`visual.attnpool.*`) goes through
    `resnet.resnet_openclip_to_params`; a timm trunk (`visual.trunk.*`)
    through `convnext.timm_convnext_to_params` for a ConvNeXt config,
    `trunks.from_timm` for a trunk config (MobileCLIP, EVA, ViTamin) and
    `timm_vision.timm_vit_to_params` for a ViT (its head, linear or MLP,
    from the keys); otherwise the CLIP ViT (`visual.conv1.weight`; `ln_pre`
    only where the weights have it, as CLIPA's do not).  The text tower may
    sit under `text.`; a `logit_bias` (SigLIP) is carried.  A `module.`
    prefix (DDP training checkpoints) is dropped."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    tp = "text." if "text.token_embedding.weight" in sd else ""
    if "visual.attnpool.positional_embedding" in sd:
        if cfg.resnet is None:
            raise ValueError(f"the checkpoint has a ModifiedResNet tower but "
                             f"{cfg.name}'s config does not")
        from leaf_tpu_torch.models.resnet import resnet_openclip_to_params
        out = params_from_jax({"visual": resnet_openclip_to_params(sd)})
    elif any(k.startswith("visual.trunk.") for k in sd):
        if cfg.convnext is not None:
            from leaf_tpu_torch.models.convnext import timm_convnext_to_params
            visual = timm_convnext_to_params(sd, cfg.convnext)
        elif cfg.trunk is not None:
            from leaf_tpu_torch.models import trunks
            visual = trunks.from_timm(sd, cfg.trunk)
        else:
            from leaf_tpu_torch.models.timm_vision import timm_vit_to_params
            proj = "mlp" if any(k.startswith("visual.head.mlp.")
                                for k in sd) else "linear"
            visual = timm_vit_to_params(sd, cfg.vision, proj=proj)
        out = params_from_jax({"visual": visual})
    elif "visual.conv1.weight" in sd:
        out = {}
        conv = _np(sd["visual.conv1.weight"])             # [D, 3, p, p]
        out["visual.patch_embedding"] = _tensor(
            conv.transpose(2, 3, 1, 0).reshape(-1, conv.shape[0]))
        if "visual.class_embedding" in sd:   # none in a token-less ViT
            out["visual.class_embedding"] = _tensor(
                sd["visual.class_embedding"])
        out["visual.positional_embedding"] = _tensor(
            sd["visual.positional_embedding"])
        for ln in ("ln_pre", "ln_post"):
            if f"visual.{ln}.weight" in sd:      # CLIPA has no ln_pre
                out[f"visual.{ln}.scale"] = _tensor(sd[f"visual.{ln}.weight"])
                out[f"visual.{ln}.bias"] = _tensor(sd[f"visual.{ln}.bias"])
        _openclip_blocks(sd, "visual.transformer", cfg.vision.layers,
                         "visual.blocks", out)
        out["visual.proj"] = _tensor(sd["visual.proj"])
    else:
        raise ValueError(
            "not an OpenCLIP state dict: no visual.conv1.weight (ViT), "
            "visual.attnpool.* (ModifiedResNet) or visual.trunk.* (timm)")
    _openclip_text(sd, cfg, tp, out)
    out["logit_scale"] = _tensor(_np(sd["logit_scale"]).reshape(()))
    if "logit_bias" in sd:               # SigLIP's sigmoid-loss bias
        out["logit_bias"] = _tensor(_np(sd["logit_bias"]).reshape(()))
    return out


# ---------------------------------------------------------------------------
# File loaders
# ---------------------------------------------------------------------------

def load_state_dict_file(path: str) -> StateDict:
    """Load a checkpoint file (torch .pt/.bin, or .safetensors, read by
    the port's own reader) -> dict of fp32 tensors."""
    if path.endswith(".safetensors"):
        from leaf_tpu_torch.utils.safetensors_io import load_file
        return {k: v.float() for k, v in load_file(path).items()}
    try:
        # OpenAI's released CLIP .pt files are TorchScript archives
        ckpt = torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    # TorchScript state dicts carry non-weight metadata tensors
    skip = {"input_resolution", "context_length", "vocab_size"}
    return {k: v.float() for k, v in ckpt.items() if k not in skip}


def checkpoint_quick_gelu(path: str) -> Optional[bool]:
    """Does the checkpoint at `path` (file or snapshot dir) declare a
    QuickGELU text tower?  None: no config metadata found (e.g. bare
    OpenAI TorchScript .pt files).

    Reads, in order: a per-file sidecar `<file>.open_clip_config.json`;
    the directory's `open_clip_config.json` (`model_cfg.quick_gelu`); an
    HF `config.json` (`text_config.hidden_act == "quick_gelu"`), unless
    its `model_type` is not CLIP's.  A bare file name has no config
    directory and gives None."""
    if os.path.isfile(path):
        sidecar = path + ".open_clip_config.json"
        if os.path.exists(sidecar):
            with open(sidecar) as f:
                return bool(json.load(f).get("model_cfg", {})
                            .get("quick_gelu", False))
    d = path if os.path.isdir(path) else os.path.dirname(path)
    if not d:
        return None
    oc = os.path.join(d, "open_clip_config.json")
    if os.path.exists(oc):
        with open(oc) as f:
            return bool(json.load(f).get("model_cfg", {})
                        .get("quick_gelu", False))
    hf = os.path.join(d, "config.json")
    if os.path.exists(hf):
        with open(hf) as f:
            c = json.load(f)
        if c.get("model_type") not in (None, "clip"):
            return None
        act = c.get("text_config", c).get("hidden_act")
        return None if act is None else act == "quick_gelu"
    return None


def resolve_checkpoint_file(path: str) -> str:
    """Snapshot dir -> the weights file inside it (no-op for files)."""
    if os.path.isdir(path):
        for cand in ("open_clip_model.safetensors", "model.safetensors",
                     "open_clip_pytorch_model.bin", "pytorch_model.bin"):
            f = os.path.join(path, cand)
            if os.path.exists(f):
                return f
        raise FileNotFoundError(f"no checkpoint file found under {path}")
    return path


def load_pretrained(path: str, cfg: CLIPConfig) -> StateDict:
    """Load an HF or OpenCLIP checkpoint file or snapshot directory into
    the port's state_dict, the key schema detected from the keys."""
    sd = load_state_dict_file(resolve_checkpoint_file(path))
    if any(k.startswith("text_model.") for k in sd):
        return hf_to_params(sd, cfg)
    return openclip_to_params(sd, cfg)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel with a = -0.5, as `jax.image.resize`
    uses it ("cubic"); torch's bicubic modes use a = -0.75."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _resize_weights(n_in: int, n_out: int) -> torch.Tensor:
    """[n_in, n_out] fp32 weights of a cubic, antialiased resize along one
    axis, computed as `jax.image.resize` does (`compute_weight_mat`): the
    kernel stretched by the downscale factor, each output's weights
    renormalised to sum 1 (so the edges renormalise), samples outside
    the input zeroed."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]
         ).abs() / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_vision_pos_embed(sd: StateDict, cfg: CLIPConfig) -> StateDict:
    """Resize a loaded ViT position-embedding grid to the config's
    resolution (cubic, antialiased, as `jax.image.resize(..., "cubic",
    antialias=True)`; the class token, where the tower has one, passes
    through).  No-op when the length already matches, and for the towers
    whose positions have their own conventions, as in the JAX package: a
    trunk (MobileCLIP, EVA, ViTamin), a ConvNeXt (none) and a
    ModifiedResNet (its attention pool's, never resized on load)."""
    pe = sd.get("visual.positional_embedding")
    if pe is None or cfg.trunk is not None or cfg.convnext is not None \
            or cfg.resnet is not None:
        return sd
    grid = cfg.vision.image_size // cfg.vision.patch_size
    extra = 1 if "visual.class_embedding" in sd else 0
    if grid * grid + extra == pe.shape[0]:
        return sd
    tok, img = pe[:extra], pe[extra:]
    old = math.isqrt(img.shape[0])
    if old * old != img.shape[0]:
        raise ValueError(
            f"cannot resize a non-square position grid of {img.shape[0]}")
    logging.getLogger(__name__).info(
        "resizing position embedding grid %dx%d -> %dx%d", old, old, grid,
        grid)
    w = _resize_weights(old, grid)
    img = img.float().reshape(old, old, -1)
    img = torch.einsum("hwc,hH,wW->HWc", img, w, w).reshape(grid * grid, -1)
    out = dict(sd)
    out["visual.positional_embedding"] = torch.cat(
        [tok.float(), img]).to(pe.dtype).contiguous()
    return out
