"""Checkpoint interop (port of the CLIP-ViT parts of
`leaf_tpu/models/interop.py`).

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
    (`clip.patchify`).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Mapping

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

def params_from_jax(tree: Mapping[str, Any]) -> StateDict:
    """The JAX package's parameter pytree (nested dicts of arrays) -> the
    port's state_dict.  Leaves under a `blocks` key carry a leading layer
    axis, which is un-stacked into `blocks.<i>.`."""
    out: StateDict = {}

    def leaves(node, prefix):
        for k, v in node.items():
            if isinstance(v, Mapping):
                yield from leaves(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", v

    for name, value in leaves(tree, ""):
        if ".blocks." in f".{name}":
            head, rest = name.split("blocks.", 1)
            arr = _np(value)
            for i in range(arr.shape[0]):
                out[f"{head}blocks.{i}.{rest}"] = _tensor(arr[i])
        else:
            out[name] = _tensor(value)
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


def openclip_to_params(sd: Mapping[str, Any], cfg: CLIPConfig) -> StateDict:
    """OpenCLIP `CLIP.state_dict()` (CLIP-ViT: ViT vision tower, native
    text tower) -> the port's state_dict.  A `module.` prefix (DDP
    training checkpoints) is dropped."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    if "visual.conv1.weight" not in sd:
        raise ValueError(
            "not an OpenCLIP CLIP-ViT state dict (no visual.conv1.weight); "
            "ResNet, timm-trunk, custom-text and HF checkpoints are not "
            "ported yet")
    out: StateDict = {}
    conv = _np(sd["visual.conv1.weight"])             # [D, 3, p, p]
    out["visual.patch_embedding"] = _tensor(
        conv.transpose(2, 3, 1, 0).reshape(-1, conv.shape[0]))
    out["visual.class_embedding"] = _tensor(sd["visual.class_embedding"])
    out["visual.positional_embedding"] = _tensor(sd["visual.positional_embedding"])
    for ln in ("ln_pre", "ln_post"):
        out[f"visual.{ln}.scale"] = _tensor(sd[f"visual.{ln}.weight"])
        out[f"visual.{ln}.bias"] = _tensor(sd[f"visual.{ln}.bias"])
    _openclip_blocks(sd, "visual.transformer", cfg.vision.layers,
                     "visual.blocks", out)
    out["visual.proj"] = _tensor(sd["visual.proj"])

    out["text.token_embedding"] = _tensor(sd["token_embedding.weight"])
    out["text.positional_embedding"] = _tensor(sd["positional_embedding"])
    _openclip_blocks(sd, "transformer", cfg.text.layers, "text.blocks", out)
    out["text.ln_final.scale"] = _tensor(sd["ln_final.weight"])
    out["text.ln_final.bias"] = _tensor(sd["ln_final.bias"])
    out["text.text_projection"] = _tensor(sd["text_projection"])
    out["logit_scale"] = _tensor(_np(sd["logit_scale"]).reshape(()))
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
    """Load an OpenCLIP checkpoint file or snapshot directory into the
    port's state_dict."""
    sd = load_state_dict_file(resolve_checkpoint_file(path))
    if any(k.startswith("text_model.") for k in sd):
        raise NotImplementedError(
            f"{path}: HF-format CLIP checkpoints are not ported to "
            "leaf_tpu_torch yet (ROADMAP Queue 1 item 13); convert it to "
            "OpenCLIP format on a machine where the JAX package runs "
            "(leaf_tpu.convert), then pass the converted file")
    return openclip_to_params(sd, cfg)
