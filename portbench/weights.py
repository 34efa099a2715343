"""Seeded random weights in OpenCLIP's layout, made on the device.

One `torch.Generator` on the card, seeded by the run's seed, draws every
tensor of a tower in one call; each tensor is a slice of that draw,
scaled as OpenCLIP initialises it (normal weights of its standard
deviations).  Biases and LayerNorm parameters, zero and one in OpenCLIP's
init, get small random values instead (the configuration file lists them
under `assumed`), so that a bias or a LayerNorm gain that the program
drops shows in the comparison; a configuration's `qkv_gain` scales the
vision tower's attention in-projections.  The same tensors go to the
program (in its own parameter layout, `to_port`) and to the reference (as
they are).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

BIAS_STD = 0.02
LN_STD = 0.05


def _block_specs(prefix: str, width: int, layers: int, mlp: int,
                 total_layers: int) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, kind, std) of a residual stack in OpenCLIP's names;
    `total_layers` sets the output projections' std, as the published
    depth does."""
    attn_std = width ** -0.5
    proj_std = attn_std * (2 * total_layers) ** -0.5
    fc_std = (2 * width) ** -0.5
    out = []
    for i in range(layers):
        p = f"{prefix}.resblocks.{i}."
        out += [(p + "ln_1.weight", (width,), "ln", 0.0),
                (p + "ln_1.bias", (width,), "bias", 0.0),
                (p + "attn.in_proj_weight", (3 * width, width), "w", attn_std),
                (p + "attn.in_proj_bias", (3 * width,), "bias", 0.0),
                (p + "attn.out_proj.weight", (width, width), "w", proj_std),
                (p + "attn.out_proj.bias", (width,), "bias", 0.0),
                (p + "ln_2.weight", (width,), "ln", 0.0),
                (p + "ln_2.bias", (width,), "bias", 0.0),
                (p + "mlp.c_fc.weight", (mlp, width), "w", fc_std),
                (p + "mlp.c_fc.bias", (mlp,), "bias", 0.0),
                (p + "mlp.c_proj.weight", (width, mlp), "w", proj_std),
                (p + "mlp.c_proj.bias", (width,), "bias", 0.0)]
    return out


def text_specs(model_cfg: dict, published_layers: int):
    t = model_cfg["text_cfg"]
    w, embed = t["width"], model_cfg["embed_dim"]
    return ([("token_embedding.weight", (t["vocab_size"], w), "w", 0.02),
             ("positional_embedding", (t["context_length"], w), "w", 0.01)]
            + _block_specs("transformer", w, t["layers"],
                           int(w * t.get("mlp_ratio", 4.0)), published_layers)
            + [("ln_final.weight", (w,), "ln", 0.0),
               ("ln_final.bias", (w,), "bias", 0.0),
               ("text_projection", (w, embed), "w", w ** -0.5)])


def vision_specs(model_cfg: dict, published_layers: int):
    """The vision tower's tensors; the configuration's `qkv_gain` (1 by
    default) multiplies the in-projections' std."""
    v = model_cfg["vision_cfg"]
    w, p, embed = v["width"], v["patch_size"], model_cfg["embed_dim"]
    tokens = (v["image_size"] // p) ** 2 + 1
    scale = w ** -0.5
    gain = model_cfg.get("qkv_gain", 1.0)
    blocks = [(name, shape, kind, std * gain if "in_proj_weight" in name
               else std)
              for name, shape, kind, std in _block_specs(
                  "visual.transformer", w, v["layers"],
                  int(w * v.get("mlp_ratio", 4.0)), published_layers)]
    return ([("visual.conv1.weight", (w, 3, p, p), "w", (3 * p * p) ** -0.5),
             ("visual.class_embedding", (w,), "w", scale),
             ("visual.positional_embedding", (tokens, w), "w", scale),
             ("visual.ln_pre.weight", (w,), "ln", 0.0),
             ("visual.ln_pre.bias", (w,), "bias", 0.0)]
            + blocks
            + [("visual.ln_post.weight", (w,), "ln", 0.0),
               ("visual.ln_post.bias", (w,), "bias", 0.0),
               ("visual.proj", (w, embed), "w", scale)])


def make(specs, seed: int, device) -> Dict[str, torch.Tensor]:
    """The tensors of `specs`, fp32, from one draw of a generator on
    `device` seeded by `seed`."""
    total = sum(torch.Size(shape).numel() for _, shape, _, _ in specs)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind, std in specs:
        n = torch.Size(shape).numel()
        piece = flat[at:at + n].view(shape)
        at += n
        if kind == "w":
            out[name] = piece.mul_(std)
        elif kind == "bias":
            out[name] = piece.mul_(BIAS_STD)
        else:
            out[name] = piece.mul_(LN_STD).add_(1.0)
    return out


def port_names(oc_name: str) -> Tuple[str, bool]:
    """The program's parameter name (within its tower) of an OpenCLIP
    tensor, and whether the program stores it transposed."""
    name = oc_name.removeprefix("visual.")
    table = {"token_embedding.weight": "token_embedding",
             "conv1.weight": "patch_embedding"}
    if name in table:
        return table[name], False
    if ".resblocks." in name:
        i, rest = name.split(".resblocks.")[1].split(".", 1)
        block = {"ln_1.weight": ("ln_1.scale", False),
                 "ln_1.bias": ("ln_1.bias", False),
                 "ln_2.weight": ("ln_2.scale", False),
                 "ln_2.bias": ("ln_2.bias", False),
                 "attn.in_proj_weight": ("attn.qkv_w", True),
                 "attn.in_proj_bias": ("attn.qkv_b", False),
                 "attn.out_proj.weight": ("attn.out_w", True),
                 "attn.out_proj.bias": ("attn.out_b", False),
                 "mlp.c_fc.weight": ("mlp.fc_w", True),
                 "mlp.c_fc.bias": ("mlp.fc_b", False),
                 "mlp.c_proj.weight": ("mlp.proj_w", True),
                 "mlp.c_proj.bias": ("mlp.proj_b", False)}[rest]
        return f"blocks.{i}.{block[0]}", block[1]
    if name.endswith(".weight") and name.split(".")[0].startswith("ln_"):
        return name[:-len("weight")] + "scale", False
    return name, False


def to_port(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """OpenCLIP tensors -> the program's tower state dict (copies)."""
    out = {}
    for oc_name, t in tensors.items():
        name, transpose = port_names(oc_name)
        if oc_name == "visual.conv1.weight":
            # [D, 3, p, p] -> rows in (p, p, 3) order, as the program
            # patchifies NHWC images
            t = t.permute(2, 3, 1, 0).reshape(-1, t.shape[0])
        elif transpose:
            t = t.t()
        out[name] = t.contiguous().clone()
    return out
