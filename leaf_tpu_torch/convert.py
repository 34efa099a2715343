"""Checkpoint export to the OpenCLIP format (port of the CLIP-ViT part of
`leaf_tpu/convert.py`).

LEAF trains in OpenCLIP format; the trainer exports the whole model
after every saved epoch as `open_clip_model.safetensors`, the file the
standalone evals and the JAX package's loaders read.  Ported:
`params_to_openclip` for CLIP-ViT towers (the reverse of
`interop.openclip_to_params`) and `save_state_dict` in the `openclip`
format, on the port's own safetensors writer.  Not ported yet: the
command line, the HF format, and the ResNet and ConvNeXt branches.
"""
from __future__ import annotations

import os
from typing import Dict, Mapping

import torch

from leaf_tpu_torch.models.config import CLIPConfig
from leaf_tpu_torch.utils.safetensors_io import save_file


def params_to_openclip(sd: Mapping[str, torch.Tensor],
                       cfg: CLIPConfig) -> Dict[str, torch.Tensor]:
    """The port's `CLIP.state_dict()` -> OpenCLIP state dict (fp32 CPU
    tensors, contiguous): the reverse of `interop.openclip_to_params`.
    `nn.Linear` weights are [out, in] there, so every matmul weight is
    transposed back."""
    out: Dict[str, torch.Tensor] = {}

    def put(key: str, value: torch.Tensor, transpose: bool = False) -> None:
        value = value.detach().to("cpu", torch.float32)
        out[key] = (value.T if transpose else value).contiguous()

    put("token_embedding.weight", sd["text.token_embedding"])
    put("positional_embedding", sd["text.positional_embedding"])
    put("ln_final.weight", sd["text.ln_final.scale"])
    put("ln_final.bias", sd["text.ln_final.bias"])
    put("text_projection", sd["text.text_projection"])
    put("logit_scale", sd["logit_scale"])

    p = cfg.vision.patch_size
    conv = sd["visual.patch_embedding"].reshape(p, p, 3, cfg.vision.width)
    put("visual.conv1.weight", conv.permute(3, 2, 0, 1))
    put("visual.class_embedding", sd["visual.class_embedding"])
    put("visual.positional_embedding", sd["visual.positional_embedding"])
    for ln in ("ln_pre", "ln_post"):
        put(f"visual.{ln}.weight", sd[f"visual.{ln}.scale"])
        put(f"visual.{ln}.bias", sd[f"visual.{ln}.bias"])
    put("visual.proj", sd["visual.proj"])

    for tower, prefix, n_layers in (
            ("text", "transformer", cfg.text.layers),
            ("visual", "visual.transformer", cfg.vision.layers)):
        for i in range(n_layers):
            src, dst = f"{tower}.blocks.{i}.", f"{prefix}.resblocks.{i}."
            put(dst + "attn.in_proj_weight", sd[src + "attn.qkv_w"], True)
            put(dst + "attn.in_proj_bias", sd[src + "attn.qkv_b"])
            put(dst + "attn.out_proj.weight", sd[src + "attn.out_w"], True)
            put(dst + "attn.out_proj.bias", sd[src + "attn.out_b"])
            for ln in ("ln_1", "ln_2"):
                put(dst + f"{ln}.weight", sd[src + f"{ln}.scale"])
                put(dst + f"{ln}.bias", sd[src + f"{ln}.bias"])
            put(dst + "mlp.c_fc.weight", sd[src + "mlp.fc_w"], True)
            put(dst + "mlp.c_fc.bias", sd[src + "mlp.fc_b"])
            put(dst + "mlp.c_proj.weight", sd[src + "mlp.proj_w"], True)
            put(dst + "mlp.c_proj.bias", sd[src + "mlp.proj_b"])
    return out


def save_state_dict(sd: Mapping[str, torch.Tensor], output: str,
                    fmt: str = "openclip") -> str:
    """Write a state dict as `<output>/open_clip_model.safetensors`;
    returns the file's path."""
    if fmt != "openclip":
        raise NotImplementedError(
            f"format {fmt!r} is not ported to leaf_tpu_torch yet (only "
            "'openclip'): ROADMAP Queue 1 item 13")
    os.makedirs(output, exist_ok=True)
    path = os.path.join(output, "open_clip_model.safetensors")
    save_file(sd, path)
    return path
