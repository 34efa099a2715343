"""Checkpoint conversion, OpenCLIP <-> HF (port of the CLIP-ViT part of
`leaf_tpu/convert.py`):

    python -m leaf_tpu_torch.convert --model ViT-L-14 \
        --input ckpt.safetensors --output out_dir --to hf [--verify]

LEAF trains in OpenCLIP format and releases in HF format; the trainer
also exports the whole model after every saved epoch as
`open_clip_model.safetensors`.  The input's key schema (HF or OpenCLIP)
is detected; the output is an OpenCLIP `open_clip_model.safetensors` or
an HF model directory.  `--verify` reloads what was written and holds
both towers' features to the input's (1e-4), through the port's encoders
on `--device` (default cuda).

Against the JAX package: the HF directory is written here, not by
`transformers` (which the card machine lacks): `config.json` holds the
configuration `transformers.CLIPModel.from_pretrained` reads, and
`model.safetensors` the weights, through the port's own safetensors
writer.  The ResNet and ConvNeXt towers are not ported (ROADMAP Queue 1
item 11).
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

from leaf_tpu_torch.models import interop
from leaf_tpu_torch.models.config import CLIPConfig, get_model_config
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


def hf_config_dict(cfg: CLIPConfig) -> Dict[str, Any]:
    """`transformers.CLIPConfig` keyword arguments for a registry model,
    derived from its config."""
    act = "quick_gelu" if cfg.quick_gelu else "gelu"
    return dict(
        projection_dim=cfg.embed_dim,
        text_config=dict(
            hidden_act=act,
            hidden_size=cfg.text.width,
            intermediate_size=int(cfg.text.width * cfg.text.mlp_ratio),
            num_attention_heads=cfg.text.heads,
            num_hidden_layers=cfg.text.layers,
            max_position_embeddings=cfg.text.context_length,
            vocab_size=cfg.text.vocab_size,
        ),
        vision_config=dict(
            hidden_act=act,
            hidden_size=cfg.vision.width,
            intermediate_size=int(cfg.vision.width * cfg.vision.mlp_ratio),
            num_attention_heads=cfg.vision.heads,
            num_hidden_layers=cfg.vision.layers,
            image_size=cfg.vision.image_size,
            patch_size=cfg.vision.patch_size,
        ),
    )


def save_state_dict(sd: Mapping[str, torch.Tensor], output: str,
                    fmt: str = "openclip") -> str:
    """Write a state dict as `<output>/open_clip_model.safetensors`
    (`fmt` "openclip") or `<output>/model.safetensors` ("hf"); returns the
    file's path.  The `format: pt` metadata is what `transformers` asks
    of a safetensors file."""
    if fmt not in ("openclip", "hf"):
        raise ValueError(f"unknown format {fmt!r} (openclip | hf)")
    os.makedirs(output, exist_ok=True)
    name = "model.safetensors" if fmt == "hf" else "open_clip_model.safetensors"
    path = os.path.join(output, name)
    save_file(sd, path, metadata={"format": "pt"})
    return path


def save_hf_pretrained(sd: Mapping[str, torch.Tensor], cfg: CLIPConfig,
                       output_dir: str, verify: bool = False,
                       device="cpu") -> str:
    """Write an HF model directory (`config.json` + `model.safetensors`)
    that `transformers.CLIPModel.from_pretrained(output_dir)` loads;
    returns the directory."""
    hf = interop.params_to_hf(sd, cfg)
    if verify:
        verify_parity(sd, cfg, hf, "hf", device=device)
    save_state_dict(hf, output_dir, "hf")
    config = {"architectures": ["CLIPModel"], "model_type": "clip",
              "torch_dtype": "float32",
              "logit_scale_init_value": cfg.init_logit_scale,
              **hf_config_dict(cfg)}
    with open(os.path.join(output_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    return output_dir


def verify_parity(sd: Mapping[str, torch.Tensor], cfg: CLIPConfig,
                  converted: Mapping[str, torch.Tensor], fmt: str,
                  device="cpu", atol: float = 1e-4) -> None:
    """Forward parity: the converted state dict read back gives the same
    text and image features as `sd` (fp32, on `device`), within `atol`."""
    from leaf_tpu_torch.models.clip import CLIP
    back = (interop.hf_to_params(converted, cfg) if fmt == "hf"
            else interop.openclip_to_params(converted, cfg))
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, cfg.text.vocab_size - 2,
                          size=(2, cfg.text.context_length))
    tokens[:, 0] = 49406
    tokens[:, -1] = 49407
    images = rng.standard_normal(
        (2, cfg.vision.image_size, cfg.vision.image_size, 3)).astype(np.float32)
    tokens = torch.from_numpy(tokens).to(device)
    images = torch.from_numpy(images).to(device)
    feats = []
    for state in (sd, back):
        module = CLIP(cfg)
        module.load_state_dict({k: v.float() for k, v in state.items()})
        module.to(device).eval()
        with torch.inference_mode():
            feats.append((module.encode_text(tokens).cpu(),
                          module.encode_image(images).cpu()))
        del module
    for name, a, b in zip(("text", "image"), *feats):
        err = float((a - b).abs().max())
        if not err <= atol:
            raise AssertionError(f"{name} parity failed: max diff {err}")


def main(argv=None) -> str:
    p = argparse.ArgumentParser("leaf_tpu_torch checkpoint converter")
    p.add_argument("--model", required=True, help="registry name")
    p.add_argument("--input", required=True,
                   help="checkpoint file/dir (HF or OpenCLIP, auto-detect)")
    p.add_argument("--output", required=True)
    p.add_argument("--to", choices=["hf", "openclip"], required=True)
    p.add_argument("--verify", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="where --verify runs the encoders (default cuda; "
                        "never falls back to the CPU)")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")

    if args.model.startswith("RN") or "convnext" in args.model.lower():
        raise NotImplementedError(
            f"{args.model}: ResNet and ConvNeXt towers are not ported to "
            "leaf_tpu_torch yet: ROADMAP Queue 1 item 11")
    cfg = get_model_config(args.model)
    sd = interop.load_pretrained(args.input, cfg)
    if args.to == "hf":
        path = save_hf_pretrained(sd, cfg, args.output, verify=args.verify,
                                  device=device)
        print(f"wrote HF model directory {path}")
        return path
    out = params_to_openclip(sd, cfg)
    if args.verify:
        verify_parity(sd, cfg, out, args.to, device=device)
    path = save_state_dict(out, args.output, args.to)
    print(f"wrote {path} ({len(out)} tensors)")
    return path


if __name__ == "__main__":
    main()
