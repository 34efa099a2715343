"""Publish a model to the Hugging Face Hub in open_clip layout (port of
`leaf_tpu/push_to_hf_hub.py`):

    python -m leaf_tpu_torch.push_to_hf_hub --model ViT-B-32 \\
        --input ckpt.safetensors --repo-id me/my-clip \\
        [--local-dir /path] [--local-dir-only]

Writes a hub-ready directory: `open_clip_model.safetensors` (OpenCLIP
key schema), `open_clip_config.json` (`{model_cfg, preprocess_cfg}`) and
a model-card `README.md`; then uploads it with `huggingface_hub`.
`--local-dir-only` writes the directory and stops.  Without
`huggingface_hub` the upload raises the JAX package's `RuntimeError`,
which names the directory to upload by hand.  Nothing here runs on a
device: the weights go from file to file on the host.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import tempfile
from typing import Any, Dict, Mapping, Optional

import torch

from leaf_tpu_torch.convert import params_to_openclip, save_state_dict
from leaf_tpu_torch.models.config import CLIPConfig, get_model_config
from leaf_tpu_torch.models.preprocess import (OPENAI_DATASET_MEAN,
                                              OPENAI_DATASET_STD)

LOG = logging.getLogger("leaf_tpu_torch.push_to_hf_hub")


def config_to_open_clip_dict(cfg: CLIPConfig) -> Dict[str, Any]:
    """CLIPConfig -> the `model_cfg` JSON schema of open_clip's
    `model_configs/*.json`, for the CLIP-ViT configs of the port's
    registry: only the keys that differ from open_clip's defaults, as
    the JAX package writes them."""
    v, t = cfg.vision, cfg.text
    vision: Dict[str, Any] = {
        "image_size": v.image_size, "patch_size": v.patch_size,
        "width": v.width, "layers": v.layers,
        "head_width": v.head_width, "mlp_ratio": v.mlp_ratio,
    }
    if v.patch_dropout:
        vision["patch_dropout"] = v.patch_dropout
    if v.ln_eps != 1e-5:
        vision["norm_kwargs"] = {"eps": v.ln_eps}
    text: Dict[str, Any] = {
        "context_length": t.context_length, "vocab_size": t.vocab_size,
        "width": t.width, "heads": t.heads, "layers": t.layers,
    }
    if t.mlp_ratio != 4.0:
        text["mlp_ratio"] = t.mlp_ratio
    if t.pool_type != "argmax":
        text["pool_type"] = t.pool_type
    if t.no_causal_mask:
        text["no_causal_mask"] = True
    if t.ln_eps != 1e-5:
        text["norm_kwargs"] = {"eps": t.ln_eps}
    d: Dict[str, Any] = {"embed_dim": cfg.embed_dim,
                         "vision_cfg": vision, "text_cfg": text}
    if cfg.quick_gelu:
        d["quick_gelu"] = True
    if cfg.init_logit_scale != 2.6592:
        d["init_logit_scale"] = cfg.init_logit_scale
    return d


def generate_readme(model_card: Dict[str, Any], model_name: str) -> str:
    """Model-card markdown: YAML front matter, then details, usage,
    comparison and citation sections where the card has them."""
    card = dict(model_card)
    tags = card.pop("tags", ("clip",))
    pipeline_tag = card.pop("pipeline_tag",
                            "zero-shot-image-classification")
    out = ["---"]
    if tags:
        out.append("tags:")
        out += [f"- {t}" for t in tags]
    out.append("library_name: open_clip")
    out.append(f"pipeline_tag: {pipeline_tag}")
    out.append(f"license: {card.get('license', 'mit')}")
    details = card.get("details", {})
    if "Dataset" in details:
        out.append("datasets:")
        out.append(f"- {details['Dataset'].lower()}")
    out.append("---")
    out.append(f"# Model card for {model_name}")
    if "description" in card:
        out += ["", card["description"]]
    if details:
        out += ["", "## Model Details"]
        for k, v in details.items():
            if isinstance(v, (list, tuple)):
                out.append(f"- **{k}:**")
                out += [f"  - {vi}" for vi in v]
            elif isinstance(v, dict):
                out.append(f"- **{k}:**")
                out += [f"  - {ki}: {vi}" for ki, vi in v.items()]
            else:
                out.append(f"- **{k}:** {v}")
    if "usage" in card:
        out += ["", "## Model Usage", card["usage"]]
    if "comparison" in card:
        out += ["", "## Model Comparison", card["comparison"]]
    if "citation" in card:
        cits = card["citation"]
        if not isinstance(cits, (list, tuple)):
            cits = [cits]
        out += ["", "## Citation"]
        for c in cits:
            out += ["```bibtex", c.strip(), "```"]
    return "\n".join(out) + "\n"


def save_for_hub(sd: Mapping[str, torch.Tensor], cfg: CLIPConfig,
                 save_directory: str,
                 model_card: Optional[Dict[str, Any]] = None,
                 model_name: Optional[str] = None) -> str:
    """Write the hub directory from the port's state_dict `sd`: weights,
    `open_clip_config.json` and `README.md`.  Returns the directory."""
    os.makedirs(save_directory, exist_ok=True)
    save_state_dict(params_to_openclip(sd, cfg), save_directory, "openclip")
    hub_cfg = {"model_cfg": config_to_open_clip_dict(cfg),
               "preprocess_cfg": {"mean": list(OPENAI_DATASET_MEAN),
                                  "std": list(OPENAI_DATASET_STD)}}
    with open(os.path.join(save_directory, "open_clip_config.json"),
              "w") as f:
        json.dump(hub_cfg, f, indent=2)
    with open(os.path.join(save_directory, "README.md"), "w") as f:
        f.write(generate_readme(model_card or {}, model_name or cfg.name))
    return save_directory


def push_to_hf_hub(sd: Mapping[str, torch.Tensor], cfg: CLIPConfig,
                   repo_id: str, model_card: Optional[Dict[str, Any]] = None,
                   commit_message: str = "Add model", private: bool = False,
                   local_dir: Optional[str] = None,
                   local_dir_only: bool = False) -> str:
    """Write the hub layout, then upload it unless `local_dir_only`;
    returns the directory."""
    tmp = local_dir or tempfile.mkdtemp(prefix="leaf_tpu_hub_")
    save_for_hub(sd, cfg, tmp, model_card=model_card,
                 model_name=repo_id.split("/")[-1])
    if local_dir_only:
        LOG.info("wrote hub layout to %s (push skipped)", tmp)
        return tmp
    try:
        from huggingface_hub import create_repo, upload_folder
    except ImportError as e:
        raise RuntimeError(
            f"huggingface_hub unavailable ({e}); rerun with "
            f"--local-dir-only and upload {tmp} manually") from e
    create_repo(repo_id, private=private, exist_ok=True)
    upload_folder(repo_id=repo_id, folder_path=tmp,
                  commit_message=commit_message)
    LOG.info("pushed %s to %s", tmp, repo_id)
    return tmp


def main(argv=None) -> str:
    p = argparse.ArgumentParser("leaf_tpu_torch push-to-hub")
    p.add_argument("--model", required=True, help="registry name")
    p.add_argument("--input", required=True, help="checkpoint file/dir")
    p.add_argument("--repo-id", required=True)
    p.add_argument("--local-dir", default=None,
                   help="write the hub layout here instead of a tmpdir")
    p.add_argument("--local-dir-only", action="store_true",
                   help="skip the network push")
    p.add_argument("--private", action="store_true")
    p.add_argument("--license", default="mit")
    p.add_argument("--description", default=None)
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    from leaf_tpu_torch.models.interop import load_pretrained
    cfg = get_model_config(args.model)
    sd = load_pretrained(args.input, cfg)
    card: Dict[str, Any] = {"license": args.license}
    if args.description:
        card["description"] = args.description
    out = push_to_hf_hub(sd, cfg, args.repo_id, model_card=card,
                         private=args.private, local_dir=args.local_dir,
                         local_dir_only=args.local_dir_only)
    print(out)
    return out


if __name__ == "__main__":
    main()
