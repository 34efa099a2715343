"""Ahead-of-time export of both encoders (port of
`leaf_tpu/models/export.py`, with `torch.export` in place of
`jax.export`).

`trace_model` traces the text and the image encoder at fixed shapes
(tokens `[batch, context_length]` int32; normalised images `[batch,
size, size, 3]` in the model's dtype), with L2 normalisation baked in or
not, as the JAX package bakes it.  The packed attention block and the
LayerNorm are traced as the custom ops `torch.ops.leaf_tpu_torch.*`
(`ops.packed_attention.dispatcher`), so the graph holds one node per op
and never the plain versions or a ctypes call: on a card the loaded
artifact launches the hand kernels, on the CPU it runs the plain
versions.  Each artifact holds its tower's weights only.

`save_exported` writes `<tag>.text.pt2` and `<tag>.image.pt2`
(`torch.export.save`); loading one needs `import leaf_tpu_torch.ops`
(which `load_exported` does) and none of the model code.
"""
from __future__ import annotations

import os
from typing import Tuple

import torch
from torch import nn

from leaf_tpu_torch.ops import packed_attention as ops


class _TextEncoder(nn.Module):
    def __init__(self, text: nn.Module, normalize: bool):
        super().__init__()
        self.text, self.normalize = text, normalize

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.text.encode_text(tokens, self.normalize)


class _ImageEncoder(nn.Module):
    def __init__(self, visual: nn.Module, normalize: bool):
        super().__init__()
        self.visual, self.normalize = visual, normalize

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.visual.encode_image(images, self.normalize)


def trace_model(model, batch_size: int = 1, normalize: bool = False
                ) -> Tuple[torch.export.ExportedProgram,
                           torch.export.ExportedProgram]:
    """(exported text encoder, exported image encoder) of the port's
    `CLIPModel` `model`, on its device, at a fixed batch size."""
    cfg, module = model.cfg, model.module
    tokens = torch.zeros((batch_size, cfg.text.context_length),
                         dtype=torch.int32, device=model.device)
    tokens[:, 0], tokens[:, 1] = 49406, 49407
    size = cfg.vision.image_size
    images = torch.zeros((batch_size, size, size, 3),
                         dtype=module.visual.dtype, device=model.device)
    with torch.no_grad(), ops.dispatcher():
        text = torch.export.export(_TextEncoder(module.text, normalize).eval(),
                                   (tokens,))
        image = torch.export.export(
            _ImageEncoder(module.visual, normalize).eval(), (images,))
    return text, image


def save_exported(exported: torch.export.ExportedProgram, path: str) -> None:
    torch.export.save(exported, path)


def load_exported(path: str) -> torch.export.ExportedProgram:
    import leaf_tpu_torch.ops  # noqa: F401  (registers the custom ops)
    return torch.export.load(path)


def export_model(model, output_dir: str, batch_size: int = 1,
                 normalize: bool = False) -> Tuple[str, str]:
    """Write both encoders to `output_dir`; returns the two paths."""
    os.makedirs(output_dir, exist_ok=True)
    text, image = trace_model(model, batch_size, normalize)
    # hub model names carry '/' and ':'
    tag = model.cfg.name.replace("/", "-").replace(":", "-")
    text_path = os.path.join(output_dir, f"{tag}.text.pt2")
    image_path = os.path.join(output_dir, f"{tag}.image.pt2")
    save_exported(text, text_path)
    save_exported(image, image_path)
    return text_path, image_path
