"""Named model collections for the benchmark command line (port of
`leaf_tpu/benchmark/model_collection.py`).

A registry of (model, pretrained) lists addressable by name, and the
comma-separated file format of `model,pretrained` lines.  `openclip_all`
enumerates the pretrained registry (`models/pretrained.py`).
"""
from __future__ import annotations

import os
from typing import List, Tuple

ModelSpec = Tuple[str, str]


def _all_pretrained() -> List[ModelSpec]:
    from leaf_tpu_torch.models.pretrained import list_pretrained
    return [tuple(x) for x in list_pretrained()]


MODEL_COLLECTIONS = {
    "openclip_base": [
        ("ViT-B-32-quickgelu", "laion400m_e32"),
        ("ViT-B-32", "laion2b_s34b_b79k"),
        ("ViT-B-16", "laion400m_e32"),
        ("ViT-L-14", "laion2b_s32b_b82k"),
        ("ViT-H-14", "laion2b_s32b_b79k"),
        ("ViT-g-14", "laion2b_s12b_b42k"),
    ],
    "openai": [
        ("ViT-B-32", "openai"),
        ("ViT-B-16", "openai"),
        ("ViT-L-14", "openai"),
    ],
    # the LEAF release family
    "leaf": [
        ("ViT-L-14", "leaf"),
        ("ViT-H-14", "leaf"),
        ("ViT-g-14", "leaf"),
        ("ViT-bigG-14", "leaf"),
    ],
    "fare": [
        ("ViT-L-14", "fare2"),
    ],
}


def get_model_collection_from_file(path: str) -> List[ModelSpec]:
    """Lines of `model,pretrained`; blank lines and `#` comments skipped."""
    out: List[ModelSpec] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = [p.strip() for p in line.split(",")]
            out.append((parts[0], parts[1] if len(parts) > 1 else ""))
    return out


def expand_models(specs: List[str], default_pretrained: str = ""
                  ) -> List[ModelSpec]:
    """Each spec: a collection name, `openclip_all`, a .txt file of
    `model,pretrained` lines, a `model,pretrained` pair, or a bare model
    name (paired with `default_pretrained`)."""
    out: List[ModelSpec] = []
    for s in specs:
        if s == "openclip_all":
            out.extend(_all_pretrained())
        elif s in MODEL_COLLECTIONS:
            out.extend(MODEL_COLLECTIONS[s])
        elif os.path.isfile(s) and s.endswith(".txt"):
            out.extend(get_model_collection_from_file(s))
        elif "," in s:
            model, pretrained = s.split(",", 1)
            out.append((model.strip(), pretrained.strip()))
        else:
            out.append((s, default_pretrained))
    return out
