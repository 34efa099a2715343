"""The pretrained checkpoint registry and its verified cache (port of
`leaf_tpu/models/pretrained.py`).

The registry maps (model, tag) to a URL (an OpenAI/GitHub file with a
sha256 prefix, or an `hf-hub:` repo) exactly as the JAX package's does,
the LEAF release artifacts (`LEAF-CLIP/CLIP-ViT-{L,H,g,bigG}-rho50-k1-
constrained[-FARE2]`) included; an entry may declare the activation its
weights use (`quick_gelu`), which `create_model` adopts.

Nothing here fetches by itself.  `download_pretrained_from_url` takes a
verified file from the cache (a corrupt one is removed and fetched again)
and fetches only through an injected `url_retrieve(url, target)`;
`download_pretrained_from_hf` takes a snapshot directory from the cache and
otherwise an injected `hf_download(repo_id, filename, local_dir)`, or
`huggingface_hub`'s download from its local cache only (imported inside
the function; its absence raises by name).  Neither machine this repo runs
on has the weights: `resolve_pretrained` raises `FileNotFoundError` for a
tag whose file is not in the cache.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import warnings
from typing import Callable, Dict, Optional

LOG = logging.getLogger(__name__)

DEFAULT_CACHE_DIR = os.path.expanduser("~/.cache/leaf_tpu_torch/checkpoints")

# (model, tag) → {url, sha256 prefix}.  URLs follow the upstream
# open_clip/LAION hosting scheme; LEAF release artifacts are HF repos.
_OPENAI_BASE = "https://openaipublic.azureedge.net/clip/models/"

_PRETRAINED: Dict[str, Dict[str, Dict[str, str]]] = {
    "RN50": {
        "openai": dict(
            url=_OPENAI_BASE + "afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3"
                "b6c78a7b63bc04b6762/RN50.pt",
            sha256="afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63b"),
        "yfcc15m": dict(
            url="https://github.com/mlfoundations/open_clip/releases/"
                "download/v0.2-weights/rn50-quickgelu-yfcc15m-455df137.pt",
            sha256="455df137"),
        "cc12m": dict(
            url="https://github.com/mlfoundations/open_clip/releases/"
                "download/v0.2-weights/rn50-quickgelu-cc12m-f000538c.pt",
            sha256="f000538c"),
    },
    "RN101": {
        "openai": dict(
            url=_OPENAI_BASE + "8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a4"
                "70a72f30b0d94fab599/RN101.pt",
            sha256="8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d"),
        "yfcc15m": dict(
            url="https://github.com/mlfoundations/open_clip/releases/"
                "download/v0.2-weights/rn101-quickgelu-yfcc15m-3e04b30e.pt",
            sha256="3e04b30e"),
    },
    "RN50x4": {
        "openai": dict(
            url=_OPENAI_BASE + "7e526bd135e493cef0776de27d5f42653e6b4c8bf9e0f"
                "653bb11773263205fdd/RN50x4.pt",
            sha256="7e526bd135e493cef0776de27d5f42653e6b4c8bf9e0f653bb117732"),
    },
    "ViT-B-32": {
        "openai": dict(
            url=_OPENAI_BASE + "40d365715913c9da98579312b702a82c18be219cc2a73"
                "407c4526f58eba950af/ViT-B-32.pt",
            sha256="40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58"),
        "laion2b_s34b_b79k": dict(
            url="hf-hub:laion/CLIP-ViT-B-32-laion2B-s34B-b79K", sha256=""),
        "laion2b": dict(
            url="hf-hub:laion/CLIP-ViT-B-32-laion2B-s34B-b79K", sha256=""),
        "datacomp_xl_s13b_b90k": dict(
            url="hf-hub:laion/CLIP-ViT-B-32-DataComp.XL-s13B-b90K",
            sha256=""),
    },
    "ViT-B-16": {
        "openai": dict(
            url=_OPENAI_BASE + "5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9"
                "e85e4ecb61988df416f/ViT-B-16.pt",
            sha256="5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb619"),
        "laion2b": dict(
            url="hf-hub:laion/CLIP-ViT-B-16-laion2B-s34B-b88K", sha256=""),
    },
    "ViT-L-14": {
        "openai": dict(
            url=_OPENAI_BASE + "b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6"
                "f7c2e0eca1737a03836/ViT-L-14.pt",
            sha256="b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6f7c2e0eca17"),
        "laion2b": dict(
            url="hf-hub:laion/CLIP-ViT-L-14-laion2B-s32B-b82K", sha256=""),
        "datacomp_xl_s13b_b90k": dict(
            url="hf-hub:laion/CLIP-ViT-L-14-DataComp.XL-s13B-b90K",
            sha256=""),
        # FARE2 (robust image tower, LEAF's init) and the released LEAF
        # text towers (`README.md:27-63`, eval_utils.py:25-59)
        "fare2": dict(url="hf-hub:chs20/fare2-clip", sha256=""),
        "leaf": dict(
            url="hf-hub:LEAF-CLIP/CLIP-ViT-L-rho50-k1-constrained-FARE2",
            sha256=""),
        "leaf_clean": dict(
            url="hf-hub:LEAF-CLIP/CLIP-ViT-L-rho50-k1-constrained",
            sha256=""),
    },
    "ViT-H-14": {
        "laion2b": dict(
            url="hf-hub:laion/CLIP-ViT-H-14-laion2B-s32B-b79K", sha256=""),
        "laion2b_s32b_b79k": dict(
            url="hf-hub:laion/CLIP-ViT-H-14-laion2B-s32B-b79K", sha256=""),
        "fare2": dict(url="hf-hub:chs20/fare2-clip-vit-h", sha256=""),
        "leaf": dict(
            url="hf-hub:LEAF-CLIP/CLIP-ViT-H-rho50-k1-constrained-FARE2",
            sha256=""),
    },
    "ViT-g-14": {
        "laion2b": dict(
            url="hf-hub:laion/CLIP-ViT-g-14-laion2B-s12B-b42K", sha256=""),
        "laion2b_s12b_b42k": dict(
            url="hf-hub:laion/CLIP-ViT-g-14-laion2B-s12B-b42K", sha256=""),
        "leaf": dict(
            url="hf-hub:LEAF-CLIP/CLIP-ViT-g-rho50-k1-constrained-FARE2",
            sha256=""),
    },
    "ViT-bigG-14": {
        "laion2b": dict(
            url="hf-hub:laion/CLIP-ViT-bigG-14-laion2B-39B-b160k", sha256=""),
        "laion2b_s39b_b160k": dict(
            url="hf-hub:laion/CLIP-ViT-bigG-14-laion2B-39B-b160k", sha256=""),
        "leaf": dict(
            url="hf-hub:LEAF-CLIP/CLIP-ViT-bigG-rho50-k1-constrained-FARE2",
            sha256=""),
    },
}

# quickgelu aliases get a COPY of their base model's sources (OpenAI-
# pretrained towers ARE quickgelu; reference `pretrained.py` lists them
# separately) — copies, because metaclip/dfn tags below attach only to
# the quickgelu names
for _base in ("RN50", "RN101", "ViT-B-32", "ViT-B-16", "ViT-L-14"):
    _PRETRAINED.setdefault(_base + "-quickgelu", dict(_PRETRAINED[_base]))


def _hub(repo: str) -> Dict[str, str]:
    return dict(url="hf-hub:" + repo, sha256="")


_GH_W = ("https://github.com/mlfoundations/open_clip/releases/download/"
         "v0.2-weights/")
_METACLIP = "https://dl.fbaipublicfiles.com/MMPT/metaclip/"

# Registry breadth (reference `pretrained.py:83-330`): laion400m /
# datacomp / commonpool / metaclip / dfn / webli-SigLIP / convnext /
# coca tags.  metaclip + dfn checkpoints are QuickGELU models and hang
# off the -quickgelu names, exactly as in the reference.
_EXTRA_TAGS = {
    "ViT-B-32": dict(
        # the laion400m B-32 weights are QuickGELU (see the filename);
        # the reference lists them under the plain name too
        # (`pretrained.py:132-135`), which silently loads them into the
        # GELU config.  Here the registry entry *declares* the
        # activation and `create_model` adopts it with a warning
        # (factory activation reconciliation), so name parity is kept
        # without the footgun.
        laion400m_e31=dict(url=_GH_W + "vit_b_32-quickgelu-laion400m_e31-"
                           "d867053b.pt", sha256="d867053b",
                           quick_gelu=True),
        laion400m_e32=dict(url=_GH_W + "vit_b_32-quickgelu-laion400m_e32-"
                           "46683a32.pt", sha256="46683a32",
                           quick_gelu=True),
        laion2b_e16=dict(url=_GH_W + "vit_b_32-laion2b_e16-af8dbd0c.pth",
                         sha256="af8dbd0c"),
        datacomp_m_s128m_b4k=_hub("laion/CLIP-ViT-B-32-DataComp.M-s128M-b4K"),
        datacomp_s_s13m_b4k=_hub("laion/CLIP-ViT-B-32-DataComp.S-s13M-b4K"),
        commonpool_m_clip_s128m_b4k=_hub(
            "laion/CLIP-ViT-B-32-CommonPool.M.clip-s128M-b4K"),
        commonpool_m_laion_s128m_b4k=_hub(
            "laion/CLIP-ViT-B-32-CommonPool.M.laion-s128M-b4K"),
        commonpool_m_image_s128m_b4k=_hub(
            "laion/CLIP-ViT-B-32-CommonPool.M.image-s128M-b4K"),
        commonpool_m_text_s128m_b4k=_hub(
            "laion/CLIP-ViT-B-32-CommonPool.M.text-s128M-b4K"),
        commonpool_m_basic_s128m_b4k=_hub(
            "laion/CLIP-ViT-B-32-CommonPool.M.basic-s128M-b4K"),
        commonpool_m_s128m_b4k=_hub(
            "laion/CLIP-ViT-B-32-CommonPool.M-s128M-b4K"),
        commonpool_s_clip_s13m_b4k=_hub(
            "laion/CLIP-ViT-B-32-CommonPool.S.clip-s13M-b4K"),
        commonpool_s_laion_s13m_b4k=_hub(
            "laion/CLIP-ViT-B-32-CommonPool.S.laion-s13M-b4K"),
        commonpool_s_image_s13m_b4k=_hub(
            "laion/CLIP-ViT-B-32-CommonPool.S.image-s13M-b4K"),
        commonpool_s_text_s13m_b4k=_hub(
            "laion/CLIP-ViT-B-32-CommonPool.S.text-s13M-b4K"),
        commonpool_s_basic_s13m_b4k=_hub(
            "laion/CLIP-ViT-B-32-CommonPool.S.basic-s13M-b4K"),
        commonpool_s_s13m_b4k=_hub(
            "laion/CLIP-ViT-B-32-CommonPool.S-s13M-b4K"),
    ),
    "RN50x16": dict(
        openai=dict(
            url=_OPENAI_BASE + "52378b407f34354e150460fe41077663dd5b39c54cd0"
                "bfd2b27167a4a06ec9aa/RN50x16.pt",
            sha256="52378b407f34354e150460fe41077663dd5b39c54cd0bfd2b27167a4"),
    ),
    "RN50x64": dict(
        openai=dict(
            url=_OPENAI_BASE + "be1cfb55d75a9666199fb2206c106743da0f6468c9d3"
                "27f3e0d0a543a9919d9c/RN50x64.pt",
            sha256="be1cfb55d75a9666199fb2206c106743da0f6468c9d327f3e0d0a543"),
    ),
    "ViT-L-14-336": dict(
        openai=dict(
            url=_OPENAI_BASE + "3035c92b350959924f9f00213499208652fc7ea05064"
                "3e8b385c2dac08641f02/ViT-L-14-336px.pt",
            sha256="3035c92b350959924f9f00213499208652fc7ea050643e8b385c2dac"),
    ),
    "ViT-B-32-quickgelu": dict(
        # the laion400m B-32 weights are QuickGELU (see the filename);
        # the reference lists them under BOTH names, but loading them
        # into the GELU config is exactly the silent-activation footgun
        # this repo removes, so only the -quickgelu name carries them
        laion400m_e31=dict(url=_GH_W + "vit_b_32-quickgelu-laion400m_e31-"
                           "d867053b.pt", sha256="d867053b"),
        laion400m_e32=dict(url=_GH_W + "vit_b_32-quickgelu-laion400m_e32-"
                           "46683a32.pt", sha256="46683a32"),
        metaclip_400m=dict(url=_METACLIP + "b32_400m.pt", sha256=""),
        metaclip_fullcc=dict(url=_METACLIP + "b32_fullcc2.5b.pt",
                             sha256=""),
    ),
    "ViT-B-32-256": dict(
        datacomp_s34b_b86k=_hub(
            "laion/CLIP-ViT-B-32-256x256-DataComp-s34B-b86K"),
    ),
    "ViT-B-16": dict(
        laion400m_e31=dict(url=_GH_W + "vit_b_16-laion400m_e31-00efa78f.pt",
                           sha256="00efa78f"),
        laion400m_e32=dict(url=_GH_W + "vit_b_16-laion400m_e32-55e67d44.pt",
                           sha256="55e67d44"),
        datacomp_xl_s13b_b90k=_hub(
            "laion/CLIP-ViT-B-16-DataComp.XL-s13B-b90K"),
        datacomp_l_s1b_b8k=_hub("laion/CLIP-ViT-B-16-DataComp.L-s1B-b8K"),
        laion2b_s34b_b88k=_hub("laion/CLIP-ViT-B-16-laion2B-s34B-b88K"),
        commonpool_l_clip_s1b_b8k=_hub(
            "laion/CLIP-ViT-B-16-CommonPool.L.clip-s1B-b8K"),
        commonpool_l_laion_s1b_b8k=_hub(
            "laion/CLIP-ViT-B-16-CommonPool.L.laion-s1B-b8K"),
        commonpool_l_image_s1b_b8k=_hub(
            "laion/CLIP-ViT-B-16-CommonPool.L.image-s1B-b8K"),
        commonpool_l_text_s1b_b8k=_hub(
            "laion/CLIP-ViT-B-16-CommonPool.L.text-s1B-b8K"),
        commonpool_l_basic_s1b_b8k=_hub(
            "laion/CLIP-ViT-B-16-CommonPool.L.basic-s1B-b8K"),
        commonpool_l_s1b_b8k=_hub(
            "laion/CLIP-ViT-B-16-CommonPool.L-s1B-b8K"),
        dfn2b=_hub("apple/DFN2B-CLIP-ViT-B-16"),
    ),
    "ViT-B-16-quickgelu": dict(
        metaclip_400m=dict(url=_METACLIP + "b16_400m.pt", sha256=""),
        metaclip_fullcc=dict(url=_METACLIP + "b16_fullcc2.5b.pt",
                             sha256=""),
        # the reference registers B-16 dfn2b only under the plain GELU
        # name (its own inconsistency — L-14 dfn2b hangs off
        # -quickgelu); registered under BOTH here, and the factory's
        # checkpoint-activation reconciliation corrects the plain-name
        # load from the hub config either way
        dfn2b=_hub("apple/DFN2B-CLIP-ViT-B-16"),
    ),
    "ViT-B-16-plus-240": dict(
        laion400m_e31=dict(url=_GH_W + "vit_b_16_plus_240-laion400m_e31-"
                           "8fb26589.pt", sha256="8fb26589"),
        laion400m_e32=dict(url=_GH_W + "vit_b_16_plus_240-laion400m_e32-"
                           "699c4b84.pt", sha256="699c4b84"),
    ),
    "ViT-L-14": dict(
        laion400m_e31=dict(url=_GH_W + "vit_l_14-laion400m_e31-69988bb6.pt",
                           sha256="69988bb6"),
        laion400m_e32=dict(url=_GH_W + "vit_l_14-laion400m_e32-3d133497.pt",
                           sha256="3d133497"),
        commonpool_xl_clip_s13b_b90k=_hub(
            "laion/CLIP-ViT-L-14-CommonPool.XL.clip-s13B-b90K"),
        # hub snapshot's open_clip_config.json carries the Inception
        # (0.5,0.5,0.5) preprocess stats this checkpoint trained with;
        # the factory adopts them from the snapshot (factory.py)
        laion2b_s32b_b82k=_hub("laion/CLIP-ViT-L-14-laion2B-s32B-b82K"),
        commonpool_xl_laion_s13b_b90k=_hub(
            "laion/CLIP-ViT-L-14-CommonPool.XL.laion-s13B-b90K"),
        commonpool_xl_s13b_b90k=_hub(
            "laion/CLIP-ViT-L-14-CommonPool.XL-s13B-b90K"),
    ),
    "ViT-L-14-quickgelu": dict(
        metaclip_400m=dict(url=_METACLIP + "l14_400m.pt", sha256=""),
        metaclip_fullcc=dict(url=_METACLIP + "l14_fullcc2.5b.pt",
                             sha256=""),
        dfn2b=_hub("apple/DFN2B-CLIP-ViT-L-14"),
    ),
    "ViT-H-14-quickgelu": dict(
        metaclip_fullcc=dict(url=_METACLIP + "h14_fullcc2.5b.pt",
                             sha256=""),
        dfn5b=_hub("apple/DFN5B-CLIP-ViT-H-14"),
    ),
    "ViT-H-14-378-quickgelu": dict(
        dfn5b=_hub("apple/DFN5B-CLIP-ViT-H-14-378"),
    ),
    "ViT-g-14": dict(
        laion2b_s34b_b88k=_hub("laion/CLIP-ViT-g-14-laion2B-s34B-b88K"),
    ),
    # MobileCLIP (reference pretrained.py:455-464; mean/std (0,0,0)/
    # (1,1,1) ride on the model configs, config.py)
    "MobileCLIP-B": dict(
        datacompdr=_hub("apple/MobileCLIP-B-OpenCLIP"),
        datacompdr_lt=_hub("apple/MobileCLIP-B-LT-OpenCLIP"),
    ),
    "MobileCLIP-S1": dict(datacompdr=_hub("apple/MobileCLIP-S1-OpenCLIP")),
    "MobileCLIP-S2": dict(datacompdr=_hub("apple/MobileCLIP-S2-OpenCLIP")),
    "ViT-B-16-SigLIP": dict(webli=_hub("timm/ViT-B-16-SigLIP")),
    "ViT-B-16-SigLIP-256": dict(webli=_hub("timm/ViT-B-16-SigLIP-256")),
    "ViT-B-16-SigLIP-384": dict(webli=_hub("timm/ViT-B-16-SigLIP-384")),
    "ViT-B-16-SigLIP-512": dict(webli=_hub("timm/ViT-B-16-SigLIP-512")),
    "ViT-B-16-SigLIP-i18n-256": dict(
        webli=_hub("timm/ViT-B-16-SigLIP-i18n-256")),
    "ViT-L-16-SigLIP-256": dict(webli=_hub("timm/ViT-L-16-SigLIP-256")),
    "ViT-L-16-SigLIP-384": dict(webli=_hub("timm/ViT-L-16-SigLIP-384")),
    "ViT-SO400M-14-SigLIP": dict(webli=_hub("timm/ViT-SO400M-14-SigLIP")),
    "ViT-SO400M-14-SigLIP-384": dict(
        webli=_hub("timm/ViT-SO400M-14-SigLIP-384")),
    "roberta-ViT-B-32": dict(
        laion2b_s12b_b32k=_hub(
            "laion/CLIP-ViT-B-32-roberta-base-laion2B-s12B-b32k")),
    "xlm-roberta-base-ViT-B-32": dict(
        laion5b_s13b_b90k=_hub(
            "laion/CLIP-ViT-B-32-xlm-roberta-base-laion5B-s13B-b90k")),
    "xlm-roberta-large-ViT-H-14": dict(
        frozen_laion5b_s13b_b90k=_hub(
            "laion/CLIP-ViT-H-14-frozen-xlm-roberta-large-laion5B-"
            "s13B-b90k")),
    "convnext_base": dict(
        laion400m_s13b_b51k=_hub(
            "laion/CLIP-convnext_base-laion400M-s13B-b51K")),
    "convnext_base_w": dict(
        laion2b_s13b_b82k=_hub(
            "laion/CLIP-convnext_base_w-laion2B-s13B-b82K"),
        laion2b_s13b_b82k_augreg=_hub(
            "laion/CLIP-convnext_base_w-laion2B-s13B-b82K-augreg"),
        laion_aesthetic_s13b_b82k=_hub(
            "laion/CLIP-convnext_base_w-laion_aesthetic-s13B-b82K"),
    ),
    "convnext_base_w_320": dict(
        laion_aesthetic_s13b_b82k=_hub(
            "laion/CLIP-convnext_base_w_320-laion_aesthetic-s13B-b82K"),
        laion_aesthetic_s13b_b82k_augreg=_hub(
            "laion/CLIP-convnext_base_w_320-laion_aesthetic-s13B-b82K-"
            "augreg"),
    ),
    "convnext_large_d": dict(
        laion2b_s26b_b102k_augreg=_hub(
            "laion/CLIP-convnext_large_d.laion2B-s26B-b102K-augreg"),
    ),
    "convnext_large_d_320": dict(
        laion2b_s29b_b131k_ft=_hub(
            "laion/CLIP-convnext_large_d_320.laion2B-s29B-b131K-ft"),
        laion2b_s29b_b131k_ft_soup=_hub(
            "laion/CLIP-convnext_large_d_320.laion2B-s29B-b131K-ft-soup"),
    ),
    "convnext_xxlarge": dict(
        laion2b_s34b_b82k_augreg=_hub(
            "laion/CLIP-convnext_xxlarge-laion2B-s34B-b82K-augreg"),
        laion2b_s34b_b82k_augreg_rewind=_hub(
            "laion/CLIP-convnext_xxlarge-laion2B-s34B-b82K-augreg-rewind"),
        laion2b_s34b_b82k_augreg_soup=_hub(
            "laion/CLIP-convnext_xxlarge-laion2B-s34B-b82K-augreg-soup"),
    ),
    "coca_ViT-B-32": dict(
        laion2b_s13b_b90k=_hub("laion/CoCa-ViT-B-32-laion2B-s13B-b90k"),
        mscoco_finetuned_laion2b_s13b_b90k=_hub(
            "laion/mscoco_finetuned_CoCa-ViT-B-32-laion2B-s13B-b90k"),
    ),
    "coca_ViT-L-14": dict(
        laion2b_s13b_b90k=_hub("laion/CoCa-ViT-L-14-laion2B-s13B-b90k"),
        mscoco_finetuned_laion2b_s13b_b90k=_hub(
            "laion/mscoco_finetuned_CoCa-ViT-L-14-laion2B-s13B-b90k"),
    ),
    # EVA (reference pretrained.py:364-380; timm-hosted)
    "EVA01-g-14": dict(laion400m_s11b_b41k=_hub(
        "timm/eva_giant_patch14_clip_224.laion400m_s11b_b41k")),
    "EVA01-g-14-plus": dict(merged2b_s11b_b114k=_hub(
        "timm/eva_giant_patch14_plus_clip_224.merged2b_s11b_b114k")),
    "EVA02-B-16": dict(merged2b_s8b_b131k=_hub(
        "timm/eva02_base_patch16_clip_224.merged2b_s8b_b131k")),
    "EVA02-L-14": dict(merged2b_s4b_b131k=_hub(
        "timm/eva02_large_patch14_clip_224.merged2b_s4b_b131k")),
    "EVA02-L-14-336": dict(merged2b_s6b_b61k=_hub(
        "timm/eva02_large_patch14_clip_336.merged2b_s6b_b61k")),
    "EVA02-E-14": dict(laion2b_s4b_b115k=_hub(
        "timm/eva02_enormous_patch14_clip_224.laion2b_s4b_b115k")),
    "EVA02-E-14-plus": dict(laion2b_s9b_b144k=_hub(
        "timm/eva02_enormous_patch14_plus_clip_224.laion2b_s9b_b144k")),
    # CLIPA (reference pretrained.py:421-439)
    "ViT-L-14-CLIPA": dict(
        datacomp1b=_hub("UCSC-VLAA/ViT-L-14-CLIPA-datacomp1B")),
    "ViT-L-14-CLIPA-336": dict(
        datacomp1b=_hub("UCSC-VLAA/ViT-L-14-CLIPA-336-datacomp1B")),
    "ViT-H-14-CLIPA": dict(
        datacomp1b=_hub("UCSC-VLAA/ViT-H-14-CLIPA-datacomp1B")),
    "ViT-H-14-CLIPA-336": dict(
        laion2b=_hub("UCSC-VLAA/ViT-H-14-CLIPA-336-laion2B"),
        datacomp1b=_hub("UCSC-VLAA/ViT-H-14-CLIPA-336-datacomp1B"),
    ),
    "ViT-bigG-14-CLIPA": dict(
        datacomp1b=_hub("UCSC-VLAA/ViT-bigG-14-CLIPA-datacomp1B")),
    "ViT-bigG-14-CLIPA-336": dict(
        datacomp1b=_hub("UCSC-VLAA/ViT-bigG-14-CLIPA-336-datacomp1B")),
    # nllb-clip (reference pretrained.py:441-464)
    "nllb-clip-base": dict(v1=_hub("visheratin/nllb-clip-base-oc")),
    "nllb-clip-large": dict(v1=_hub("visheratin/nllb-clip-large-oc")),
    "nllb-clip-base-siglip": dict(
        v1=_hub("visheratin/nllb-clip-base-siglip"),
        mrl=_hub("visheratin/nllb-siglip-mrl-base"),
    ),
    "nllb-clip-large-siglip": dict(
        v1=_hub("visheratin/nllb-clip-large-siglip"),
        mrl=_hub("visheratin/nllb-siglip-mrl-large"),
    ),
    # ViTamin (reference pretrained.py:466-517; repos name the exact
    # weight file — the 3-component hf-hub form)
    **{f"ViTamin-{v}": dict(datacomp1b=_hub(
        f"jienengchen/ViTamin-{r}/pytorch_model.bin"))
       for v, r in [("S", "S"), ("S-LTT", "S-LTT"), ("B", "B"),
                    ("B-LTT", "B-LTT"), ("L", "L-224px"),
                    ("L-256", "L-256px"), ("L-336", "L-336px"),
                    ("L-384", "L-384px"), ("L2", "L2-224px"),
                    ("L2-256", "L2-256px"), ("L2-336", "L2-336px"),
                    ("L2-384", "L2-384px"), ("XL-256", "XL-256px"),
                    ("XL-336", "XL-336px"), ("XL-384", "XL-384px")]},
}
for _model, _tags in _EXTRA_TAGS.items():
    _PRETRAINED.setdefault(_model, {}).update(_tags)


def list_pretrained():
    return [(m, t) for m, tags in _PRETRAINED.items() for t in tags]


def get_pretrained_cfg(model: str, tag: str) -> Dict[str, str]:
    return dict(_PRETRAINED.get(model, {}).get(tag, {}))


def get_pretrained_url(model: str, tag: str) -> str:
    return get_pretrained_cfg(model, tag).get("url", "")


def check_sha256(path: str, expected_prefix: str) -> bool:
    if not expected_prefix:
        return True
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest().startswith(expected_prefix)


def download_pretrained_from_url(
    url: str,
    cache_dir: Optional[str] = None,
    expected_sha256: Optional[str] = None,
    url_retrieve: Optional[Callable[[str, str], None]] = None,
) -> str:
    """The cached checkpoint of `url`, verified by its sha256 prefix.

    A cached file whose hash matches (and which is not empty) is returned;
    one that does not is removed and fetched again; a fetched file that
    still does not match raises.  Fetching goes through `url_retrieve(url,
    target)`, which the caller injects; without it a file missing from
    the cache raises `FileNotFoundError`."""
    cache_dir = cache_dir or DEFAULT_CACHE_DIR
    os.makedirs(cache_dir, exist_ok=True)
    filename = os.path.basename(url)
    if expected_sha256 is None:
        # OpenAI-style URLs carry the hash: .../<sha>/<file>
        parts = url.split("/")
        expected_sha256 = parts[-2] if len(parts) > 2 and len(parts[-2]) >= 40 \
            else ""
    target = os.path.join(cache_dir, filename)

    if os.path.exists(target):
        # an entry without a hash cannot verify a cached file, but an
        # empty file is never a checkpoint
        if check_sha256(target, expected_sha256) \
                and os.path.getsize(target) > 0:
            return target
        warnings.warn(f"{target} exists but is empty or its SHA256 does "
                      "not match; re-downloading")
        os.remove(target)
    if url_retrieve is None:
        raise FileNotFoundError(
            f"{target} is not in the checkpoint cache, and no url_retrieve "
            f"was given to fetch {url}")

    # fetch to a temporary name and rename: an interrupted fetch must not
    # leave a partial file at the cache path
    tmp = target + ".download"
    try:
        url_retrieve(url, tmp)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    if not check_sha256(tmp, expected_sha256):
        os.remove(tmp)
        raise RuntimeError(
            f"checkpoint downloaded from {url} does not match its sha256")
    os.replace(tmp, target)
    return target


# checkpoint filenames probed on the hub, in preference order
HF_WEIGHT_FILES = ("open_clip_model.safetensors",
                   "open_clip_pytorch_model.bin",
                   "model.safetensors", "pytorch_model.bin")
HF_CONFIG_FILES = ("open_clip_config.json", "config.json")


def _default_hf_download(repo_id: str, filename: str, local_dir: str) -> str:
    """`huggingface_hub`'s download from its local cache only."""
    try:
        from huggingface_hub import hf_hub_download
    except ImportError as e:
        raise ImportError(
            f"hf-hub:{repo_id}: the snapshot is not in the checkpoint cache "
            "and huggingface_hub is not installed; pass hf_download") from e
    return hf_hub_download(repo_id=repo_id, filename=filename,
                           local_dir=local_dir, local_files_only=True)


def download_pretrained_from_hf(
    hf_id: str,
    cache_dir: Optional[str] = None,
    hf_download: Optional[Callable[[str, str, str], str]] = None,
    config_only: bool = False,
) -> str:
    """An `hf-hub:org/repo` id -> a local snapshot directory holding the
    checkpoint (and its config where the repo has one).

    A cache directory that already holds one of the weight files (or, with
    `config_only`, a config) is returned as it is.  Otherwise the files are
    taken through `hf_download(repo_id, filename, local_dir)`, by default
    `huggingface_hub`'s local cache.  A third path component names the
    exact weight file (`org/repo/file.bin`, the ViTamin tags)."""
    repo = hf_id[len("hf-hub:"):] if hf_id.startswith("hf-hub:") else hf_id
    repo = repo.rstrip("/")
    explicit_file = None
    if repo.count("/") == 2:
        repo, explicit_file = repo.rsplit("/", 1)
    local = os.path.join(cache_dir or DEFAULT_CACHE_DIR, "hf",
                         repo.replace("/", "--"))
    os.makedirs(local, exist_ok=True)
    if any(os.path.exists(os.path.join(local, f)) for f in HF_WEIGHT_FILES):
        return local
    if config_only and any(os.path.exists(os.path.join(local, f))
                           for f in HF_CONFIG_FILES):
        return local

    fetch = hf_download or _default_hf_download
    errors = []
    if explicit_file is not None and not config_only:
        for f in HF_CONFIG_FILES:
            try:
                fetch(repo, f, local)
                break
            except Exception as e:  # noqa: BLE001
                errors.append(e)
        fetch(repo, explicit_file, local)
        return local
    for f in HF_CONFIG_FILES:        # the config is optional but preferred
        try:
            fetch(repo, f, local)
            if config_only:
                return local
            break
        except Exception as e:  # noqa: BLE001
            errors.append(e)
    if config_only:
        raise RuntimeError(
            f"could not fetch any of {HF_CONFIG_FILES} from "
            f"hf-hub:{repo} (last errors: {errors[-2:]})")
    for f in HF_WEIGHT_FILES:
        try:
            fetch(repo, f, local)
            return local
        except Exception as e:  # noqa: BLE001
            errors.append(e)
    raise RuntimeError(
        f"could not fetch any of {HF_WEIGHT_FILES} from hf-hub:{repo} "
        f"(last errors: {errors[-2:]})")


def resolve_pretrained(model: str, tag_or_path: str,
                       cache_dir: Optional[str] = None,
                       hf_download: Optional[Callable] = None,
                       url_retrieve: Optional[Callable] = None) -> str:
    """A registry tag, `hf-hub:` id or path -> a local path.  A path that
    exists passes through, as does a tag the registry does not have.  A
    registry-declared activation is written beside the cached file
    (`<file>.open_clip_config.json`, read by
    `interop.checkpoint_quick_gelu`), so it survives the tag's resolution
    to a path before `create_model`."""
    if os.path.exists(tag_or_path):
        return tag_or_path
    if tag_or_path.startswith("hf-hub:"):
        return download_pretrained_from_hf(tag_or_path, cache_dir,
                                           hf_download)
    cfg = get_pretrained_cfg(model, tag_or_path)
    if not cfg:
        return tag_or_path
    url = cfg["url"]
    if url.startswith("hf-hub:"):
        return download_pretrained_from_hf(url, cache_dir, hf_download)
    path = download_pretrained_from_url(url, cache_dir, cfg.get("sha256"),
                                        url_retrieve)
    if cfg.get("quick_gelu") is not None:
        sidecar = path + ".open_clip_config.json"
        if not os.path.exists(sidecar):
            with open(sidecar, "w") as f:
                json.dump({"model_cfg": {"quick_gelu":
                                         bool(cfg["quick_gelu"])}}, f)
    return path
