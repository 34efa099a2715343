"""Registry of the timm trunk families (port of `leaf_tpu/models/trunks.py`).

A family module defines frozen spec dataclasses (they ride on
`CLIPConfig.trunk`) and registers `(spec_cls, build, from_timm, match)`:
`build(spec)` gives the vision tower's `nn.Module` (its `init_weights`
draws the seeded init, its `encode_image` maps NHWC images to features),
`from_timm` maps a timm/OpenCLIP state dict to the JAX package's pytree
(carried to the port by `interop.params_from_jax`), and `match` resolves
an OpenCLIP `timm_model_name` to a spec, or to None for the ViT mapping of
`models/timm_vision.py`.

The port's families are those of the JAX package: MobileCLIP's
(`models/mci.py`), EVA's (`models/eva.py`), ViTamin's
(`models/vitamin.py`), Swin's (`models/swin.py`) and RelPos-ViT's
(`models/relpos_vit.py`).  ConvNeXt is no trunk family but a config field
of its own (`CLIPConfig.convnext`, `models/convnext.py`), as in the JAX
package: its names resolve to None here.
"""
from __future__ import annotations

from typing import Callable, Optional

_FAMILIES = []          # (spec_cls, build_fn, from_timm_fn)
_MATCHERS = []          # fn(name, embed_dim, image_size, pool, proj) -> spec|None

def register_trunk(spec_cls, build_fn: Callable,
                   from_timm_fn: Optional[Callable] = None,
                   match_fn: Optional[Callable] = None) -> None:
    _FAMILIES.append((spec_cls, build_fn, from_timm_fn))
    if match_fn is not None:
        _MATCHERS.append(match_fn)


def _load_families() -> None:
    # importing a family's module registers it
    import leaf_tpu_torch.models.eva  # noqa: F401
    import leaf_tpu_torch.models.mci  # noqa: F401
    import leaf_tpu_torch.models.relpos_vit  # noqa: F401
    import leaf_tpu_torch.models.swin  # noqa: F401
    import leaf_tpu_torch.models.vitamin  # noqa: F401


def spec_for_timm_name(name: str, embed_dim: int,
                       image_size: Optional[int] = None,
                       pool: str = "", proj: str = "linear"):
    """Resolve an OpenCLIP `timm_model_name` to a family spec, or None
    when it is a ViT for `models/timm_vision.py` or a ConvNeXt."""
    _load_families()
    for match in _MATCHERS:
        spec = match(name, embed_dim, image_size=image_size, pool=pool,
                     proj=proj)
        if spec is not None:
            return spec
    return None


def _family(spec):
    _load_families()
    for fam in _FAMILIES:
        if isinstance(spec, fam[0]):
            return fam
    raise TypeError(f"no registered trunk family for spec {type(spec)!r}")


def build(spec):
    """The vision tower module of `spec`, zero-initialised."""
    return _family(spec)[1](spec)


def from_timm(sd, spec, trunk_prefix: str = "visual.trunk.",
              head_prefix: str = "visual.head."):
    """timm/OpenCLIP state dict -> the JAX package's pytree of the trunk."""
    fn = _family(spec)[2]
    if fn is None:
        raise NotImplementedError(
            f"checkpoint ingestion not implemented for {type(spec).__name__}")
    return fn(sd, spec, trunk_prefix=trunk_prefix, head_prefix=head_prefix)
