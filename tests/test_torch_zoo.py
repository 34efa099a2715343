"""leaf_tpu_torch's ViT-family zoo (SigLIP, CLIPA, timm ViTs) against the
JAX package, in fp32 on the CPU (the JAX side at the conftest's `highest`
matmul precision): the registry, the towers at tiny size from the same
weights (carried by `interop.params_from_jax`), OpenCLIP checkpoints with
a timm trunk through both packages' `openclip_to_params`, the serving
command line on one checkpoint, the tokenizer's refusal and the hub
config's statistics.  MobileCLIP's trunks are in `test_torch_mci.py`.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from leaf_tpu.models import clip as jclip
from leaf_tpu.models import config as jconfig
from leaf_tpu.models import interop as jinterop
from leaf_tpu.models import timm_vision as jtimm
from leaf_tpu.tokenizer import hf as jhf
from leaf_tpu_torch.models import clip as tclip
from leaf_tpu_torch.models import config as tconfig
from leaf_tpu_torch.models import interop as tinterop
from leaf_tpu_torch.models import timm_vision as ttimm
from leaf_tpu_torch.tokenizer import hf as thf

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-4)
# the MAP head's and the conv stacks' longer chains of fp32 products
TOL_HEAD = dict(atol=1e-4, rtol=1e-4)


def _np(t):
    return np.asarray(t, np.float32)


def _pair(jcfg, tcfg, seed=0):
    """(JAX params, port module) holding the same weights."""
    params = jclip.init_clip(jax.random.PRNGKey(seed), jcfg)
    module = tclip.CLIP(tcfg)
    module.load_state_dict(tinterop.params_from_jax(
        jax.tree.map(np.asarray, params)))
    return params, module.eval()


def _images(seed, B, size):
    return np.random.default_rng(seed).standard_normal(
        (B, size, size, 3)).astype(np.float32)


def _ids(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(
        1, vocab, size=(B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------

def _same_fields(j, t):
    """Every field of the port's dataclass equals the JAX one's."""
    return {f.name: (getattr(j, f.name), getattr(t, f.name))
            for f in dataclasses.fields(t)
            if getattr(j, f.name) != getattr(t, f.name)}


def test_registry_matches_jax():
    """Every name the JAX package registers resolves in the port with equal
    fields (the Swin, RelPos-ViT and HF-text families too, since they were
    ported); the port registers nothing the JAX package lacks."""
    ported = []
    for name in jconfig.list_models(include_coca=False):
        j = jconfig.get_model_config(name)
        t = tconfig.get_model_config(name)
        ported.append(name)
        diff = {"text": _same_fields(j.text, t.text),
                "vision": _same_fields(j.vision, t.vision),
                "top": {k: v for k, v in _same_fields(j, t).items()
                        if k not in ("text", "vision", "trunk", "resnet",
                                     "convnext")}}
        assert not any(diff.values()), (name, diff)
        for field in ("trunk", "resnet", "convnext"):
            a, b = getattr(j, field), getattr(t, field)
            assert type(a).__name__ == type(b).__name__, (name, field)
            if b is not None:
                assert dataclasses.asdict(a) == dataclasses.asdict(b), name
    assert sorted(ported) == sorted(tconfig.list_models())
    for name in ("ViT-SO400M-14-SigLIP-384", "siglip-tiny-test",
                 "ViT-bigG-14-CLIPA-336", "vit_medium_patch16_gap_256",
                 "ViT-e-14", "MobileCLIP-B", "MobileCLIP-S2",
                 "mci-vit-tiny-test", "fastvit-tiny-test", "RN50",
                 "convnext_base", "EVA02-L-14", "ViTamin-L",
                 "eva-tiny-test"):
        assert name in ported
    for name in ("swin_base_patch4_window7_224", "swin-tiny-test",
                 "vit_relpos_medium_patch16_cls_224", "relpos-tiny-test",
                 "nllb-clip-base-siglip", "roberta-ViT-B-32"):
        assert name in ported
    with pytest.raises(KeyError, match="Unknown model"):
        tconfig.get_model_config("ViT-nonexistent")


@pytest.mark.parametrize("name", [
    "vit_base_patch16_siglip_384", "vit_so400m_patch14_siglip_384",
    "vit_medium_patch16_gap_256", "vit_large_patch14_clip_224"])
@pytest.mark.parametrize("pool", ["map", "avg", "token", ""])
def test_timm_vision_config_matches_jax(name, pool):
    assert jtimm.parse_timm_vit_name(name) == ttimm.parse_timm_vit_name(name)
    j = jtimm.timm_vision_config(name, 512, pool=pool)
    t = ttimm.timm_vision_config(name, 512, pool=pool)
    assert not _same_fields(j, t)


def test_unported_open_clip_dicts_raise_by_name():
    """The Swin, RelPos-ViT and HF-text dicts that raised here before they
    were ported now give the JAX package's configs."""
    for d in ({"embed_dim": 512, "text_cfg": {}, "vision_cfg": {
                   "timm_model_name": "swin_base_patch4_window7_224"}},
              {"embed_dim": 512, "text_cfg": {}, "vision_cfg": {
                   "timm_model_name": "vit_relpos_medium_patch16_cls_224"}},
              {"embed_dim": 512, "vision_cfg": {},
               "text_cfg": {"hf_model_name": "roberta-base"}}):
        j = jconfig.config_from_open_clip_dict("x", d)
        t = tconfig.config_from_open_clip_dict("x", d)
        assert not _same_fields(j.text, t.text)
        assert not _same_fields(j.vision, t.vision)
        assert (None if j.trunk is None else dataclasses.asdict(j.trunk)) \
            == (None if t.trunk is None else dataclasses.asdict(t.trunk))
    with pytest.raises(ValueError, match="unsupported swin trunk"):
        tconfig.config_from_open_clip_dict("x", {
            "embed_dim": 512, "text_cfg": {},
            "vision_cfg": {"timm_model_name": "swin_tiny_patch4_window7_224"}})


@pytest.mark.parametrize("module", [
    "leaf_tpu_torch.models.mci", "leaf_tpu_torch.models.timm_vision",
    "leaf_tpu_torch.models.trunks", "leaf_tpu_torch.models.config",
    "leaf_tpu_torch.models.resnet", "leaf_tpu_torch.models.convnext",
    "leaf_tpu_torch.models.eva", "leaf_tpu_torch.models.vitamin"])
def test_each_module_imports_first(module):
    """The registry builds the zoo's configs while it is imported, through
    `trunks` and the family modules (`mci`, `eva`, `vitamin`, `convnext`)
    and `timm_vision`: whichever of them a process imports first, the
    imports resolve."""
    code = (f"import {module}\n"
            "from leaf_tpu_torch.models.config import get_model_config\n"
            "get_model_config('MobileCLIP-S2'), "
            "get_model_config('ViT-B-16-SigLIP'), get_model_config('RN50'), "
            "get_model_config('convnext_base_w'), "
            "get_model_config('EVA02-L-14'), get_model_config('ViTamin-L')\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=os.path.dirname(os.path.dirname(__file__)))


# ---------------------------------------------------------------------------
# Towers at tiny size
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def siglip():
    name = "siglip-tiny-test"
    jcfg, tcfg = jconfig.get_model_config(name), tconfig.get_model_config(name)
    params, module = _pair(jcfg, tcfg)
    return jcfg, params, module


def test_siglip_tiny_towers(siglip):
    """Class-token-less tower with the MAP head, biased patch embedding,
    no ln_pre; non-causal 'last'-pooled text with a biased projection,
    packed 8 a row and unpacked."""
    jcfg, params, module = siglip
    assert module.visual.class_embedding is None
    assert module.visual.ln_pre is None
    assert module.visual.attn_pool.mlp.fc_w.shape == (64, 256)
    images = _images(1, 3, 64)
    want = jclip.encode_image_model(params, jcfg, jnp.asarray(images))
    with torch.no_grad():
        got = module.encode_image(torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL_HEAD)
    tokens = _ids(2, 16, 16, 512)
    for pack in (True, False):
        want = jclip.encode_text(params["text"], jcfg.text,
                                 jnp.asarray(tokens), pack=pack)
        with torch.no_grad():
            got = module.encode_text(torch.from_numpy(tokens), pack=pack)
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_siglip_tiny_logit_bias_and_logits(siglip):
    jcfg, params, module = siglip
    images, tokens = _images(3, 2, 64), _ids(4, 4, 16, 512)
    want = jclip.forward(params, jcfg, jnp.asarray(images),
                         jnp.asarray(tokens))
    jlogits = jclip.get_logits(params, jcfg, jnp.asarray(images),
                               jnp.asarray(tokens))
    with torch.no_grad():
        got = module(torch.from_numpy(images), torch.from_numpy(tokens))
        tlogits = module.get_logits(torch.from_numpy(images),
                                    torch.from_numpy(tokens))
    assert got["logit_bias"].item() == float(want["logit_bias"]) == -10.0
    for k in ("image_features", "text_features", "logit_scale"):
        np.testing.assert_allclose(got[k].detach().numpy(), _np(want[k]),
                                   **TOL_HEAD)
    for g, w in zip(tlogits, jlogits):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-4, rtol=1e-4)


def _clipa_shaped(cfg, pool):
    return dataclasses.replace(
        cfg, name="clipa-tiny",
        text=dataclasses.replace(cfg.text, no_causal_mask=True,
                                 pool_type="last"),
        vision=dataclasses.replace(cfg.vision, pool_type=pool, ln_pre=False,
                                   final_ln_after_pool=True))


@pytest.mark.parametrize("pool", ["avg", "avg_patch"])
def test_clipa_shaped_tiny_towers(pool):
    """CLIPA's ordering: no ln_pre, pool, then ln_post on the pooled
    vector; non-causal 'last' text."""
    jcfg = _clipa_shaped(jconfig.get_model_config("ViT-tiny-test"), pool)
    tcfg = _clipa_shaped(tconfig.get_model_config("ViT-tiny-test"), pool)
    params, module = _pair(jcfg, tcfg, seed=5)
    images, tokens = _images(6, 3, 64), _ids(7, 8, 32, 49000)
    want_i = jclip.encode_image_model(params, jcfg, jnp.asarray(images))
    want_t = jclip.encode_text(params["text"], jcfg.text, jnp.asarray(tokens))
    with torch.no_grad():
        got_i = module.encode_image(torch.from_numpy(images))
        got_t = module.encode_text(torch.from_numpy(tokens))
    np.testing.assert_allclose(got_i.numpy(), _np(want_i), **TOL)
    np.testing.assert_allclose(got_t.numpy(), _np(want_t), **TOL)


def test_gap_vit_has_no_class_token():
    """vit_medium_patch16_gap_256 at its registry shape but two layers: no
    class token, the mean over all tokens."""
    def cut(cfg):
        return dataclasses.replace(
            cfg, text=dataclasses.replace(cfg.text, layers=1, width=64,
                                          heads=2),
            vision=dataclasses.replace(cfg.vision, layers=2, image_size=64))
    name = "vit_medium_patch16_gap_256"
    jcfg = cut(jconfig.get_model_config(name))
    tcfg = cut(tconfig.get_model_config(name))
    params, module = _pair(jcfg, tcfg, seed=8)
    assert module.visual.class_embedding is None
    assert module.visual.positional_embedding.shape == (16, 512)
    images = _images(9, 2, 64)
    want = jclip.encode_image_model(params, jcfg, jnp.asarray(images))
    with torch.no_grad():
        got = module.encode_image(torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


# -- the timm ViT mapping (the layout of tests/test_timm_vision.py) ----------

def _timm_tiny(config_module):
    return config_module.VisionConfig(
        image_size=32, patch_size=16, width=64, layers=2, head_width=32,
        output_dim=48, pool_type="avg_patch", patch_bias=True, ln_pre=False)


def _fake_timm_sd(cfg, seed=0, head="openclip_linear", layer_scale=False,
                  qkv_bias=True):
    """A seeded timm-ViT-layout state dict (torch [out, in] weights)."""
    rng = np.random.default_rng(seed)
    D, M = cfg.width, int(cfg.width * cfg.mlp_ratio)

    def r(*s):
        return rng.standard_normal(s).astype(np.float32) * 0.02

    sd = {
        "visual.trunk.patch_embed.proj.weight": r(D, 3, cfg.patch_size,
                                                  cfg.patch_size),
        "visual.trunk.patch_embed.proj.bias": r(D),
        "visual.trunk.cls_token": r(1, 1, D),
        "visual.trunk.pos_embed": r(1, cfg.num_tokens, D),
        "visual.trunk.norm.weight": 1 + r(D), "visual.trunk.norm.bias": r(D),
    }
    for i in range(cfg.layers):
        b = f"visual.trunk.blocks.{i}."
        sd.update({b + "norm1.weight": 1 + r(D), b + "norm1.bias": r(D),
                   b + "attn.qkv.weight": r(3 * D, D),
                   b + "attn.proj.weight": r(D, D), b + "attn.proj.bias": r(D),
                   b + "norm2.weight": 1 + r(D), b + "norm2.bias": r(D),
                   b + "mlp.fc1.weight": r(M, D), b + "mlp.fc1.bias": r(M),
                   b + "mlp.fc2.weight": r(D, M), b + "mlp.fc2.bias": r(D)})
        if qkv_bias:
            sd[b + "attn.qkv.bias"] = r(3 * D)
        if layer_scale:
            sd[b + "ls1.gamma"] = 1 + 10 * r(D)
            sd[b + "ls2.gamma"] = 1 + 10 * r(D)
    if head == "openclip_linear":
        sd["visual.head.proj.weight"] = r(cfg.output_dim, D)
    elif head == "mlp":
        sd["visual.head.mlp.fc1.weight"] = r(2 * cfg.output_dim, D)
        sd["visual.head.mlp.fc1.bias"] = r(2 * cfg.output_dim)
        sd["visual.head.mlp.fc2.weight"] = r(cfg.output_dim,
                                             2 * cfg.output_dim)
    elif head == "trunk_classifier":
        sd["visual.trunk.head.weight"] = r(cfg.output_dim, D)
        sd["visual.trunk.head.bias"] = r(cfg.output_dim)
    return sd


def _port_tower(cfg, visual_pytree):
    """A port VisionTower holding a JAX-layout vision pytree."""
    tower = tclip.VisionTower(cfg)
    sd = tinterop.params_from_jax({"visual": visual_pytree})
    tower.load_state_dict({k[len("visual."):]: v for k, v in sd.items()})
    return tower.eval()


@pytest.mark.parametrize("head,proj", [("openclip_linear", "linear"),
                                       ("mlp", "mlp"),
                                       ("trunk_classifier", "linear"),
                                       ("none", "none")])
def test_timm_vit_mapping_matches_jax(head, proj):
    """The timm mapping's heads ('avg_patch' pool): OpenCLIP's linear head,
    its MLP head, the trunk classifier as projection (with its bias), and
    none (features at the trunk width)."""
    jc, tc = _timm_tiny(jconfig), _timm_tiny(tconfig)
    sd = _fake_timm_sd(jc, seed=1, head=head)
    jp = jtimm.timm_vit_to_params(sd, jc, proj=proj)
    tower = _port_tower(tc, ttimm.timm_vit_to_params(sd, tc, proj=proj))
    assert (tower.head_mlp is not None) == (head == "mlp")
    assert (tower.proj is None) == (head in ("mlp", "none"))
    images = _images(2, 2, 32)
    want = jclip.encode_image(jax.tree.map(jnp.asarray, jp), jc,
                              jnp.asarray(images))
    with torch.no_grad():
        got = tower.encode_image(torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_timm_layer_scale_folding_and_missing_qkv_bias():
    jc, tc = _timm_tiny(jconfig), _timm_tiny(tconfig)
    sd = _fake_timm_sd(jc, seed=3, layer_scale=True, qkv_bias=False)
    jp = jtimm.timm_vit_to_params(sd, jc)
    tp = ttimm.timm_vit_to_params(sd, tc)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(tp)):
        np.testing.assert_array_equal(a, b)
    assert not np.asarray(tp["blocks"]["attn"]["qkv_b"]).any()
    tower = _port_tower(tc, tp)
    images = _images(4, 2, 32)
    want = jclip.encode_image(jax.tree.map(jnp.asarray, jp), jc,
                              jnp.asarray(images))
    with torch.no_grad():
        got = tower.encode_image(torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_keep_patches_without_class_token():
    """Patch dropout on a class-token-less tower keeps patches only."""
    x = torch.arange(2 * 6 * 3, dtype=torch.float32).reshape(2, 6, 3)
    scores = torch.tensor([[.5, .1, .9, .3, .7, .2], [.1, .2, .3, .4, .5, .6]])
    got = tclip.keep_patches(x, 0.5, scores, cls_token=False)
    np.testing.assert_array_equal(got[0].numpy(), x[0, [1, 5, 3]].numpy())
    np.testing.assert_array_equal(got[1].numpy(), x[1, [0, 1, 2]].numpy())
    with_cls = tclip.keep_patches(x, 0.5, scores[:, :5])
    np.testing.assert_array_equal(with_cls[0].numpy(), x[0, [0, 2, 4]].numpy())


# ---------------------------------------------------------------------------
# OpenCLIP checkpoints with a timm trunk; the serving command line
# ---------------------------------------------------------------------------

def _siglip_sd(seed=0):
    """siglip-tiny-test in OpenCLIP's CustomTextCLIP layout: a timm trunk
    with the MAP head, the `text.`-prefixed tower with a Linear projection,
    `logit_bias`."""
    rng = np.random.default_rng(seed)
    D, L = 64, 2

    def r(*s):
        return rng.standard_normal(s).astype(np.float32) * 0.05

    sd = {
        "visual.trunk.patch_embed.proj.weight": r(D, 3, 16, 16),
        "visual.trunk.patch_embed.proj.bias": r(D),
        "visual.trunk.pos_embed": r(1, 16, D),
        "visual.trunk.norm.weight": 1 + r(D), "visual.trunk.norm.bias": r(D),
        "visual.trunk.attn_pool.latent": r(1, 1, D),
        "text.token_embedding.weight": r(512, D),
        "text.positional_embedding": r(16, D),
        "text.ln_final.weight": 1 + r(D), "text.ln_final.bias": r(D),
        "text.text_projection.weight": r(D, D),
        "text.text_projection.bias": r(D),
        "logit_scale": np.asarray(1.0, np.float32),
        "logit_bias": np.asarray(-10.0, np.float32),
    }
    ap = "visual.trunk.attn_pool."
    sd.update({ap + "q.weight": r(D, D), ap + "q.bias": r(D),
               ap + "kv.weight": r(2 * D, D), ap + "kv.bias": r(2 * D),
               ap + "proj.weight": r(D, D), ap + "proj.bias": r(D),
               ap + "norm.weight": 1 + r(D), ap + "norm.bias": r(D),
               ap + "mlp.fc1.weight": r(4 * D, D), ap + "mlp.fc1.bias": r(4 * D),
               ap + "mlp.fc2.weight": r(D, 4 * D), ap + "mlp.fc2.bias": r(D)})
    for i in range(L):
        b = f"visual.trunk.blocks.{i}."
        sd.update({b + "norm1.weight": 1 + r(D), b + "norm1.bias": r(D),
                   b + "attn.qkv.weight": r(3 * D, D),
                   b + "attn.qkv.bias": r(3 * D),
                   b + "attn.proj.weight": r(D, D), b + "attn.proj.bias": r(D),
                   b + "norm2.weight": 1 + r(D), b + "norm2.bias": r(D),
                   b + "mlp.fc1.weight": r(4 * D, D),
                   b + "mlp.fc1.bias": r(4 * D),
                   b + "mlp.fc2.weight": r(D, 4 * D), b + "mlp.fc2.bias": r(D)})
        t = f"text.transformer.resblocks.{i}."
        sd.update({t + "ln_1.weight": 1 + r(D), t + "ln_1.bias": r(D),
                   t + "attn.in_proj_weight": r(3 * D, D),
                   t + "attn.in_proj_bias": r(3 * D),
                   t + "attn.out_proj.weight": r(D, D),
                   t + "attn.out_proj.bias": r(D),
                   t + "ln_2.weight": 1 + r(D), t + "ln_2.bias": r(D),
                   t + "mlp.c_fc.weight": r(4 * D, D),
                   t + "mlp.c_fc.bias": r(4 * D),
                   t + "mlp.c_proj.weight": r(D, 4 * D),
                   t + "mlp.c_proj.bias": r(D)})
    return sd


def test_siglip_checkpoint_through_both_packages():
    name = "siglip-tiny-test"
    jcfg, tcfg = jconfig.get_model_config(name), tconfig.get_model_config(name)
    sd = _siglip_sd()
    jp = jax.tree.map(jnp.asarray, jinterop.openclip_to_params(sd, jcfg))
    module = tclip.CLIP(tcfg)
    module.load_state_dict(tinterop.openclip_to_params(
        {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, tcfg))
    # the timm checkpoint has no projection after the MAP head
    assert module.visual.proj is None and "proj" not in jp["visual"]
    images, tokens = _images(5, 2, 64), _ids(6, 4, 16, 512)
    want = jclip.forward(jp, jcfg, jnp.asarray(images), jnp.asarray(tokens))
    with torch.no_grad():
        got = module.eval()(torch.from_numpy(images),
                            torch.from_numpy(tokens))
    for k in ("image_features", "text_features", "logit_scale", "logit_bias"):
        np.testing.assert_allclose(got[k].detach().numpy(), _np(want[k]),
                                   **TOL_HEAD)


def test_clipa_checkpoint_without_ln_pre():
    """An OpenCLIP ViT state dict without `visual.ln_pre.*` (CLIPA) loads,
    and a checkpoint's position grid without a class row is resized."""
    jcfg = _clipa_shaped(jconfig.get_model_config("ViT-tiny-test"), "avg")
    tcfg = _clipa_shaped(tconfig.get_model_config("ViT-tiny-test"), "avg")
    params = jclip.init_clip(jax.random.PRNGKey(2), jcfg)
    from leaf_tpu.convert import params_to_openclip
    sd = params_to_openclip(jax.tree.map(np.asarray, params), jcfg)
    assert "visual.ln_pre.weight" not in sd
    module = tclip.CLIP(tcfg)
    module.load_state_dict(tinterop.openclip_to_params(
        {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, tcfg))
    images = _images(3, 2, 64)
    want = jclip.encode_image_model(params, jcfg, jnp.asarray(images))
    with torch.no_grad():
        got = module.eval().encode_image(torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)

    # a 4 x 4 grid without a class row, resized to 2 x 2 as JAX does
    gcfg = dataclasses.replace(tconfig.get_model_config("siglip-tiny-test"))
    small = dataclasses.replace(gcfg, vision=dataclasses.replace(
        gcfg.vision, image_size=32))
    jsmall = dataclasses.replace(
        jconfig.get_model_config("siglip-tiny-test"),
        vision=dataclasses.replace(
            jconfig.get_model_config("siglip-tiny-test").vision,
            image_size=32))
    pe = np.random.default_rng(0).standard_normal((16, 64)).astype(np.float32)
    got = tinterop.resize_vision_pos_embed(
        {"visual.positional_embedding": torch.from_numpy(pe)}, small)
    want = jinterop.resize_vision_pos_embed(
        {"visual": {"positional_embedding": jnp.asarray(pe)}}, jsmall)
    np.testing.assert_allclose(got["visual.positional_embedding"].numpy(),
                               _np(want["visual"]["positional_embedding"]),
                               atol=1e-5)


def _write_pngs(root, n, size, seed):
    from PIL import Image
    os.makedirs(root)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (size, size, 3), np.uint8)
                        ).save(os.path.join(root, f"{i:02d}.png"))


def test_serve_siglip_checkpoint_matches_jax(tmp_path):
    """`serve.main --images` on one SigLIP checkpoint in both packages
    (fp32, the checkpoint's 0.5 statistics); `--texts` with a published
    SigLIP config refuses by name, before building the model, since its
    tokenizer is not ported."""
    from leaf_tpu import serve as jserve
    from leaf_tpu_torch import serve as tserve
    ckpt = str(tmp_path / "siglip.pt")
    torch.save({k: torch.from_numpy(np.asarray(v))
                for k, v in _siglip_sd(seed=3).items()}, ckpt)
    images = str(tmp_path / "imgs")
    _write_pngs(images, 5, 64, seed=4)
    common = ["--model", "siglip-tiny-test", "--pretrained", ckpt,
              "--images", images, "--precision", "fp32", "--batch-size", "4"]
    want = jserve.main(common + ["--output", str(tmp_path / "j.npz")])
    got = tserve.main(common + ["--output", str(tmp_path / "t.npz"),
                                "--device", "cpu"])
    assert got["image_features"].shape == (5, 64)
    np.testing.assert_allclose(got["image_features"], want["image_features"],
                               **TOL_HEAD)
    texts = tmp_path / "t.txt"
    texts.write_text("a photo of a cat\n")
    with pytest.raises(NotImplementedError, match="vocabulary files"):
        tserve.main(["--model", "ViT-B-16-SigLIP", "--texts", str(texts),
                     "--output", str(tmp_path / "x.npz"), "--device", "cpu"])


# ---------------------------------------------------------------------------
# Tokenizer, transforms, hub config
# ---------------------------------------------------------------------------

def test_tokenizers():
    from leaf_tpu_torch.models.factory import get_tokenizer
    for name in ("ViT-B-16-SigLIP", "ViT-SO400M-14-SigLIP-384",
                 "ViT-L-14-CLIPA"):
        with pytest.raises(NotImplementedError, match="vocabulary files"):
            get_tokenizer(name)
    tok = get_tokenizer("MobileCLIP-B")
    assert np.asarray(tok(["a photo of a dog"])).shape == (1, 77)
    for text in ("A_Photo, of; the  DOG!!", "it's 3:30 -- \"quoted\" text"):
        for kind in ("canonicalize", "lower", "whitespace"):
            assert thf.get_clean_fn(kind)(text) == jhf.get_clean_fn(kind)(text)
        assert thf.canonicalize_text(text, keep_punctuation_exact_string="--") \
            == jhf.canonicalize_text(text, keep_punctuation_exact_string="--")
    with pytest.raises(ValueError):
        thf.get_clean_fn("nope")


@pytest.mark.parametrize("name,mean", [("siglip-tiny-test", 0.5),
                                       ("mci-vit-tiny-test", None),
                                       ("ViT-tiny-test", None)])
def test_transforms_use_the_configs_statistics(name, mean):
    from leaf_tpu.models import factory as jfactory
    from leaf_tpu_torch.models import factory as tfactory
    img = np.random.default_rng(0).integers(0, 256, (40, 48, 3), np.uint8)
    _, _, jpre = jfactory.create_model_and_transforms(name)
    _, _, tpre = tfactory.create_model_and_transforms(name, device="cpu")
    np.testing.assert_allclose(tpre(img), np.asarray(jpre(img)), atol=1e-5)
    if mean is not None:
        assert tfactory.get_model_config(name).image_mean == (mean,) * 3


@pytest.mark.parametrize("name", ["siglip-tiny-test", "mci-vit-tiny-test"])
def test_openclip_export_of_zoo_towers_refused(name):
    """The OpenCLIP export writes what the JAX package's writes; the zoo's
    other parts raise by name instead of failing on a missing key or being
    dropped: SigLIP's MAP head and patch bias, for which the JAX export
    writes no key (ROADMAP Queue 3), and a trunk, which has no export in
    the JAX package either."""
    from leaf_tpu_torch.convert import params_to_openclip
    cfg = tconfig.get_model_config(name)
    module = tclip.CLIP(cfg)
    with pytest.raises(NotImplementedError,
                       match="writes no key.*attn_pool" if cfg.trunk is None
                       else "trunk.*JAX package"):
        params_to_openclip(module.state_dict(), cfg)


def test_hub_preprocess_cfg_is_the_models(tmp_path):
    """`save_for_hub` writes the config's statistics, as the JAX package
    does: MobileCLIP's (0, 1), here on a tiny tower; OpenAI's where the
    config has none."""
    from leaf_tpu_torch import push_to_hf_hub as thub
    from leaf_tpu_torch.models.preprocess import OPENAI_DATASET_MEAN
    mc = tconfig.get_model_config("MobileCLIP-B")
    assert thub.preprocess_cfg(mc) == {"mean": [0.0] * 3, "std": [1.0] * 3}
    assert thub.preprocess_cfg(tconfig.get_model_config("ViT-tiny-test"))[
        "mean"] == list(OPENAI_DATASET_MEAN)
    cfg = dataclasses.replace(tconfig.get_model_config("ViT-tiny-test"),
                              image_mean=mc.image_mean, image_std=mc.image_std)
    module = tclip.CLIP(cfg)
    module.init_weights(torch.Generator().manual_seed(0))
    d = thub.save_for_hub(module.state_dict(), cfg, str(tmp_path / "hub"))
    with open(os.path.join(d, "open_clip_config.json")) as f:
        assert json.load(f)["preprocess_cfg"] == {"mean": [0.0] * 3,
                                                  "std": [1.0] * 3}
