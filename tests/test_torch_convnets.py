"""leaf_tpu_torch's ModifiedResNet, ConvNeXt, EVA and ViTamin towers against
the JAX package, in fp32 on the CPU (the JAX side at the conftest's
`highest` matmul precision): the registry, every family's parts and tiny
towers from the same seeded numpy weights (carried by
`interop.params_from_jax`), OpenCLIP and timm state dicts through both
packages' `openclip_to_params`, and `convert`'s OpenCLIP export of the
ResNet and ConvNeXt towers.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from leaf_tpu import convert as jconvert
from leaf_tpu.models import clip as jclip
from leaf_tpu.models import config as jconfig
from leaf_tpu.models import convnext as jconvnext
from leaf_tpu.models import eva as jeva
from leaf_tpu.models import interop as jinterop
from leaf_tpu.models import resnet as jresnet
from leaf_tpu.models import vitamin as jvitamin
from leaf_tpu_torch import convert as tconvert
from leaf_tpu_torch.models import clip as tclip
from leaf_tpu_torch.models import config as tconfig
from leaf_tpu_torch.models import convnext as tconvnext
from leaf_tpu_torch.models import eva as teva
from leaf_tpu_torch.models import interop as tinterop
from leaf_tpu_torch.models import resnet as tresnet
from leaf_tpu_torch.models import vitamin as tvitamin
from leaf_tpu_torch.models.factory import create_model

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-4)
FAMILIES = ("RN", "convnext", "EVA", "eva-", "ViTamin", "vitamin-")


def _np(t):
    return np.asarray(t, np.float32)


def _rn_tiny(config_module):
    """A ModifiedResNet CLIP at test size: one bottleneck a stage, width
    8, 64 px (attention pool of 4 heads of 64 over 5 tokens)."""
    c = config_module
    return c.CLIPConfig(
        name="rn-tiny", embed_dim=64,
        text=c.TextConfig(context_length=16, vocab_size=512, width=64,
                          heads=2, layers=2, output_dim=64),
        vision=c.VisionConfig(image_size=64, patch_size=32, width=128,
                              layers=4, output_dim=64),
        resnet=c.ResNetVisionSpec(layers=(1, 1, 1, 1), width=8,
                                  image_size=64, output_dim=64))


def _configs(name):
    if name == "rn-tiny":
        return _rn_tiny(jconfig), _rn_tiny(tconfig)
    return jconfig.get_model_config(name), tconfig.get_model_config(name)


def _fill(node, rng, path=()):
    """Seeded numpy weights in the shape tree `node`: unit-ish LayerNorm
    and BatchNorm scales, positive variances, layer scales of 0.5 (the
    init's 1e-6 would hide a ConvNeXt block), fan-in-scaled weights."""
    if isinstance(node, dict):
        return {k: _fill(v, rng, path + (k,)) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_fill(v, rng, path + (i,)) for i, v in enumerate(node)]
    shape, name = tuple(node.shape), path[-1]
    n = rng.standard_normal(shape)
    if name == "var":
        a = rng.uniform(0.5, 1.5, shape)
    elif name == "scale":
        a = 1 + 0.1 * n
    elif name == "gamma":
        a = 0.5 + 0.1 * n
    elif len(shape) <= 1 or name in ("mean", "bias") or name.endswith("_b"):
        a = 0.1 * n
    elif name in ("token_embedding", "positional_embedding"):
        a = 0.02 * n
    else:
        core = shape[1:] if "blocks" in path else shape
        a = n / math.sqrt(math.prod(core[:-1]))
    return a.astype(np.float32)


def _seeded(jcfg, seed=0):
    """The JAX package's CLIP pytree of `jcfg`, filled with seeded numpy
    weights."""
    shapes = jax.eval_shape(lambda: jclip.init_clip(jax.random.PRNGKey(0),
                                                    jcfg))
    return _fill(shapes, np.random.default_rng(seed))


def _module(tcfg, params):
    module = tclip.CLIP(tcfg)
    module.load_state_dict(tinterop.params_from_jax(params))
    return module.eval()


def _images(seed, B, size):
    return np.random.default_rng(seed).standard_normal(
        (B, size, size, 3)).astype(np.float32)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _block0(tree):
    """Block 0 of a stacked block tree."""
    return jax.tree.map(lambda a: a[0], tree)


@pytest.fixture(scope="module", params=["rn-tiny", "convnext-tiny-test",
                                        "eva-tiny-test", "vitamin-tiny-test"])
def tiny(request):
    jcfg, tcfg = _configs(request.param)
    params = _seeded(jcfg, seed=len(request.param))
    return jcfg, tcfg, params, _module(tcfg, params)


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------

def _family_names():
    return [n for n in jconfig.list_models(include_coca=False)
            if n.startswith(FAMILIES)]


def _diff(j, t):
    return {f.name: (getattr(j, f.name), getattr(t, f.name))
            for f in dataclasses.fields(t)
            if getattr(j, f.name) != getattr(t, f.name)}


def test_family_registry_matches_jax():
    """Every JAX registry name of the four families resolves in the port
    with equal fields, tower specs included."""
    names = _family_names()
    assert len(names) >= 40
    for name in ("RN50", "RN50-quickgelu", "RN101", "RN50x4", "RN50x16",
                 "RN50x64", "convnext_base_w", "convnext_xxlarge_320",
                 "EVA01-g-14-plus", "EVA02-L-14", "EVA02-E-14-plus",
                 "ViTamin-L", "ViTamin-XL-384", "eva-tiny-test",
                 "vitamin-tiny-test", "convnext-tiny-test"):
        assert name in names
    for name in names:
        j, t = jconfig.get_model_config(name), tconfig.get_model_config(name)
        assert not _diff(j.text, t.text), name
        assert not _diff(j.vision, t.vision), name
        top = {k: v for k, v in _diff(j, t).items()
               if k not in ("text", "vision", "resnet", "convnext",
                            "trunk")}
        assert not top, (name, top)
        for field in ("resnet", "convnext", "trunk"):
            a, b = getattr(j, field), getattr(t, field)
            assert (a is None) == (b is None), (name, field)
            if a is not None:
                assert type(a).__name__ == type(b).__name__, name
                assert dataclasses.asdict(a) == dataclasses.asdict(b), name


@pytest.mark.parametrize("name", [
    "eva02_large_patch14_clip_336", "eva_giant_patch14_224", "eva_tiny_1",
    "vitamin_large2_256", "vitamin_xlarge_384", "vitamin_tiny_224",
    "convnext_xxlarge", "convnext_nano", "vit_base_patch16_224"])
def test_family_matchers_match_jax(name):
    """The timm-name matchers resolve, refuse (an unknown size of the
    family) or pass on (another family's name) as the JAX package's do."""
    pairs = [(jeva.match_eva, teva.match_eva),
             (jvitamin.match_vitamin, tvitamin.match_vitamin)]
    if name.startswith("convnext"):
        pairs = [(jconvnext.convnext_spec, tconvnext.convnext_spec)]
    for jfn, tfn in pairs:
        try:
            want = jfn(name, 512)
        except ValueError as e:
            with pytest.raises(ValueError, match="unsupported"):
                tfn(name, 512)
            assert "unsupported" in str(e)
            continue
        got = tfn(name, 512)
        assert (want is None) == (got is None)
        if want is not None:
            assert dataclasses.asdict(want) == dataclasses.asdict(got)


def _port_shapes(tree, prefix=""):
    """The port's state-dict shapes of a JAX shape tree (the naming of
    `interop.params_from_jax`: stacked blocks un-stacked, the vision
    tower's 4-D kernels OIHW)."""
    out = {}
    for k, v in (tree.items() if isinstance(tree, dict)
                 else enumerate(tree)):
        name = f"{prefix}{k}"
        if isinstance(v, (dict, list, tuple)):
            out.update(_port_shapes(v, name + "."))
            continue
        shape = tuple(v.shape)
        stacked = ".blocks." in f".{name}"
        per = shape[1:] if stacked else shape
        if len(per) == 4 and name.startswith("visual."):
            per = (per[3], per[2], per[0], per[1])
        if stacked:
            head, rest = name.split("blocks.", 1)
            out.update({f"{head}blocks.{i}.{rest}": per
                        for i in range(shape[0])})
        else:
            out[name] = per
    return out


@pytest.mark.parametrize("family", ["RN", "convnext", "EVA", "ViTamin"])
def test_every_family_config_builds_at_its_shape(family):
    """Each registry config of the family builds (on the meta device: no
    weights are drawn) with exactly the parameters and shapes of the JAX
    package's pytree at that config."""
    for name in (n for n in _family_names() if n.startswith(family)):
        jcfg, tcfg = _configs(name)
        with torch.device("meta"):
            module = tclip.CLIP(tcfg)
        got = {k: tuple(v.shape) for k, v in module.state_dict().items()}
        shapes = jax.eval_shape(
            lambda c=jcfg: jclip.init_clip(jax.random.PRNGKey(0), c))
        assert got == _port_shapes(shapes), name


@pytest.mark.parametrize("name", ["RN50", "convnext_base_w", "EVA02-B-16",
                                  "ViTamin-S"])
def test_full_size_configs_build_through_the_factory(name):
    """`create_model` on the CPU at a registered full-size config of each
    family (the smallest, up to 180M parameters): the seeded init, an image
    and a text encode at batch 1, unit-norm features of the embedding
    width."""
    model = create_model(name, device="cpu")
    cfg = model.cfg
    size = cfg.vision.image_size
    tokens = np.zeros((1, cfg.text.context_length), np.int32)
    tokens[0, :2] = (49406, 49407)
    with torch.no_grad():
        feats = [model.encode_image(_images(66, 1, size), normalize=True),
                 model.encode_text(tokens, normalize=True)]
    for f in feats:
        assert f.shape == (1, cfg.embed_dim) and torch.isfinite(f).all()
        np.testing.assert_allclose(f.norm(dim=-1).numpy(), 1.0, atol=1e-5)


def test_tiny_configs_build_through_the_factory():
    """create_model builds each tiny config on the CPU, in bf16 with the
    LayerNorm and BatchNorm parameters and statistics kept fp32, and the
    same seed gives the same features."""
    for name in ("convnext-tiny-test", "eva-tiny-test", "vitamin-tiny-test"):
        a = create_model(name, precision="fp32", seed=3, device="cpu")
        b = create_model(name, precision="bf16", seed=3, device="cpu")
        size = a.cfg.vision.image_size
        x = _images(4, 2, size)
        with torch.no_grad():
            fa = a.encode_image(x, normalize=True)
            fb = b.encode_image(x, normalize=True)
            fc = create_model(name, seed=3, device="cpu").encode_image(
                x, normalize=True)
        assert fb.dtype == torch.bfloat16 and torch.isfinite(fa).all()
        torch.testing.assert_close(fa, fc, rtol=0, atol=0)
        assert float((fa * fb.float()).sum(-1).min()) > 0.99
        for m in b.module.visual.modules():
            if isinstance(m, torch.nn.Module) and hasattr(m, "eps"):
                assert m.scale.dtype == torch.float32
    module = tclip.CLIP(_rn_tiny(tconfig))
    module.init_weights(torch.Generator().manual_seed(0))
    from leaf_tpu_torch.models.factory import _cast_weights
    _cast_weights(module, torch.bfloat16)
    assert module.visual.conv1.dtype == torch.bfloat16
    assert module.visual.bn1.scale.dtype == torch.float32
    assert module.visual.bn1.var.dtype == torch.float32


# ---------------------------------------------------------------------------
# ModifiedResNet
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rn():
    jcfg, tcfg = _configs("rn-tiny")
    params = _seeded(jcfg, seed=11)
    return jcfg, tcfg, params, _module(tcfg, params)


def test_batch_norm_matches_jax(rn):
    _, _, params, module = rn
    p = params["visual"]["layer2"][0]["bn3"]
    x = _x(1, 2, 4, 4, 64) * 3 + 1
    want, _ = jresnet.batch_norm(p, jnp.asarray(x))
    with torch.no_grad():
        got = module.visual.layer2[0].bn3(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    # bf16: fp32 statistics, the result rounded once
    want, _ = jresnet.batch_norm(p, jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        got = module.visual.layer2[0].bn3(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want.astype(
        jnp.float32)), rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("layer", ["layer1", "layer2"])
def test_bottleneck_matches_jax(rn, layer):
    """Stride 1 with a projecting shortcut, and stride 2 (the average pool
    before the strided 1x1 convs on both branches)."""
    _, _, params, module = rn
    stride = 1 if layer == "layer1" else 2
    cin = 8 if layer == "layer1" else 32
    x = _x(2, 2, 8, 8, cin)
    want = jresnet._bottleneck(params["visual"][layer][0], jnp.asarray(x),
                               stride, False)
    with torch.no_grad():
        got = getattr(module.visual, layer)[0](torch.from_numpy(x))
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_attention_pool_matches_jax(rn):
    _, tcfg, params, module = rn
    x = _x(3, 3, 2, 2, 256)
    want = jresnet.attention_pool_2d(params["visual"]["attnpool"],
                                     jnp.asarray(x), 4)
    with torch.no_grad():
        got = tresnet.attention_pool_2d(module.visual.attnpool,
                                        torch.from_numpy(x), 4)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


# ---------------------------------------------------------------------------
# ConvNeXt
# ---------------------------------------------------------------------------

def _convnext_head(proj):
    jcfg, tcfg = _configs("convnext-tiny-test")
    jcfg = dataclasses.replace(jcfg, convnext=dataclasses.replace(
        jcfg.convnext, proj=proj))
    tcfg = dataclasses.replace(tcfg, convnext=dataclasses.replace(
        tcfg.convnext, proj=proj))
    params = _seeded(jcfg, seed=21)
    if proj == "mlp":        # fc2's optional bias, taken at load
        params["visual"]["head_mlp"]["proj_b"] = _x(22, 64) * 0.1
    return jcfg, tcfg, params


def test_convnext_block_matches_jax():
    jcfg, tcfg, params = _convnext_head("linear")
    module = _module(tcfg, params)
    x = _x(23, 2, 8, 8, 64)
    p = _block0(params["visual"]["stages"][2]["blocks"])
    want = jconvnext._block_body(jnp.asarray(x), p, jnp.float32)
    with torch.no_grad():
        got = module.visual.stages[2].blocks[0](torch.from_numpy(x))
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("proj", ["linear", "mlp", "none"])
def test_convnext_tower_each_head(proj):
    jcfg, tcfg, params = _convnext_head(proj)
    module = _module(tcfg, params)
    images = _images(24, 2, 64)
    want = jclip.encode_image_model(params, jcfg, jnp.asarray(images))
    with torch.no_grad():
        got = module.encode_image(torch.from_numpy(images))
    assert got.shape == ((2, 128) if proj == "none" else (2, 64))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


# ---------------------------------------------------------------------------
# EVA
# ---------------------------------------------------------------------------

def _eva(kind, image_size=64, ref=16):
    """eva-tiny-test's trunk at a grid of image_size / 8 (> 2, so that a
    transposed rope table would show), as EVA02 (rope, SwiGLU, sub-LNs),
    EVA01 (fused qkv, GELU) or post-norm."""
    kw = {"eva02": {},
          "eva01": dict(swiglu=False, rope=False, inner_attn_ln=False,
                        mlp_ln=False, fused_qkv=True),
          "postnorm": dict(swiglu=False, rope=False, inner_attn_ln=False,
                           mlp_ln=False, fused_qkv=True, post_norm=True)}[kind]
    out = []
    for c in _configs("eva-tiny-test"):
        trunk = dataclasses.replace(c.trunk, image_size=image_size,
                                    ref_feat_size=ref, **kw)
        out.append(dataclasses.replace(
            c, trunk=trunk, vision=dataclasses.replace(
                c.vision, image_size=image_size)))
    return out


@pytest.mark.parametrize("grid,ref", [(8, 16), (8, 8), (24, 16)])
def test_rope_table_matches_jax(grid, ref):
    jcfg, tcfg = _eva("eva02", 8 * grid, ref)
    want, got = jeva.rope_sin_cos(jcfg.trunk), teva.rope_sin_cos(tcfg.trunk)
    assert got.shape == (2, grid * grid, 32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["eva02", "eva01"])
def test_eva_attention_matches_jax(kind):
    """Split q/k/v with a bias-less k, rope on the 64 patch tokens (the
    class token unrotated) and `ln_inner`; or EVA01's fused qkv."""
    jcfg, tcfg = _eva(kind)
    params = _seeded(jcfg, seed=31)
    module = _module(tcfg, params)
    x = _x(32, 2, 65, 64)
    p = _block0(params["visual"]["blocks"])
    table = jeva.rope_sin_cos(jcfg.trunk)
    want = jeva._attention(p["attn"], jnp.asarray(x), jcfg.trunk,
                           None if table is None else jnp.asarray(table))
    with torch.no_grad():
        got = module.visual.blocks[0].attn(torch.from_numpy(x),
                                           module.visual.rope)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("kind", ["eva02", "postnorm"])
def test_eva_mlp_and_block_match_jax(kind):
    """SwiGLU with its sub-LN (D 128 hidden), and the post-norm block with
    its GELU MLP."""
    jcfg, tcfg = _eva(kind)
    params = _seeded(jcfg, seed=33)
    module = _module(tcfg, params)
    x = _x(34, 2, 65, 64)
    p = _block0(params["visual"]["blocks"])
    table = jeva.rope_sin_cos(jcfg.trunk)
    sincos = None if table is None else jnp.asarray(table)
    block = module.visual.blocks[0]
    with torch.no_grad():
        got_m = block.mlp(torch.from_numpy(x))
        got_b = block(torch.from_numpy(x), module.visual.rope)
    np.testing.assert_allclose(
        got_m.numpy(), _np(jeva._mlp(p["mlp"], jnp.asarray(x), jcfg.trunk)),
        **TOL)
    np.testing.assert_allclose(
        got_b.numpy(), _np(jeva._block(p, jnp.asarray(x), jcfg.trunk,
                                       sincos)), **TOL)


@pytest.mark.parametrize("kind", ["eva02", "eva01", "postnorm"])
def test_eva_tower_matches_jax(kind):
    jcfg, tcfg = _eva(kind)
    params = _seeded(jcfg, seed=35)
    module = _module(tcfg, params)
    images = _images(36, 2, 64)
    want = jclip.encode_image_model(params, jcfg, jnp.asarray(images))
    with torch.no_grad():
        got = module.encode_image(torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


# ---------------------------------------------------------------------------
# ViTamin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("si,bi,stride,cin", [
    (0, 0, 2, 8),       # Downsample2d without its 1x1: cin == cout
    (1, 0, 2, 8),       # Downsample2d with the 1x1 to the new width
    (1, 1, 1, 16)])     # identity
def test_mbconv_matches_jax(si, bi, stride, cin):
    jcfg, tcfg = _configs("vitamin-tiny-test")
    params = _seeded(jcfg, seed=41)
    module = _module(tcfg, params)
    p = params["visual"]["stages"][si][bi]
    assert ("sc_w" in p) == (si == 1 and bi == 0)
    x = _x(42, 2, 8, 8, cin)
    want = jvitamin._mbconv(p, jnp.asarray(x), stride)
    with torch.no_grad():
        got = module.visual.stages[si][bi](torch.from_numpy(x))
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_vitamin_vit_block_matches_jax():
    jcfg, tcfg = _configs("vitamin-tiny-test")
    params = _seeded(jcfg, seed=43)
    module = _module(tcfg, params)
    x = _x(44, 2, 4, 32)
    want = jvitamin._vit_block(_block0(params["visual"]["blocks"]),
                               jnp.asarray(x), 2)
    with torch.no_grad():
        got = module.visual.blocks[0](torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


# ---------------------------------------------------------------------------
# CLIP at tiny size, every family
# ---------------------------------------------------------------------------

def test_tiny_clip_encoders_match_jax(tiny):
    jcfg, tcfg, params, module = tiny
    size = tcfg.vision.image_size
    images = _images(51, 3, size)
    tokens = np.random.default_rng(52).integers(
        1, tcfg.text.vocab_size, (4, tcfg.text.context_length)).astype(
        np.int32)
    want_i = jclip.encode_image_model(params, jcfg, jnp.asarray(images))
    want_t = jclip.encode_text(params["text"], jcfg.text, jnp.asarray(tokens))
    with torch.no_grad():
        got_i = module.encode_image(torch.from_numpy(images))
        got_t = module.encode_text(torch.from_numpy(tokens))
        got_n = module.encode_image(torch.from_numpy(images), normalize=True)
    np.testing.assert_allclose(got_i.numpy(), _np(want_i), **TOL)
    np.testing.assert_allclose(got_t.numpy(), _np(want_t), **TOL)
    np.testing.assert_allclose(got_n.norm(dim=-1).numpy(), 1.0, atol=1e-6)
    # no JAX trainer passes remat to a zoo tower (ROADMAP item 11 step 4)
    with pytest.raises(NotImplementedError,
                       match="neither remat nor patch dropout.*JAX package"):
        module.visual.encode_image(torch.from_numpy(images), remat=True)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _text_sd(cfg, seed, prefix=""):
    """A seeded OpenCLIP text tower state dict (torch layouts)."""
    rng = np.random.default_rng(seed)
    D, L, M = cfg.width, cfg.layers, int(cfg.width * cfg.mlp_ratio)

    def r(*s, base=0.0):
        return (base + 0.05 * rng.standard_normal(s)).astype(np.float32)

    sd = {"token_embedding.weight": r(cfg.vocab_size, D),
          "positional_embedding": r(cfg.context_length, D),
          "ln_final.weight": r(D, base=1), "ln_final.bias": r(D),
          "text_projection": r(D, cfg.output_dim)}
    for i in range(L):
        b = f"transformer.resblocks.{i}."
        sd.update({b + "ln_1.weight": r(D, base=1), b + "ln_1.bias": r(D),
                   b + "attn.in_proj_weight": r(3 * D, D),
                   b + "attn.in_proj_bias": r(3 * D),
                   b + "attn.out_proj.weight": r(D, D),
                   b + "attn.out_proj.bias": r(D),
                   b + "ln_2.weight": r(D, base=1), b + "ln_2.bias": r(D),
                   b + "mlp.c_fc.weight": r(M, D), b + "mlp.c_fc.bias": r(M),
                   b + "mlp.c_proj.weight": r(D, M),
                   b + "mlp.c_proj.bias": r(D)})
    return {prefix + k: v for k, v in sd.items()}


def _eva_timm_sd(spec, seed):
    """A seeded timm EVA state dict (the layout of tests/test_eva.py)."""
    rng = np.random.default_rng(seed)
    D, Hn, p = spec.width, spec.mlp_hidden, spec.patch_size

    def r(*s, base=0.0):
        return (base + 0.05 * rng.standard_normal(s)).astype(np.float32)

    t = "visual.trunk."
    sd = {t + "patch_embed.proj.weight": r(D, 3, p, p),
          t + "patch_embed.proj.bias": r(D), t + "cls_token": r(1, 1, D),
          t + "pos_embed": r(1, spec.grid_size ** 2 + 1, D),
          t + "norm.weight": r(D, base=1), t + "norm.bias": r(D),
          t + "head.weight": r(spec.output_dim, D),
          t + "head.bias": r(spec.output_dim)}
    for i in range(spec.layers):
        b = f"{t}blocks.{i}."
        for n in ("norm1", "norm2"):
            sd[f"{b}{n}.weight"], sd[f"{b}{n}.bias"] = r(D, base=1), r(D)
        if spec.fused_qkv:
            sd.update({b + "attn.qkv.weight": r(3 * D, D),
                       b + "attn.q_bias": r(D), b + "attn.v_bias": r(D)})
        else:
            sd.update({b + "attn.q_proj.weight": r(D, D),
                       b + "attn.q_proj.bias": r(D),
                       b + "attn.k_proj.weight": r(D, D),
                       b + "attn.v_proj.weight": r(D, D),
                       b + "attn.v_proj.bias": r(D)})
        sd.update({b + "attn.proj.weight": r(D, D),
                   b + "attn.proj.bias": r(D)})
        if spec.inner_attn_ln:
            sd.update({b + "attn.norm.weight": r(D, base=1),
                       b + "attn.norm.bias": r(D)})
        fc1 = ("fc1_g", "fc1_x") if spec.swiglu else ("fc1",)
        for n in fc1:
            sd.update({f"{b}mlp.{n}.weight": r(Hn, D),
                       f"{b}mlp.{n}.bias": r(Hn)})
        sd.update({b + "mlp.fc2.weight": r(D, Hn), b + "mlp.fc2.bias": r(D)})
        if spec.mlp_ln:
            sd.update({b + "mlp.norm.weight": r(Hn, base=1),
                       b + "mlp.norm.bias": r(Hn)})
    return sd


def _vitamin_timm_sd(spec, seed):
    """A seeded timm ViTamin state dict (the layout of
    tests/test_vitamin.py): no shortcut conv where cin == cout."""
    rng = np.random.default_rng(seed)
    d0, d1, d2 = spec.dims

    def r(*s, base=0.0):
        return (base + 0.05 * rng.standard_normal(s)).astype(np.float32)

    be = "visual.trunk.patch_embed.backbone."
    sd = {be + "stem.conv1.weight": r(d0, 3, 3, 3),
          be + "stem.conv1.bias": r(d0),
          be + "stem.norm1.weight": r(d0, base=1),
          be + "stem.norm1.bias": r(d0),
          be + "stem.conv2.weight": r(d0, d0, 3, 3),
          be + "stem.conv2.bias": r(d0),
          be + "pool.norm.weight": r(d1, base=1), be + "pool.norm.bias": r(d1),
          be + "pool.proj.weight": r(d2, d1, 3, 3),
          be + "pool.proj.bias": r(d2),
          "visual.trunk.fc_norm.weight": r(d2, base=1),
          "visual.trunk.fc_norm.bias": r(d2),
          "visual.head.proj.weight": r(spec.output_dim, d2)}
    for si, (cin, cout) in enumerate([(d0, d0), (d0, d1)]):
        for bi in range(spec.depths[si]):
            b = f"{be}stages.{si}.blocks.{bi}."
            ci, mid = (cin if bi == 0 else cout), cout * spec.expand_ratio
            sd.update({b + "pre_norm.weight": r(ci, base=1),
                       b + "pre_norm.bias": r(ci),
                       b + "conv1_1x1.weight": r(mid, ci, 1, 1),
                       b + "conv1_1x1.bias": r(mid),
                       b + "conv2_kxk.weight": r(mid, 1, 3, 3),
                       b + "conv2_kxk.bias": r(mid),
                       b + "conv3_1x1.weight": r(cout, mid, 1, 1),
                       b + "conv3_1x1.bias": r(cout)})
            if ci != cout:
                sd.update({b + "shortcut.expand.weight": r(cout, ci, 1, 1),
                           b + "shortcut.expand.bias": r(cout)})
    for i in range(spec.vit_depth):
        b = f"visual.trunk.blocks.{i}."
        sd.update({b + "attn.qkv.weight": r(3 * d2, d2),
                   b + "attn.qkv.bias": r(3 * d2),
                   b + "attn.proj.weight": r(d2, d2),
                   b + "attn.proj.bias": r(d2)})
        for n in ("norm1", "norm2", "mlp.norm"):
            sd[f"{b}{n}.weight"], sd[f"{b}{n}.bias"] = r(d2, base=1), r(d2)
        for n, shape in (("w0", (2 * d2, d2)), ("w1", (2 * d2, d2)),
                         ("w2", (d2, 2 * d2))):
            sd.update({f"{b}mlp.{n}.weight": r(*shape),
                       f"{b}mlp.{n}.bias": r(shape[0])})
    return sd


def _to_fb_convnext(sd):
    """timm ConvNeXt keys -> the original (facebookresearch) spelling."""
    out = {}
    for k, v in sd.items():
        if k.startswith("visual.trunk."):
            k = (k.replace("visual.trunk.stem.", "visual.trunk."
                           "downsample_layers.0.")
                 .replace(".blocks.", ".").replace("conv_dw", "dwconv")
                 .replace("mlp.fc1", "pwconv1").replace("mlp.fc2", "pwconv2")
                 .replace("head.norm", "norm"))
            for si in (1, 2, 3):
                k = k.replace(f"stages.{si}.downsample.",
                              f"downsample_layers.{si}.")
        out[k] = v
    return out


def _openclip_sd(name):
    """(configs, an OpenCLIP state dict of the family, as numpy): written by
    the JAX package's `convert.params_to_openclip` for the ResNet and
    ConvNeXt (also in the original key spelling), or a seeded timm trunk
    with an OpenCLIP text tower for EVA and ViTamin."""
    base = name.split(":")[0]
    jcfg, tcfg = _configs(base)
    if base in ("rn-tiny", "convnext-tiny-test"):
        sd = jconvert.params_to_openclip(_seeded(jcfg, seed=61), jcfg)
        if name.endswith(":fb"):
            sd = _to_fb_convnext(sd)
    else:
        trunk_sd = (_eva_timm_sd if base == "eva-tiny-test"
                    else _vitamin_timm_sd)(jcfg.trunk, 62)
        sd = {**trunk_sd, **_text_sd(jcfg.text, 63, "text."),
              "logit_scale": np.float32(2.5)}
    return jcfg, tcfg, sd


@pytest.mark.parametrize("name", ["rn-tiny", "convnext-tiny-test",
                                  "convnext-tiny-test:fb", "eva-tiny-test",
                                  "vitamin-tiny-test"])
def test_openclip_checkpoints_load_as_in_jax(name):
    """A state dict through the port's `openclip_to_params` gives the JAX
    package's pytree (through `params_from_jax`) entry for entry, and the
    loaded model its features."""
    jcfg, tcfg, sd = _openclip_sd(name)
    jparams = jinterop.openclip_to_params(sd, jcfg)
    got = tinterop.openclip_to_params(
        {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, tcfg)
    want = tinterop.params_from_jax(jax.tree.map(np.asarray, jparams))
    assert sorted(got) == sorted(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    module = tclip.CLIP(tcfg)
    module.load_state_dict(got)
    images = _images(64, 2, tcfg.vision.image_size)
    want_i = jclip.encode_image_model(jax.tree.map(jnp.asarray, jparams),
                                      jcfg, jnp.asarray(images))
    with torch.no_grad():
        got_i = module.eval().encode_image(torch.from_numpy(images))
    np.testing.assert_allclose(got_i.numpy(), _np(want_i), **TOL)


@pytest.mark.parametrize("name", ["convnext-tiny-test:fb", "eva-tiny-test",
                                  "vitamin-tiny-test"])
def test_create_model_loads_a_checkpoint_file(name, tmp_path):
    """`create_model(pretrained=...)` reads an OpenCLIP safetensors file of
    the family (the key schema detected, positions left alone) to the JAX
    package's features."""
    from leaf_tpu_torch.convert import save_state_dict
    jcfg, tcfg, sd = _openclip_sd(name)
    path = save_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                            for k, v in sd.items()}, str(tmp_path))
    model = create_model(tcfg.name, pretrained=path, device="cpu")
    images = _images(65, 2, tcfg.vision.image_size)
    want = jclip.encode_image_model(
        jax.tree.map(jnp.asarray, jinterop.openclip_to_params(sd, jcfg)),
        jcfg, jnp.asarray(images))
    with torch.no_grad():
        got = model.encode_image(images)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_resnet_checkpoint_needs_a_resnet_config():
    _, _, sd = _openclip_sd("rn-tiny")
    sd = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    with pytest.raises(ValueError, match="ModifiedResNet"):
        tinterop.openclip_to_params(sd, tconfig.get_model_config(
            "convnext-tiny-test"))
    assert tinterop.resize_vision_pos_embed(
        {"visual.positional_embedding": torch.zeros(7, 4)},
        _rn_tiny(tconfig))["visual.positional_embedding"].shape == (7, 4)


@pytest.mark.parametrize("name,proj", [("rn-tiny", None),
                                       ("convnext-tiny-test", "linear"),
                                       ("convnext-tiny-test", "mlp")])
def test_openclip_export_equals_jax(name, proj):
    """`convert.params_to_openclip` writes the JAX package's OpenCLIP state
    dict key for key: the ModifiedResNet's `visual.*` with BatchNorm
    statistics, ConvNeXt's timm spellings (an MLP head's optional bias)."""
    if proj is None:
        jcfg, tcfg = _configs(name)
        params = _seeded(jcfg, seed=71)
    else:
        jcfg, tcfg, params = _convnext_head(proj)
    want = jconvert.params_to_openclip(params, jcfg)
    got = tconvert.params_to_openclip(tinterop.params_from_jax(params), tcfg)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), _np(want[k]), err_msg=k)


@pytest.mark.parametrize("name", ["eva-tiny-test", "vitamin-tiny-test"])
def test_trunk_exports_refused_by_name(name, tmp_path):
    """EVA and ViTamin have no OpenCLIP export here (nor in the JAX
    package), and `--to hf` has no such tower."""
    cfg = tconfig.get_model_config(name)
    sd = tclip.CLIP(cfg).state_dict()
    with pytest.raises(NotImplementedError, match="trunk.*JAX package"):
        tconvert.params_to_openclip(sd, cfg)
    with pytest.raises(ValueError, match="pre_layrnorm"):
        tconvert.save_hf_pretrained(sd, cfg, str(tmp_path / "hf"))
    for rn in ("RN50", "convnext_base_w"):
        with pytest.raises(ValueError, match="CLIPModel has no"):
            tconvert.require_hf_exportable(tconfig.get_model_config(rn))
