"""leaf_tpu_torch's CLIP towers and weight interop against the JAX
package, in fp32 on the CPU (the JAX side at the conftest's `highest`
matmul precision).

The same JAX-initialised parameters go through both packages, the
port's copy by way of `interop.params_from_jax`.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from leaf_tpu.models import clip as jclip
from leaf_tpu.models import config as jconfig
from leaf_tpu.models import interop as jinterop
from leaf_tpu_torch.models import clip as tclip
from leaf_tpu_torch.models import config as tconfig
from leaf_tpu_torch.models import interop as tinterop
from leaf_tpu_torch.models.factory import create_model

torch.set_num_threads(2)

MODEL = "ViT-tiny-test"
TOL = dict(atol=1e-5, rtol=1e-4)


def _configs(quick_gelu: bool):
    j = jconfig.get_model_config(MODEL)
    t = tconfig.get_model_config(MODEL)
    return (dataclasses.replace(j, quick_gelu=quick_gelu),
            dataclasses.replace(t, quick_gelu=quick_gelu))


@pytest.fixture(scope="module", params=[False, True], ids=["gelu", "quickgelu"])
def pair(request):
    """(JAX config, JAX params, port module) holding the same weights."""
    jcfg, tcfg = _configs(request.param)
    params = jclip.init_clip(jax.random.PRNGKey(0), jcfg)
    module = tclip.CLIP(tcfg)
    module.load_state_dict(tinterop.params_from_jax(
        jax.tree.map(np.asarray, params)))
    return jcfg, params, module.eval()


def _tokens(rng, B, S):
    """B caption-like rows: SOT, random ids, EOT at a random position
    (at least one row ends at the last slot), zero padding."""
    toks = np.zeros((B, S), np.int32)
    ends = rng.integers(1, S, size=B)
    ends[0] = S - 1
    for i, e in enumerate(ends):
        toks[i, 0] = 49406
        toks[i, 1:e] = rng.integers(1, 49400, size=e - 1)
        toks[i, e] = 49407
    return toks


@pytest.mark.parametrize("pack", [True, False], ids=["packed", "unpacked"])
@pytest.mark.parametrize("S", [16, 32, 48, 64, 77])
def test_encode_text_matches_jax(pair, S, pack):
    jcfg, params, module = pair
    tokens = _tokens(np.random.default_rng(S), 16, S)
    want = jclip.encode_text(params["text"], jcfg.text, jnp.asarray(tokens),
                             jcfg.quick_gelu, pack=pack)
    with torch.no_grad():
        got = module.encode_text(torch.from_numpy(tokens), pack=pack)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_packed_equals_unpacked(pair):
    _, _, module = pair
    tokens = torch.from_numpy(_tokens(np.random.default_rng(7), 16, 16))
    with torch.no_grad():
        np.testing.assert_allclose(
            module.encode_text(tokens, normalize=True).numpy(),
            module.encode_text(tokens, normalize=True, pack=False).numpy(),
            atol=1e-6)


def test_encode_image_matches_jax(pair):
    jcfg, params, module = pair
    images = np.random.default_rng(1).standard_normal(
        (4, 64, 64, 3)).astype(np.float32)
    for normalize in (False, True):
        want = jclip.encode_image(params["visual"], jcfg.vision,
                                  jnp.asarray(images), jcfg.quick_gelu,
                                  normalize)
        with torch.no_grad():
            got = module.encode_image(torch.from_numpy(images), normalize)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_attention_mask_path_equals_packed_path():
    """`layers.attention` with `packed` set (the packed-attention op)
    equals the additive-mask path fed `clip.packed_block_mask`."""
    from leaf_tpu_torch.models import layers
    rng = np.random.default_rng(2)
    D, H, S, G = 32, 4, 8, 4
    p = {k: torch.from_numpy((0.2 * rng.standard_normal(s)).astype(np.float32))
         for k, s in (("qkv_w", (D, 3 * D)), ("qkv_b", (3 * D,)),
                      ("out_w", (D, D)), ("out_b", (D,)))}
    x = torch.from_numpy(rng.standard_normal((3, G * S, D)).astype(np.float32))
    for causal in (True, False):
        mask = torch.from_numpy(tclip.packed_block_mask(S, G, causal).copy())
        np.testing.assert_allclose(
            layers.attention(p, x, None, H, packed=(S, causal)).numpy(),
            layers.attention(p, x, mask, H).numpy(), atol=1e-6)
    np.testing.assert_array_equal(tclip.causal_mask(S),
                                  jclip.causal_mask(S))


def openclip_state_dict(cfg, seed: int = 0):
    """A random OpenCLIP-format CLIP-ViT state dict (numpy) for `cfg`."""
    rng = np.random.default_rng(seed)
    t, v = cfg.text, cfg.vision

    def w(*shape, std=0.05):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    def ln(prefix, width):
        return {f"{prefix}.weight": 1 + w(width), f"{prefix}.bias": w(width)}

    def blocks(prefix, layers, width):
        sd = {}
        for i in range(layers):
            b = f"{prefix}.resblocks.{i}."
            sd.update(ln(b + "ln_1", width))
            sd.update(ln(b + "ln_2", width))
            mlp = int(width * 4)
            sd.update({
                b + "attn.in_proj_weight": w(3 * width, width),
                b + "attn.in_proj_bias": w(3 * width),
                b + "attn.out_proj.weight": w(width, width),
                b + "attn.out_proj.bias": w(width),
                b + "mlp.c_fc.weight": w(mlp, width),
                b + "mlp.c_fc.bias": w(mlp),
                b + "mlp.c_proj.weight": w(width, mlp),
                b + "mlp.c_proj.bias": w(width)})
        return sd

    sd = {"token_embedding.weight": w(t.vocab_size, t.width),
          "positional_embedding": w(t.context_length, t.width),
          "text_projection": w(t.width, cfg.embed_dim, std=0.2),
          "logit_scale": np.asarray(4.6, np.float32),
          "visual.conv1.weight": w(v.width, 3, v.patch_size, v.patch_size),
          "visual.class_embedding": w(v.width),
          "visual.positional_embedding": w(v.num_tokens, v.width),
          "visual.proj": w(v.width, cfg.embed_dim, std=0.2)}
    sd.update(ln("ln_final", t.width))
    sd.update(ln("visual.ln_pre", v.width))
    sd.update(ln("visual.ln_post", v.width))
    sd.update(blocks("transformer", t.layers, t.width))
    sd.update(blocks("visual.transformer", v.layers, v.width))
    return sd


def test_openclip_interop_matches_jax():
    jcfg, tcfg = _configs(False)
    sd = openclip_state_dict(jcfg)
    want = tinterop.params_from_jax(jinterop.openclip_to_params(sd, jcfg))
    got = tinterop.openclip_to_params(
        {"module." + k: torch.from_numpy(a) for k, a in sd.items()}, tcfg)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].is_contiguous(), k
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), k)
    # and the converted weights load into the module with nothing missing
    tclip.CLIP(tcfg).load_state_dict(got)


def test_create_model_is_seeded_and_casts_once():
    a = create_model(MODEL, seed=3, device="cpu").module.state_dict()
    b = create_model(MODEL, seed=3, device="cpu").module.state_dict()
    c = create_model(MODEL, seed=4, device="cpu").module.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["text.token_embedding"], c["text.token_embedding"])
    # init distributions of the JAX package
    assert abs(a["text.token_embedding"].std().item() - 0.02) < 1e-3
    assert torch.all(a["text.blocks.0.ln_1.scale"] == 1)
    assert torch.all(a["text.blocks.0.attn.qkv_b"] == 0)
    bf = create_model(MODEL, precision="bf16", seed=3,
                      device="cpu").module.state_dict()
    for k, t in bf.items():
        fp32 = k.endswith((".scale", "ln_1.bias", "ln_2.bias", "ln_final.bias",
                           "ln_pre.bias", "ln_post.bias")) or k == "logit_scale"
        assert t.dtype == (torch.float32 if fp32 else torch.bfloat16), k
        assert torch.equal(t, a[k].to(t.dtype)), k


def test_every_layer_norm_goes_through_the_op(pair, monkeypatch):
    """Each LayerNorm outside the fused block (`ln_2` of every layer,
    `ln_final`; `ln_pre`, `ln_post`) calls the dispatching `layer_norm` op,
    which launches the kernel on a card: layers + 1 calls per text encode,
    layers + 2 per image encode, on contiguous activations with the fp32
    parameters.  The block's own `ln_1` runs inside the fused block."""
    from leaf_tpu_torch.models import layers as tlayers
    jcfg, _, module = pair
    seen = []
    op = tlayers.layer_norm

    def spy(x, scale, bias, eps=1e-5):
        seen.append((x.is_contiguous(), scale.dtype, bias.dtype, eps))
        return op(x, scale, bias, eps)

    monkeypatch.setattr(tlayers, "layer_norm", spy)
    rng = np.random.default_rng(11)
    with torch.no_grad():
        module.encode_text(torch.from_numpy(_tokens(rng, 16, 16)))
        assert len(seen) == jcfg.text.layers + 1
        del seen[:]
        size = jcfg.vision.image_size
        module.encode_image(torch.from_numpy(
            rng.standard_normal((2, size, size, 3)).astype(np.float32)))
        assert len(seen) == jcfg.vision.layers + 2
    assert all(call == (True, torch.float32, torch.float32, jcfg.text.ln_eps)
               for call in seen)
