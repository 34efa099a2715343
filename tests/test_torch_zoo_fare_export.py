"""leaf_tpu_torch's FARE trainer on the ViT family's zoo, and the OpenCLIP
export of the ViT zoo, against the JAX package, in fp32 on the CPU.

FARE trains the ViT family, as the JAX package's `fare.encode_vision`
does (`clip.encode_image` on `cfg.vision`): one step each at
siglip-tiny-test (the MAP head, no class token, a patch bias, images
normalised with SigLIP's 0.5/0.5) and at a CLIPA-shaped config (no
`ln_pre`, pool then `ln_post`), against `leaf_tpu/train/fare.py`: losses
to 1e-5, parameters to 1e-4 (the key bias to 2 lr).

The export (`convert.params_to_openclip`) writes, key for key and value
for value, what JAX's writes at the CLIPA-shaped config and at a
SigLIP-style text tower (the Linear projection's `text_projection.weight`
and `.bias`, `logit_bias`); the port reads it back to the same features.
SigLIP's MAP head, a patch bias, a vision projection bias and timm's MLP
head still raise: JAX writes no key for them.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from leaf_tpu import convert as jconvert
from leaf_tpu.models import clip as jclip
from leaf_tpu.models import config as jconfig
from leaf_tpu.train import fare as jfare
from leaf_tpu.train.step import TrainState
from leaf_tpu_torch import convert as tconvert
from leaf_tpu_torch.models import clip as tclip
from leaf_tpu_torch.models import config as tconfig
from leaf_tpu_torch.models import interop as tinterop
from leaf_tpu_torch.train import fare as tfare
from tests.test_torch_fare import _configs
from tests.test_torch_zoo import _clipa_shaped

torch.set_num_threads(2)

EPS = 8 / 255
LR = 1e-4


def _cfgs(name):
    if name == "clipa":
        return (_clipa_shaped(jconfig.get_model_config("ViT-tiny-test"), "avg"),
                _clipa_shaped(tconfig.get_model_config("ViT-tiny-test"), "avg"))
    if name == "siglip-text":
        def siglip_text(config):
            base = config.get_model_config("ViT-tiny-test")
            return dataclasses.replace(
                base, name="siglip-text", init_logit_bias=-10.0,
                text=config.get_model_config("siglip-tiny-test").text)
        return siglip_text(jconfig), siglip_text(tconfig)
    return jconfig.get_model_config(name), tconfig.get_model_config(name)


def _pair(name, seed=0):
    jcfg, tcfg = _cfgs(name)
    params = jclip.init_clip(jax.random.PRNGKey(seed), jcfg)
    module = tclip.CLIP(tcfg)
    module.load_state_dict(tinterop.params_from_jax(
        jax.tree.map(np.asarray, params)))
    return jcfg, params, module.eval()


@pytest.mark.parametrize("name", ["siglip-tiny-test", "clipa"])
def test_fare_step_matches_jax(name):
    """One FARE step (clean weight 0.5, so that both encodes train) on
    perturbed images against embeddings of other images."""
    jcfg, params, module = _pair(name)
    fcfg, jfcfg = _configs(clean_weight=0.5)
    rng = np.random.default_rng(4)
    images = rng.uniform(0.2, 0.8, (2, 64, 64, 3)).astype(np.float32)
    adv = np.clip(images + EPS * rng.choice([-1, 1], images.shape), 0, 1
                  ).astype(np.float32)
    targets, clf = np.array([1, 3]), np.zeros((jcfg.embed_dim, 5), np.float32)
    orig = np.array(jfare.encode_vision(
        params["visual"], jcfg, jnp.asarray(np.roll(images, 1, axis=0)),
        False))
    tx = jfare.make_fare_optimizer(jfcfg)
    state = TrainState.create(jax.tree.map(jnp.copy, params["visual"]), tx)
    state, want = jfare.make_fare_train_step(jcfg, jfcfg, tx)(
        state, jnp.asarray(orig), jnp.asarray(images), jnp.asarray(adv),
        jnp.asarray(targets), jnp.asarray(clf))
    visual = module.visual
    with torch.no_grad():
        np.testing.assert_allclose(tfare.encode_vision(
            visual, module.cfg, torch.from_numpy(np.roll(images, 1, axis=0)),
            False).numpy(), orig, atol=1e-5)
    opt = tfare.make_fare_optimizer(visual.parameters(), fcfg)
    got = tfare.make_fare_train_step(visual, module.cfg, fcfg, opt)(
        0, torch.from_numpy(orig), torch.from_numpy(images),
        torch.from_numpy(adv), torch.from_numpy(targets),
        torch.from_numpy(clf))
    for k in ("loss", "loss_clean", "cos_sim"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert float(got["loss"]) > 0
    want_sd = tinterop.params_from_jax(
        {"visual": jax.tree.map(np.asarray, state.text_params)})
    got_sd = {f"visual.{k}": v for k, v in visual.state_dict().items()}
    assert sorted(got_sd) == sorted(want_sd)
    for k in want_sd:
        g, w = got_sd[k].numpy(), want_sd[k].numpy()
        if k.endswith("qkv_b"):
            d = g.shape[0] // 3
            np.testing.assert_allclose(g[d:2 * d], w[d:2 * d], atol=2 * LR,
                                       err_msg=k)
            g, w = np.delete(g, np.s_[d:2 * d]), np.delete(w, np.s_[d:2 * d])
        elif k.endswith("attn_pool.kv_b"):
            h = g.shape[0] // 2
            np.testing.assert_allclose(g[:h], w[:h], atol=2 * LR, err_msg=k)
            g, w = g[h:], w[h:]
        np.testing.assert_allclose(g, w, atol=1e-4, err_msg=k)
    if name == "siglip-tiny-test":
        assert module.cfg.image_mean == (0.5, 0.5, 0.5)


@pytest.mark.parametrize("name", ["clipa", "siglip-text"])
def test_openclip_export_matches_jax_and_reloads(name):
    jcfg, params, module = _pair(name, seed=2)
    want = jconvert.params_to_openclip(params, jcfg)
    got = tconvert.params_to_openclip(module.state_dict(), module.cfg)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    if name == "clipa":
        assert "visual.ln_pre.weight" not in got
    else:
        assert {"text_projection.weight", "text_projection.bias",
                "logit_bias"} <= set(got) and "text_projection" not in got
    back = tclip.CLIP(module.cfg)
    back.load_state_dict(tinterop.openclip_to_params(got, module.cfg))
    back.eval()
    rng = np.random.default_rng(3)
    images = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    tokens = rng.integers(1, module.cfg.text.vocab_size, (3, 16)).astype(
        np.int32)
    with torch.no_grad():
        a = module(torch.from_numpy(images), torch.from_numpy(tokens))
        b = back(torch.from_numpy(images), torch.from_numpy(tokens))
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k].detach().numpy(),
                                      b[k].detach().numpy(), err_msg=k)


def test_openclip_export_refuses_what_jax_drops():
    """SigLIP's MAP head and patch bias, a vision projection bias and
    timm's MLP head: the JAX export writes no key for them."""
    cfg = tconfig.get_model_config("siglip-tiny-test")
    with pytest.raises(NotImplementedError,
                       match="visual.patch_bias, attn_pool.*Queue 3"):
        tconvert.params_to_openclip(tclip.CLIP(cfg).state_dict(), cfg)
    cfg = tconfig.get_model_config("ViT-tiny-test")
    sd = tclip.CLIP(cfg).state_dict()
    with pytest.raises(NotImplementedError, match="visual.proj_bias"):
        tconvert.params_to_openclip(
            {**sd, "visual.proj_bias": torch.zeros(64)}, cfg)
    mlp = {k: v for k, v in sd.items() if k != "visual.proj"}
    mlp["visual.head_mlp.fc_w"] = torch.zeros(64, 64)
    with pytest.raises(NotImplementedError, match="visual.proj, head_mlp"):
        tconvert.params_to_openclip(mlp, cfg)
