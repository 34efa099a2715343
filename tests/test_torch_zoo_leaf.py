"""leaf_tpu_torch's LEAF trainer on the zoo's text towers, and its
in-training eval's PGD through every vision family, against the JAX
package, in fp32 on the CPU at tiny size.

The LEAF trainer trains the text tower of every model with a native one
(`factory.require_trainable`).  The towers differ in three ways, each held
here by two fused steps (`train.fused.FusedLeafStep`, the driver's
default) against the JAX package's, from the same JAX-initialised weights,
captions and generator seed: the same positions, characters, winners and
adversarial sentences, losses to 1e-5 relative, parameters to 1e-4 (the
key bias to 3 lr a step):
- a SigLIP-style tower: non-causal, 'last'-pooled, a projection bias
  (siglip-tiny-test's text config at the CLIP BPE's vocabulary and
  context, so that the BPE tokenizer drives it); no bucketing;
- a CLIPA-style tower: non-causal, 'last'-pooled, no projection bias;
- the 640-wide causal tower of convnext_base_w, RN50x4 and Swin-B (cut to
  two layers), bucketed as in JAX.

The eval's PGD (`attacks.image.attack_image_classification`, the
input's gradient through the frozen vision tower) and the embedding
objective's (`attack_image`) are held for one tiny model of every vision
family against `leaf_tpu/attacks/image.py`, from JAX's uniform start: at
most 1% of pixels differ by more than 1e-6 (a sign flip on a near-zero
gradient), every pixel within eps.
"""
import copy
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from leaf_tpu.attacks import image as jimage
from leaf_tpu.models import clip as jclip
from leaf_tpu.models import config as jconfig
from leaf_tpu.tokenizer import get_tokenizer as jax_tokenizer
from leaf_tpu.train import fused as jfused
from leaf_tpu.train import optim as joptim
from leaf_tpu.train import step as jstep
from leaf_tpu_torch.attacks import image as timage
from leaf_tpu_torch.attacks.engine import can_bucket
from leaf_tpu_torch.models import clip as tclip
from leaf_tpu_torch.models import config as tconfig
from leaf_tpu_torch.models import interop as tinterop
from leaf_tpu_torch.tokenizer import get_tokenizer as port_tokenizer
from leaf_tpu_torch.train import fused as tfused
from leaf_tpu_torch.train import optim as toptim
from leaf_tpu_torch.train import step as tstep
from tests.test_torch_zoo import _clipa_shaped
from tests.test_torch_zoo_contrastive import FAMILIES, pair

torch.set_num_threads(2)

LR = 1e-4
OPT = dict(weight_decay=1e-4, beta1=0.9, beta2=0.98, eps=1e-6)
TEXTS = ["a photo of a cat", "stocks rally on earnings",
         "the match ended in a draw", "hello world"]
MORE = ["another day at the office", "rain over the hills",
        "a plate of pasta", "two dogs playing"]
EPS = 2 / 255


def _text_config(config, kind):
    """ViT-tiny-test with the text tower of `kind` in the given package's
    config module (only the text tower trains)."""
    base = config.get_model_config("ViT-tiny-test")
    if kind == "siglip":
        text = dataclasses.replace(
            config.get_model_config("siglip-tiny-test").text,
            vocab_size=49408, context_length=77)
        return dataclasses.replace(base, name="siglip-text", text=text)
    if kind == "clipa":
        return _clipa_shaped(base, "avg")
    text = dataclasses.replace(
        config.get_model_config("convnext_base_w").text, layers=2)
    return dataclasses.replace(base, name="d640-text", text=text,
                               embed_dim=text.output_dim)


@functools.lru_cache(maxsize=None)
def _jax_text(kind):
    jcfg = _text_config(jconfig, kind)
    return jcfg, jclip.init_clip(jax.random.PRNGKey(0), jcfg)["text"]


def _jax_run(kind, batches, seed, rho):
    jcfg, jtext = _jax_text(kind)
    tx = joptim.make_optimizer(lambda s: jnp.asarray(LR), **OPT)
    fused = jfused.FusedLeafStep(jcfg, tx, jax_tokenizer(), rho=rho)
    state = jstep.TrainState.create(jax.tree.map(jnp.copy, jtext), tx)
    frozen = jax.tree.map(jnp.copy, jtext)
    rng = np.random.default_rng(seed)
    out = []
    for texts in batches:
        state, info = fused(state, frozen, list(texts), rng)
        out.append({"best_pos": list(info["best_pos"]),
                    "us": np.asarray(info["us"]),
                    "adv": fused.adv_sentences(list(texts), info),
                    "loss": float(info["metrics"]["loss"])})
    return out, state.text_params


def _port_run(kind, batches, seed, rho):
    _, jtext = _jax_text(kind)
    tcfg = _text_config(tconfig, kind)
    text = tclip.TextTower(tcfg.text, tcfg.quick_gelu)
    text.load_state_dict({k[len("text."):]: v for k, v in
                          tinterop.params_from_jax(jax.tree.map(
                              np.asarray, {"text": jtext})).items()})
    frozen = copy.deepcopy(text).requires_grad_(False)
    opt = toptim.make_optimizer(text.named_parameters(), lambda s: LR, **OPT)
    state = tstep.TrainState.create(text, opt)
    fused = tfused.FusedLeafStep(tcfg, port_tokenizer(), rho=rho,
                                 device="cpu")
    rng = np.random.default_rng(seed)
    out = []
    for texts in batches:
        state, info = fused(state, frozen, list(texts), rng)
        out.append({"best_pos": list(info["best_pos"]),
                    "us": np.asarray(info["us"]),
                    "adv": fused.adv_sentences(list(texts), info),
                    "loss": float(info["metrics"]["loss"])})
    return out, state, fused


@pytest.mark.parametrize("kind", ["siglip", "clipa", "d640"])
def test_fused_leaf_step_matches_jax(kind):
    """Two fused steps (the second on new captions; both pipelined over
    half-batches): the same decisions, losses and text-tower parameters."""
    batches = [TEXTS, MORE]
    want, jparams = _jax_run(kind, batches, 7, rho=5)
    got, state, fused = _port_run(kind, batches, 7, rho=5)
    for g, w in zip(got, want):
        assert g["best_pos"] == w["best_pos"]
        np.testing.assert_array_equal(g["us"], w["us"])
        assert g["adv"] == w["adv"]
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
    assert state.step == 2
    assert any(a != t for a, t in zip(got[0]["adv"], TEXTS))
    # bucketing only where the pooled feature cannot see the padding
    assert fused._do_bucket == can_bucket(_text_config(tconfig, kind)) \
        == (kind == "d640")
    tcfg = _text_config(tconfig, kind)
    assert (state.text.text_projection_bias is not None) == (kind == "siglip")
    assert tcfg.text.no_causal_mask == (kind != "d640")
    want_p = tinterop.params_from_jax(jax.tree.map(np.asarray,
                                                   {"text": jparams}))
    for name, p in state.text.named_parameters():
        g, w = p.detach().numpy(), want_p[f"text.{name}"].numpy()
        if name.endswith("attn.qkv_b"):
            third = len(w) // 3
            np.testing.assert_allclose(g[third:2 * third], w[third:2 * third],
                                       atol=3 * 2 * LR, rtol=0, err_msg=name)
            g = np.delete(g, np.s_[third:2 * third])
            w = np.delete(w, np.s_[third:2 * third])
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("name", FAMILIES)
def test_eval_pgd_through_every_vision_family_matches_jax(name):
    """The in-training eval's zero-shot PGD (3 sign steps from JAX's
    uniform start) through the frozen vision tower of each family: the
    input's gradient alone, the tower's weights untouched."""
    jcfg, params, module = pair(name)
    module.eval().requires_grad_(False)
    size = jcfg.vision.image_size
    rng = np.random.default_rng(11)
    images = rng.uniform(0, 1, (3, size, size, 3)).astype(np.float32)
    classifier = rng.standard_normal((jcfg.embed_dim, 5)).astype(np.float32)
    classifier /= np.linalg.norm(classifier, axis=0, keepdims=True)
    labels = np.asarray([0, 3, 4])
    key = jax.random.PRNGKey(3)
    start = np.array(EPS * (2 * jax.random.uniform(key, images.shape,
                                                   jnp.float32) - 1))
    want = np.asarray(jimage.attack_image_classification(
        params, jcfg, jnp.asarray(images), jnp.asarray(classifier),
        jnp.asarray(labels), key, n_steps=3))
    before = {k: v.clone() for k, v in module.state_dict().items()}
    got = timage.attack_image_classification(
        module.visual, module.cfg, torch.from_numpy(images),
        torch.from_numpy(classifier), torch.from_numpy(labels), n_steps=3,
        delta=torch.from_numpy(start)).detach().numpy()
    assert float(np.mean(np.abs(got - want) > 1e-6)) <= 0.01
    assert float(np.abs(got - images).max()) <= EPS + 1e-6
    assert float(np.abs(want - images).max()) <= EPS + 1e-6
    assert float(np.abs(got - (images + start)).max()) > EPS / 10   # moved
    for k, v in module.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("name", FAMILIES)
def test_embedding_pgd_through_every_vision_family_matches_jax(name):
    """`attack_image`'s embedding-objective PGD (l2, 2 sign steps from JAX's
    uniform start) through the frozen vision tower of each family, against
    `leaf_tpu/attacks/image.py::attack_image`."""
    jcfg, params, module = pair(name)
    module.eval().requires_grad_(False)
    size = jcfg.vision.image_size
    rng = np.random.default_rng(12)
    images = rng.uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    anchors = rng.standard_normal((2, jcfg.embed_dim)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    start = np.array(EPS * (2 * jax.random.uniform(key, images.shape,
                                                   jnp.float32) - 1))
    want = np.asarray(jimage.attack_image(
        params, jcfg, jnp.asarray(images), jnp.asarray(anchors), key,
        n_steps=2))
    got = timage.attack_image(
        module.visual, module.cfg, torch.from_numpy(images),
        torch.from_numpy(anchors), n_steps=2,
        delta=torch.from_numpy(start)).detach().numpy()
    assert float(np.mean(np.abs(got - want) > 1e-6)) <= 0.01
    assert float(np.abs(got - images).max()) <= EPS + 1e-6
    assert float(np.abs(got - (images + start)).max()) > EPS / 10   # moved
