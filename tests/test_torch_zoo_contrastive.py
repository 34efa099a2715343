"""leaf_tpu_torch's contrastive trainer on the zoo against the JAX
package's, in fp32 on the CPU at tiny size.

Each vision family takes one step of the JAX package's contrastive step
and of the port's, from the same JAX-initialised weights (the port's copy
by way of `interop.params_from_jax`), on the same seeded images and token
ids, at lr 1e-4: the loss to 1e-5 relative, every parameter to 1e-4, an
attention's key bias (whose true gradient is zero) to 3 lr.  The families:
SigLIP with the sigmoid loss and its logit bias, MobileCLIP's MCi-ViT and
FastViT, ConvNeXt, EVA, ViTamin, Swin, RelPos-ViT, a CLIPA-shaped ViT and
a tiny ModifiedResNet, whose BatchNorm statistics stay as they are in the
port and move in JAX (the port keeps them as buffers on purpose: see
`models/resnet.py::BatchNorm`); then `coca-roberta-tiny-test` through the
CoCa step with its HF text tower.  Also per family: the lock multipliers
(a tower without ViT blocks locks whole, and unlocked groups raise, in
both packages) and the weight-decay mask, leaf for leaf.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from leaf_tpu.models import clip as jclip
from leaf_tpu.models import coca as jcoca
from leaf_tpu.models import config as jconfig
from leaf_tpu.train import contrastive as jcon
from leaf_tpu.train import locking as jlock
from leaf_tpu.train.optim import make_optimizer as jmake_optimizer
from leaf_tpu.train.optim import weight_decay_mask
from leaf_tpu.train.step import TrainState
from leaf_tpu_torch.models import clip as tclip
from leaf_tpu_torch.models import coca as tcoca
from leaf_tpu_torch.models import coca_interop as tcinterop
from leaf_tpu_torch.models import config as tconfig
from leaf_tpu_torch.models import interop as tinterop
from leaf_tpu_torch.models.hf_text import HFTextTower
from leaf_tpu_torch.train import contrastive as tcon
from leaf_tpu_torch.train import locking as tlock
from leaf_tpu_torch.train.optim import is_decay_param, make_optimizer
from tests.test_torch_zoo import _clipa_shaped

torch.set_num_threads(2)

LR = 1e-4
FAMILIES = ["siglip-tiny-test", "mci-vit-tiny-test", "fastvit-tiny-test",
            "convnext-tiny-test", "eva-tiny-test", "vitamin-tiny-test",
            "swin-tiny-test", "relpos-tiny-test", "clipa", "resnet"]
# towers whose top level has no ViT `blocks` stack
WHOLE_LOCK = ("fastvit-tiny-test", "convnext-tiny-test", "swin-tiny-test",
              "resnet")
# towers whose blocks nest deeper than a ViT's
DEEP_BLOCKS = ("eva-tiny-test", "vitamin-tiny-test", "relpos-tiny-test")


def tiny_resnet(config):
    """A ModifiedResNet of one bottleneck a stage, width 8, at 64 pixels,
    beside ViT-tiny-test's text tower (neither registry has a tiny one)."""
    base = config.get_model_config("ViT-tiny-test")
    spec = config.ResNetVisionSpec(layers=(1, 1, 1, 1), width=8,
                                   image_size=64, output_dim=64)
    return dataclasses.replace(
        base, name="resnet-tiny", resnet=spec,
        vision=dataclasses.replace(base.vision, image_size=64, patch_size=32,
                                   width=128, layers=4, output_dim=64))


def configs(name):
    """(JAX config, port config) of a family."""
    if name == "clipa":
        return (_clipa_shaped(jconfig.get_model_config("ViT-tiny-test"), "avg"),
                _clipa_shaped(tconfig.get_model_config("ViT-tiny-test"), "avg"))
    if name == "resnet":
        return tiny_resnet(jconfig), tiny_resnet(tconfig)
    return jconfig.get_model_config(name), tconfig.get_model_config(name)


@functools.lru_cache(maxsize=None)
def _jax_init(name):
    jcfg, _ = configs(name)
    return jclip.init_clip(jax.random.PRNGKey(0), jcfg)


def pair(name):
    """(JAX config, JAX params, port module) holding the same weights (the
    JAX arrays are immutable and shared between the cases)."""
    jcfg, tcfg = configs(name)
    params = _jax_init(name)
    module = tclip.CLIP(tcfg)
    module.load_state_dict(tinterop.params_from_jax(
        jax.tree.map(np.asarray, params)))
    return jcfg, params, module


def batch(cfg, seed, B=4):
    """Seeded images [B, H, W, 3] and token ids [B, context] below the
    tower's vocabulary."""
    rng = np.random.default_rng(seed)
    size = cfg.vision.image_size
    images = rng.standard_normal((B, size, size, 3)).astype(np.float32)
    tokens = rng.integers(1, cfg.text.vocab_size,
                          (B, cfg.text.context_length)).astype(np.int32)
    return images, tokens


def _key_bias(name, value):
    """The slice of an attention's key bias in a parameter, or None: its
    true gradient is zero (the softmax is shift invariant), so Adam turns
    each framework's rounding noise there into a step of up to lr."""
    if name.endswith("qkv_b"):
        d = value.shape[0] // 3
        return np.s_[d:2 * d]
    if name.endswith("kv_b"):                   # SigLIP's MAP head
        return np.s_[:value.shape[0] // 2]
    if name.endswith(".k_b"):                   # ModifiedResNet's pool
        return np.s_[:]
    return None


def assert_params_close(module, params, steps=1, atol=1e-4, lr=LR):
    """Every port parameter within `atol` of JAX's, the key biases within
    3 lr a step."""
    want = tinterop.params_from_jax(jax.tree.map(np.asarray, params))
    got = dict(module.named_parameters())
    assert set(got) <= set(want)
    for k in got:
        g, w = got[k].detach().numpy(), want[k].numpy()
        kb = _key_bias(k, g)
        if kb is not None:
            np.testing.assert_allclose(g[kb], w[kb], atol=3 * steps * lr,
                                       rtol=0, err_msg=k)
            keep = np.ones(g.shape[0], bool)
            keep[kb] = False
            g, w = g[keep], w[keep]
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("name", FAMILIES)
def test_contrastive_step_matches_jax(name):
    """One step: the same loss and parameters.  SigLIP trains on the
    sigmoid loss with its logit bias, which moves; the ModifiedResNet's
    BatchNorm statistics stay bit for bit in the port (a module in train
    mode) and move in JAX, where they are parameters."""
    siglip = name == "siglip-tiny-test"
    jcfg, params, module = pair(name)
    images, tokens = batch(jcfg, 1)
    tx = jmake_optimizer(lambda s: LR, weight_decay=0.2)
    jstep = jcon.make_contrastive_train_step(jcfg, tx, siglip=siglip)
    jstate = TrainState.create(jax.tree.map(jnp.copy, params), tx)
    module.train()
    stats0 = {k: v.clone() for k, v in module.named_buffers()}
    state = tcon.ContrastiveState(module, make_optimizer(
        module.named_parameters(), lambda s: LR))
    jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(tokens))
    state, tm = tcon.make_contrastive_train_step(siglip)(
        state, torch.from_numpy(images), torch.from_numpy(tokens))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert state.step == 1
    assert_params_close(module, jstate.text_params)
    if siglip:
        bias = float(module.logit_bias.detach())
        assert abs(bias - (-10.0)) > LR / 2          # trained
        np.testing.assert_allclose(bias, float(jstate.text_params[
            "logit_bias"]), atol=LR / 10)
        # without the bias the loss is another number
        with torch.no_grad():
            out = module(torch.from_numpy(images), torch.from_numpy(tokens))
        no_bias = tcon.siglip_loss(*tcon.fp32_features(out))
        assert abs(float(no_bias) - float(tm["loss"])) > 1.0
    if name == "resnet":
        want = tinterop.params_from_jax(jax.tree.map(np.asarray,
                                                     jstate.text_params))
        init = tinterop.params_from_jax(jax.tree.map(np.asarray, params))
        stats = [k for k in stats0 if k.endswith((".mean", ".var"))]
        assert len(stats) == 2 * 19    # 3 stem, 4 x 3 + 4 shortcut BNs
        for k in stats:
            assert torch.equal(dict(module.named_buffers())[k], stats0[k]), k
            assert torch.equal(stats0[k], init[k]), k
            assert float((want[k] - init[k]).abs().max()) > 1e-6, k


def _jax_coca_roberta():
    """(JAX config, JAX params) of coca-roberta-tiny-test.  The JAX package
    caches its HF text tower (`leaf_tpu/models/coca.py::_hf_tower_cached`),
    and a tower first built inside a trace (as `tests/
    test_registry_integrity.py` builds it, in the same worker) holds
    tracers: the cache is emptied first."""
    jcoca._hf_tower_cached.cache_clear()
    jcfg = jcoca.get_coca_config("coca-roberta-tiny-test")
    return jcfg, jcoca.init_coca(jax.random.PRNGKey(3), jcfg)


def test_coca_roberta_step_matches_jax():
    """`coca-roberta-tiny-test` through the CoCa step, its RoBERTa tower
    trained with the rest, on seeded ids (its tokenizer needs files that
    neither machine has)."""
    jcfg, params = _jax_coca_roberta()
    tcfg = tcoca.get_coca_config("coca-roberta-tiny-test")
    module = tcoca.CoCa(tcfg)
    module.load_state_dict(tcinterop.coca_params_from_jax(
        jax.tree.map(np.asarray, params)))
    assert isinstance(module.text, HFTextTower)
    rng = np.random.default_rng(5)
    images = rng.standard_normal((3, 64, 64, 3)).astype(np.float32)
    tokens = rng.integers(3, 99, (3, 16)).astype(np.int32)
    tokens[1, 10:] = 1
    tx = jmake_optimizer(lambda s: LR, weight_decay=0.2)
    jstate = TrainState.create(jax.tree.map(jnp.copy, params), tx)
    jstate, jm = jcon.make_coca_train_step(jcfg, tx)(
        jstate, jnp.asarray(images), jnp.asarray(tokens))
    state = tcon.ContrastiveState(module.train(), make_optimizer(
        module.named_parameters(), lambda s: LR, weight_decay=0.2))
    text0 = {k: v.detach().clone() for k, v in
             module.text.named_parameters()}
    state, tm = tcon.make_coca_train_step()(state, torch.from_numpy(images),
                                            torch.from_numpy(tokens))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    want = tcinterop.coca_params_from_jax(jax.tree.map(np.asarray,
                                                       jstate.text_params))
    got = module.state_dict()
    assert set(got) == set(want)
    for k in want:
        g, w = got[k].detach().numpy(), want[k].numpy()
        kb = _key_bias(k, g)
        if kb is not None:
            np.testing.assert_allclose(g[kb], w[kb], atol=3 * LR, err_msg=k)
            keep = np.ones(g.shape[0], bool)
            keep[kb] = False
            g, w = g[keep], w[keep]
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0, err_msg=k)
    moved = [k for k, v in module.text.named_parameters()
             if not torch.equal(v, text0[k])]
    assert len(moved) > len(text0) // 2        # the HF tower trained


# ---------------------------------------------------------------------------
# locking and the decay mask
# ---------------------------------------------------------------------------

def _jax_by_port_name(tree, params):
    """A JAX tree of multipliers or mask bits, broadcast to each
    parameter's shape and un-stacked like the parameters: {port name: the
    distinct values}."""
    full = jax.tree.map(lambda m, p: np.broadcast_to(
        np.asarray(m, np.float32), np.shape(p)).copy(), tree, params)
    return {k: np.unique(v.numpy()).tolist() for k, v in
            tinterop.params_from_jax(full).items()}


@pytest.mark.parametrize("groups", [0, 1, 2])
@pytest.mark.parametrize("name", FAMILIES)
def test_lock_multipliers_match_jax(name, groups):
    """`--lock-image` with 0, 1 or 2 unlocked groups: the ViT groups on
    every tower with a `blocks` stack (MobileCLIP's MCi-ViT included, its
    other parts in the stem as in JAX); a tower without one locks whole
    and refuses unlocked groups, in both packages; where the blocks nest
    deeper (EVA, ViTamin, RelPos-ViT) the JAX rule fails, and the port
    refuses."""
    jcfg, params, module = pair(name)
    kw = dict(lock_image=True, lock_image_unlocked_groups=groups)
    if name in DEEP_BLOCKS:
        # JAX's per-layer rule fails on their nested block parameters
        with pytest.raises(AttributeError):
            jlock.lock_multipliers(params, **kw)
        with pytest.raises(NotImplementedError, match="JAX package as here"):
            tlock.lock_multipliers(module, **kw)
        return
    if groups and name in WHOLE_LOCK:
        with pytest.raises(ValueError, match="implemented for ViT towers"):
            jlock.lock_multipliers(params, **kw)
        with pytest.raises(ValueError, match="implemented for ViT towers"):
            tlock.lock_multipliers(module, **kw)
        return
    want = _jax_by_port_name(jlock.lock_multipliers(params, **kw), params)
    got = tlock.lock_multipliers(module, **kw)
    assert set(got) <= set(want)
    for k, v in got.items():
        assert want[k] == [v], k
    visual = [v for k, v in got.items() if k.startswith("visual.")]
    assert (sum(visual) == 0) == (groups == 0 or name in WHOLE_LOCK)


def test_hf_text_tower_locks_whole_as_in_jax():
    """`--lock-text` on an HF text tower (CoCa's RoBERTa): locked whole,
    its LayerNorms following `freeze_layer_norm`, as in JAX; unlocked
    layers raise in both."""
    _, params = _jax_coca_roberta()
    module = tcoca.CoCa(tcoca.get_coca_config("coca-roberta-tiny-test"))
    for freeze in (True, False):
        kw = dict(lock_text=True, lock_text_freeze_layer_norm=freeze)
        full = jax.tree.map(lambda m, p: np.broadcast_to(
            np.asarray(m, np.float32), np.shape(p)).copy(),
            jlock.lock_multipliers(params, **kw), params)
        want = {k: np.unique(v.numpy()).tolist() for k, v in
                tcinterop.coca_params_from_jax(full).items()}
        got = tlock.lock_multipliers(module, **kw)
        assert set(got) <= set(want)
        for k, v in got.items():
            assert want[k] == [v], k
        text = [v for k, v in got.items() if k.startswith("text.")]
        assert any(text) == (not freeze) and not all(text)
    kw = dict(lock_text=True, lock_text_unlocked_layers=1)
    with pytest.raises(ValueError, match="native text tower"):
        jlock.lock_multipliers(params, **kw)
    with pytest.raises(ValueError, match="native text tower"):
        tlock.lock_multipliers(module, **kw)


@pytest.mark.parametrize("name", FAMILIES)
def test_decay_mask_matches_jax(name):
    """The decayed parameters of each family, name for name, are those
    that JAX's `weight_decay_mask` marks; JAX also decays the ResNet's
    BatchNorm statistics, which are its parameters and the port's
    buffers."""
    jcfg, params, module = pair(name)
    want = _jax_by_port_name(weight_decay_mask(params), params)
    names = [k for k, _ in module.named_parameters()]
    for k in names:
        assert want[k] == [float(is_decay_param(k))], k
    assert 0 < sum(map(is_decay_param, names)) < len(names)
    stats = set(want) - set(names)
    assert bool(stats) == (name == "resnet")
    for k in stats:
        assert k.endswith((".mean", ".var")) and want[k] == [1.0], k
