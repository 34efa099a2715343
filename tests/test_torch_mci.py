"""leaf_tpu_torch's MobileCLIP trunks (`models/mci.py`: the MCi hybrid ViT
and FastViT in deploy form) against the JAX package, in fp32 on the CPU:
the tiny towers from the same weights, the four branch fusions against an
explicit multi-branch forward (the oracle of `tests/test_mci.py`, copied),
the fused pytrees leaf for leaf, OpenCLIP `visual.trunk.*` checkpoints in
train and deploy form through both packages, and the hybrid ViT against a
torch forward written from the published architecture.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch
from torch.nn import functional as F

import jax
import jax.numpy as jnp

from leaf_tpu.models import clip as jclip
from leaf_tpu.models import config as jconfig
from leaf_tpu.models import interop as jinterop
from leaf_tpu.models import mci as jmci
from leaf_tpu_torch.models import clip as tclip
from leaf_tpu_torch.models import config as tconfig
from leaf_tpu_torch.models import interop as tinterop
from leaf_tpu_torch.models import mci as tmci
from leaf_tpu_torch.models import trunks

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-4)
TOL_CONV = dict(atol=1e-4, rtol=1e-4)


def _np(t):
    return np.asarray(t, np.float32)


def _images(seed, B, size):
    return np.random.default_rng(seed).random(
        (B, size, size, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# Towers at tiny size
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mci-vit-tiny-test", "fastvit-tiny-test"])
def test_tiny_towers_match_jax(name):
    jcfg, tcfg = jconfig.get_model_config(name), tconfig.get_model_config(name)
    params = jclip.init_clip(jax.random.PRNGKey(0), jcfg)
    module = tclip.CLIP(tcfg)
    sd = tinterop.params_from_jax(jax.tree.map(np.asarray, params))
    module.load_state_dict(sd)
    module.eval()
    # the layouts meet in params_from_jax: HWIO there, OIHW here
    stem_w = np.asarray(params["visual"]["stem"][0]["w"])
    np.testing.assert_array_equal(sd["visual.stem.0.w"].numpy(),
                                  stem_w.transpose(3, 2, 0, 1))
    images = _images(1, 3, 32)
    tokens = np.random.default_rng(2).integers(1, 512, (4, 16)).astype(np.int32)
    want_i = jclip.encode_image_model(params, jcfg, jnp.asarray(images),
                                      normalize=True)
    want_t = jclip.encode_text(params["text"], jcfg.text, jnp.asarray(tokens))
    with torch.no_grad():
        got_i = module.encode_image(torch.from_numpy(images), normalize=True)
        got_t = module.encode_text(torch.from_numpy(tokens))
    np.testing.assert_allclose(got_i.numpy(), _np(want_i), **TOL_CONV)
    np.testing.assert_allclose(got_t.numpy(), _np(want_t), **TOL)


def test_seeded_init_and_factory():
    """The port's own seeded init gives finite, unit-norm features through
    the factory (bf16 casts the trunk's weights, LayerNorms stay fp32),
    and the same seed gives the same weights."""
    from leaf_tpu_torch.models.factory import create_model
    for name in ("mci-vit-tiny-test", "fastvit-tiny-test"):
        a = create_model(name, precision="fp32", seed=3, device="cpu")
        b = create_model(name, precision="bf16", seed=3, device="cpu")
        x = _images(4, 2, 32)
        with torch.no_grad():
            fa = a.encode_image(x, normalize=True)
            fb = b.encode_image(x, normalize=True)
        assert fb.dtype == torch.bfloat16
        assert torch.isfinite(fa).all()
        np.testing.assert_allclose(fa.norm(dim=-1).numpy(), 1.0, atol=1e-5)
        cos = (fa * fb.float()).sum(-1)
        assert float(cos.min()) > 0.99
    assert b.module.visual.stem[0].w.dtype == torch.bfloat16


def _runnable_tiny(monkeypatch, name):
    """Register, under `name`, what one driver step of it runs on: the tiny
    text tower widened to the CLIP BPE tokenizer's 49,408 ids and 77 tokens
    (the tiny configs have 512 and 16), and RN50 cut to a tiny
    ModifiedResNet of the same family
    (`tests/test_torch_zoo_contrastive.py::tiny_resnet`)."""
    from tests.test_torch_zoo_contrastive import tiny_resnet
    cfg = (dataclasses.replace(tiny_resnet(tconfig), name=name)
           if name == "RN50" else tconfig.get_model_config(name))
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, vocab_size=49408, context_length=77))
    monkeypatch.setitem(tconfig._REGISTRY, name, cfg)
    return cfg


@pytest.mark.parametrize("name", ["fastvit-tiny-test", "siglip-tiny-test",
                                  "RN50", "convnext-tiny-test",
                                  "eva-tiny-test", "vitamin-tiny-test",
                                  "swin-tiny-test", "relpos-tiny-test",
                                  "nllb-clip-base"])
@pytest.mark.parametrize("trainer", ["driver", "fare_driver",
                                     "contrastive_driver"])
def test_trainers_refuse_zoo_training(trainer, name, tmp_path, monkeypatch):
    """Each trainer takes what the JAX package's trainer of its kind takes
    (`factory.require_trainable`), and one step runs: the LEAF and the
    contrastive trainer every family with a native text tower, FARE the
    ViT family.  What JAX has no path for raises "in the JAX package as
    here": an HF text tower (nllb-clip-base) in every trainer, a tower
    outside the ViT family in FARE.  The steps are held against JAX in
    tests/test_torch_zoo_*.py."""
    import importlib
    main = importlib.import_module(f"leaf_tpu_torch.train.{trainer}").main
    kind = {"driver": "leaf", "fare_driver": "fare",
            "contrastive_driver": "contrastive"}[trainer]
    if name == "nllb-clip-base" or (kind == "fare"
                                    and name != "siglip-tiny-test"):
        with pytest.raises(NotImplementedError, match=(
                f"no path in the {kind} trainer, in the JAX package as "
                "here")):
            main(["--model", name, "--device", "cpu", "--logs",
                  str(tmp_path)] if kind != "fare" else
                 ["--model", name, "--device", "cpu", "--imagenet-root",
                  str(tmp_path), "--output-dir", str(tmp_path)])
        return
    one_step = ["--dataset-type", "synthetic", "--train-num-samples", "2",
                "--batch-size", "2", "--epochs", "1", "--logs",
                str(tmp_path), "--name", "run", "--device", "cpu"]
    if kind == "fare":
        rng = np.random.default_rng(0)
        for c in range(2):
            os.makedirs(tmp_path / "train" / f"c{c}")
            np.save(tmp_path / "train" / f"c{c}" / "0.npy",
                    rng.integers(0, 256, (70, 70, 3), dtype=np.uint8))
        out = main(["--model", name, "--device", "cpu", "--imagenet-root",
                    str(tmp_path / "train"), "--output-dir",
                    str(tmp_path / "fare"), "--steps", "1", "--warmup", "0",
                    "--batch-size", "2", "--iterations-adv", "1"])
        assert out["steps"] == 1 and np.isfinite(out["final_loss"])
        return
    _runnable_tiny(monkeypatch, name)
    if kind == "leaf":
        out = main(["--model", name, "--rho", "2", "--zeroshot-frequency",
                    "0"] + one_step)
    else:
        out = main(["--model", name] + one_step)
    assert out["state"].step == 1
    loss = float(out["results"][-1]["train_loss"])
    assert np.isfinite(loss) and loss >= 0


def test_trunk_training_and_unported_trunks_refused():
    # no JAX trainer passes remat to a trunk (ROADMAP item 11 step 4)
    module = tclip.CLIP(tconfig.get_model_config("fastvit-tiny-test"))
    with pytest.raises(NotImplementedError,
                       match="neither remat nor patch dropout.*JAX package"):
        module.visual.encode_image(torch.zeros(1, 32, 32, 3), remat=True)
    # Swin and RelPos-ViT, refused here before they were ported, resolve
    for name, spec in (("swin_base_patch4_window7_224", "SwinVisionSpec"),
                       ("vit_relpos_medium_patch16_cls_224",
                        "RelPosViTSpec")):
        assert type(trunks.spec_for_timm_name(name, 512)).__name__ == spec
    with pytest.raises(ValueError, match="unsupported MobileCLIP trunk"):
        trunks.spec_for_timm_name("fastvit_sa12", 512)


# ---------------------------------------------------------------------------
# The fusions (oracle of tests/test_mci.py)
# ---------------------------------------------------------------------------

def _bn_ref(y, g, b, m, v, eps=1e-5):
    return (y - m) / np.sqrt(v + eps) * g + b


def _conv_ref(x, w_oihw, stride=1, groups=1, padding=None):
    """The JAX package's NHWC convolution, the branches' oracle."""
    return np.asarray(jmci._conv(jnp.asarray(x),
                                 jnp.asarray(jmci._hwio(w_oihw)),
                                 stride=stride, groups=groups,
                                 padding=padding))


def _fused(x, w_oihw, b, stride=1, groups=1, padding=None):
    """The port's fused convolution (OIHW, NCHW) on NHWC numpy input."""
    y = tmci._conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(np.ascontiguousarray(w_oihw)),
                   torch.from_numpy(np.asarray(b)), stride, groups, padding)
    return y.permute(0, 2, 3, 1).numpy()


def _bn_keys(r, prefix, c):
    return {prefix + "weight": 0.5 + r.rand(c).astype(np.float32),
            prefix + "bias": r.randn(c).astype(np.float32) * 0.1,
            prefix + "running_mean": r.randn(c).astype(np.float32) * 0.1,
            prefix + "running_var": 0.5 + r.rand(c).astype(np.float32)}


def _mobileone_sd(r, prefix, k, cin, cout, groups, n_branches=2,
                  scale=True, identity=True):
    sd = {}
    for i in range(n_branches):
        sd[f"{prefix}conv_kxk.{i}.conv.weight"] = \
            r.randn(cout, cin // groups, k, k).astype(np.float32) * 0.2
        sd.update(_bn_keys(r, f"{prefix}conv_kxk.{i}.bn.", cout))
    if scale and k > 1:
        sd[prefix + "conv_scale.conv.weight"] = \
            r.randn(cout, cin // groups, 1, 1).astype(np.float32) * 0.2
        sd.update(_bn_keys(r, prefix + "conv_scale.bn.", cout))
    if identity and cin == cout:
        sd.update(_bn_keys(r, prefix + "identity.", cout))
    return sd


def _mobileone_ref(sd, prefix, x, k, stride, groups):
    """Branch by branch: the kxk conv+BN branches, the 1x1 one, the BN
    identity."""
    y = np.zeros(1, np.float32)
    i = 0
    while f"{prefix}conv_kxk.{i}.conv.weight" in sd:
        p = f"{prefix}conv_kxk.{i}."
        z = _conv_ref(x, sd[p + "conv.weight"], stride, groups)
        y = y + _bn_ref(z, sd[p + "bn.weight"], sd[p + "bn.bias"],
                        sd[p + "bn.running_mean"], sd[p + "bn.running_var"])
        i += 1
    if prefix + "conv_scale.conv.weight" in sd:
        p = prefix + "conv_scale."
        z = _conv_ref(x, sd[p + "conv.weight"], stride, groups, padding=0)
        y = y + _bn_ref(z, sd[p + "bn.weight"], sd[p + "bn.bias"],
                        sd[p + "bn.running_mean"], sd[p + "bn.running_var"])
    if prefix + "identity.weight" in sd:
        y = y + _bn_ref(x, sd[prefix + "identity.weight"],
                        sd[prefix + "identity.bias"],
                        sd[prefix + "identity.running_mean"],
                        sd[prefix + "identity.running_var"])
    return y


@pytest.mark.parametrize("case", [
    # (k, cin, cout, groups, stride, n_branches, scale, identity)
    (3, 8, 8, 1, 1, 1, True, True),
    (3, 8, 8, 8, 1, 2, True, True),
    (3, 3, 8, 1, 2, 1, True, False),
    (7, 8, 16, 8, 2, 1, True, False),
    (1, 8, 8, 1, 1, 1, False, True),
])
def test_mobileone_fusion_exact(case):
    k, cin, cout, groups, stride, nb, scale, ident = case
    r = np.random.RandomState(sum(case[:5]) * 7 + nb)
    sd = _mobileone_sd(r, "m.", k, cin, cout, groups, nb, scale, ident)
    x = r.randn(2, 8, 8, cin).astype(np.float32)
    w, b = tmci._fuse_mobileone(tmci._SD(sd, "m."), k, groups)
    np.testing.assert_allclose(_fused(x, w, b, stride, groups),
                               _mobileone_ref(sd, "m.", x, k, stride, groups),
                               rtol=1e-4, atol=1e-5)


def test_repmixer_fusion_exact():
    dim = 8
    r = np.random.RandomState(7)
    sd = {}
    sd.update(_mobileone_sd(r, "t.mixer.", 3, dim, dim, dim, n_branches=1,
                            scale=False, identity=True))
    sd.update(_mobileone_sd(r, "t.norm.", 3, dim, dim, dim, n_branches=1,
                            scale=False, identity=False))
    gamma = r.rand(dim, 1, 1).astype(np.float32) * 0.1
    sd["t.layer_scale.gamma"] = gamma
    x = r.randn(2, 6, 6, dim).astype(np.float32)
    want = x + gamma.reshape(-1) * (
        _mobileone_ref(sd, "t.mixer.", x, 3, 1, dim)
        - _mobileone_ref(sd, "t.norm.", x, 3, 1, dim))
    w, b = tmci._fuse_repmixer(tmci._SD(sd, "t."), dim)
    np.testing.assert_allclose(_fused(x, w, b, 1, dim), want,
                               rtol=1e-4, atol=1e-5)


def test_repcpe_fusion_exact():
    dim = 8
    r = np.random.RandomState(11)
    sd = {"p.proj.weight": r.randn(dim, 1, 7, 7).astype(np.float32) * 0.2,
          "p.proj.bias": r.randn(dim).astype(np.float32) * 0.1}
    x = r.randn(2, 8, 8, dim).astype(np.float32)
    want = x + _conv_ref(x, sd["p.proj.weight"], 1, dim) + sd["p.proj.bias"]
    w, b = tmci._fuse_repcpe(tmci._SD(sd, "p."), dim)
    np.testing.assert_allclose(_fused(x, w, b, 1, dim), want,
                               rtol=1e-4, atol=1e-5)


def test_large_kernel_conv_fusion_exact():
    cin, cout = 8, 16
    r = np.random.RandomState(13)
    sd = {"d.large_conv.conv.weight":
          r.randn(cout, 1, 7, 7).astype(np.float32) * 0.2,
          "d.small_conv.conv.weight":
          r.randn(cout, 1, 3, 3).astype(np.float32) * 0.2}
    sd.update(_bn_keys(r, "d.large_conv.bn.", cout))
    sd.update(_bn_keys(r, "d.small_conv.bn.", cout))
    x = r.randn(2, 8, 8, cin).astype(np.float32)
    want = (_bn_ref(_conv_ref(x, sd["d.large_conv.conv.weight"], 2, cin),
                    sd["d.large_conv.bn.weight"], sd["d.large_conv.bn.bias"],
                    sd["d.large_conv.bn.running_mean"],
                    sd["d.large_conv.bn.running_var"])
            + _bn_ref(_conv_ref(x, sd["d.small_conv.conv.weight"], 2, cin,
                                padding=1),
                      sd["d.small_conv.bn.weight"], sd["d.small_conv.bn.bias"],
                      sd["d.small_conv.bn.running_mean"],
                      sd["d.small_conv.bn.running_var"]))
    p = tmci._lkc_params(tmci._SD(sd, "d."), cin)
    np.testing.assert_allclose(
        _fused(x, p["w"].transpose(3, 2, 0, 1), p["b"], 2, cin), want,
        rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# Checkpoints: train and deploy form, through both packages
# ---------------------------------------------------------------------------

def _synthetic_fastvit_sd(spec, seed=0, prefix="visual.trunk."):
    """A seeded train-form timm FastVit state dict for `spec`."""
    r = np.random.RandomState(seed)

    def f(*s):
        return r.randn(*s).astype(np.float32) * 0.1

    d0 = spec.dims[0]
    sd = {}
    sd.update(_mobileone_sd(r, prefix + "stem.0.", 3, 3, d0, 1,
                            n_branches=1, identity=False))
    sd.update(_mobileone_sd(r, prefix + "stem.1.", 3, d0, d0, d0,
                            n_branches=1, identity=False))
    sd.update(_mobileone_sd(r, prefix + "stem.2.", 1, d0, d0, 1,
                            n_branches=1, scale=False))
    for s in range(len(spec.depths)):
        L, C = spec.depths[s], spec.dims[s]
        Hn = int(C * spec.mlp_ratio)
        pre = f"{prefix}stages.{s}."
        if s > 0:
            d = pre + "downsample.proj.0."
            sd[d + "large_conv.conv.weight"] = f(C, 1, 7, 7)
            sd.update(_bn_keys(r, d + "large_conv.bn.", C))
            sd[d + "small_conv.conv.weight"] = f(C, 1, 3, 3)
            sd.update(_bn_keys(r, d + "small_conv.bn.", C))
            if spec.se_downsamples[s]:
                rd = max(1, C // 16)
                sd.update({d + "se.fc1.weight": f(rd, C, 1, 1),
                           d + "se.fc1.bias": f(rd),
                           d + "se.fc2.weight": f(C, rd, 1, 1),
                           d + "se.fc2.bias": f(C)})
            sd.update(_mobileone_sd(r, pre + "downsample.proj.1.", 1, C, C,
                                    1, n_branches=1, scale=False))
        if s in spec.pos_emb_stages:
            sd[pre + "pos_emb.proj.weight"] = f(C, 1, 7, 7)
            sd[pre + "pos_emb.proj.bias"] = f(C)
        for j in range(L):
            b = pre + f"blocks.{j}."
            if spec.token_mixers[s] == "repmixer":
                sd.update(_mobileone_sd(r, b + "token_mixer.mixer.", 3, C, C,
                                        C, n_branches=1, scale=False))
                sd.update(_mobileone_sd(r, b + "token_mixer.norm.", 3, C, C,
                                        C, n_branches=1, scale=False,
                                        identity=False))
                sd[b + "token_mixer.layer_scale.gamma"] = f(C, 1, 1)
                sd[b + "layer_scale.gamma"] = f(C, 1, 1)
            else:
                sd.update(_bn_keys(r, b + "norm.", C))
                sd.update({b + "token_mixer.qkv.weight": f(3 * C, C),
                           b + "token_mixer.qkv.bias": f(3 * C),
                           b + "token_mixer.proj.weight": f(C, C),
                           b + "token_mixer.proj.bias": f(C),
                           b + "layer_scale_1.gamma": f(C, 1, 1),
                           b + "layer_scale_2.gamma": f(C, 1, 1)})
            sd[b + "mlp.conv.conv.weight"] = f(C, 1, 7, 7)
            sd.update(_bn_keys(r, b + "mlp.conv.bn.", C))
            sd.update({b + "mlp.fc1.weight": f(Hn, C, 1, 1),
                       b + "mlp.fc1.bias": f(Hn),
                       b + "mlp.fc2.weight": f(C, Hn, 1, 1),
                       b + "mlp.fc2.bias": f(C)})
    Cl, fin = spec.dims[-1], spec.final_dim
    sd.update(_mobileone_sd(r, prefix + "final_conv.", 3, Cl, fin, Cl,
                            n_branches=1, identity=False))
    rd = max(1, fin // 16)
    sd.update({prefix + "final_conv.se.fc1.weight": f(rd, fin, 1, 1),
               prefix + "final_conv.se.fc1.bias": f(rd),
               prefix + "final_conv.se.fc2.weight": f(fin, rd, 1, 1),
               prefix + "final_conv.se.fc2.bias": f(fin),
               prefix + "head.fc.weight": f(spec.output_dim, fin),
               prefix + "head.fc.bias": f(spec.output_dim)})
    return sd


def _deploy_form(sd, spec, P="visual.trunk."):
    """The same FastVit in timm's deploy form: each multi-branch block a
    `reparam_conv` (fused by the JAX package's own functions), each
    ConvMlp's conv+BN a biased conv; SE and layer scales of the MLP kept."""
    out = dict(sd)

    def fold(prefix, w, b):
        for k in [k for k in out if k.startswith(prefix)
                  and not k.startswith(prefix + "se.")]:
            del out[k]
        out[prefix + "reparam_conv.weight"] = w
        out[prefix + "reparam_conv.bias"] = b

    def sdv(prefix):
        return jmci._SD(sd, prefix)

    d0 = spec.dims[0]
    for name, k, g in (("stem.0.", 3, 1), ("stem.1.", 3, d0),
                       ("stem.2.", 1, 1)):
        fold(P + name, *jmci._fuse_mobileone(sdv(P + name), k, g))
    for s in range(len(spec.depths)):
        C, pre = spec.dims[s], P + f"stages.{s}."
        if s > 0:
            lkc = jmci._lkc_params(sdv(pre + "downsample.proj.0."),
                                   spec.dims[s - 1])
            fold(pre + "downsample.proj.0.", lkc["w"].transpose(3, 2, 0, 1),
                 lkc["b"])
            fold(pre + "downsample.proj.1.",
                 *jmci._fuse_mobileone(sdv(pre + "downsample.proj.1."), 1, 1))
        if s in spec.pos_emb_stages:
            fold(pre + "pos_emb.", *jmci._fuse_repcpe(sdv(pre + "pos_emb."), C))
        for j in range(spec.depths[s]):
            b = pre + f"blocks.{j}."
            if spec.token_mixers[s] == "repmixer":
                fold(b + "token_mixer.",
                     *jmci._fuse_repmixer(sdv(b + "token_mixer."), C))
            w, bias = jmci._fuse_branch(sdv(b), "mlp.conv")
            for k in [k for k in out if k.startswith(b + "mlp.conv.")]:
                del out[k]
            out[b + "mlp.conv.weight"], out[b + "mlp.conv.bias"] = w, bias
    fold(P + "final_conv.",
         *jmci._fuse_mobileone(sdv(P + "final_conv."), 3, spec.dims[-1]))
    return out


def _synthetic_mci_vit_sd(spec, seed=0, prefix="visual.trunk.", bn=True):
    """A seeded timm hybrid-ViT state dict (ConvStem with BN, or with
    biased convs where `bn` is False)."""
    r = np.random.RandomState(seed)

    def f(*s):
        return r.randn(*s).astype(np.float32) * 0.05

    D, chans = spec.width, (3,) + spec.stem_channels
    sd = {}
    for i, k in enumerate(spec.stem_kernels):
        p = f"{prefix}patch_embed.backbone.{i}."
        sd[p + "conv.weight"] = f(chans[i + 1], chans[i], k, k)
        if bn:
            sd.update(_bn_keys(r, p + "bn.", chans[i + 1]))
        else:
            sd[p + "conv.bias"] = f(chans[i + 1])
    sd.update({prefix + "patch_embed.proj.weight":
               f(D, spec.stem_channels[-1], 1, 1),
               prefix + "patch_embed.proj.bias": f(D),
               prefix + "cls_token": f(1, 1, D),
               prefix + "pos_embed": f(1, spec.grid_size ** 2, D)})
    Hn = int(D * spec.mlp_ratio)
    for i in range(spec.layers):
        b = f"{prefix}blocks.{i}."
        sd.update({b + "norm1.weight": 1 + f(D), b + "norm1.bias": f(D),
                   b + "attn.qkv.weight": f(3 * D, D),
                   b + "attn.qkv.bias": f(3 * D),
                   b + "attn.proj.weight": f(D, D), b + "attn.proj.bias": f(D),
                   b + "norm2.weight": 1 + f(D), b + "norm2.bias": f(D),
                   b + "mlp.fc1.weight": f(Hn, D), b + "mlp.fc1.bias": f(Hn),
                   b + "mlp.fc2.weight": f(D, Hn), b + "mlp.fc2.bias": f(D)})
    sd.update({prefix + "norm.weight": 1 + f(D), prefix + "norm.bias": f(D),
               prefix + "head.weight": f(spec.output_dim, D),
               prefix + "head.bias": f(spec.output_dim)})
    return sd


def _text_sd(cfg, seed):
    """The native text tower under `text.` (OpenCLIP's CustomTextCLIP)."""
    r = np.random.RandomState(seed)

    def f(*s):
        return r.randn(*s).astype(np.float32) * 0.05

    tw = cfg.text.width
    sd = {"text.token_embedding.weight": f(cfg.text.vocab_size, tw),
          "text.positional_embedding": f(cfg.text.context_length, tw),
          "text.ln_final.weight": 1 + f(tw), "text.ln_final.bias": f(tw),
          "text.text_projection": f(tw, cfg.embed_dim),
          "logit_scale": np.float32(2.6592)}
    for i in range(cfg.text.layers):
        b = f"text.transformer.resblocks.{i}."
        sd.update({b + "ln_1.weight": 1 + f(tw), b + "ln_1.bias": f(tw),
                   b + "attn.in_proj_weight": f(3 * tw, tw),
                   b + "attn.in_proj_bias": f(3 * tw),
                   b + "attn.out_proj.weight": f(tw, tw),
                   b + "attn.out_proj.bias": f(tw),
                   b + "ln_2.weight": 1 + f(tw), b + "ln_2.bias": f(tw),
                   b + "mlp.c_fc.weight": f(4 * tw, tw),
                   b + "mlp.c_fc.bias": f(4 * tw),
                   b + "mlp.c_proj.weight": f(tw, 4 * tw),
                   b + "mlp.c_proj.bias": f(tw)})
    return sd


def _checkpoint(name, form):
    cfg = jconfig.get_model_config(name)
    if name == "fastvit-tiny-test":
        sd = _synthetic_fastvit_sd(cfg.trunk, seed=1)
        if form == "deploy":
            sd = _deploy_form(sd, cfg.trunk)
    else:
        sd = _synthetic_mci_vit_sd(cfg.trunk, seed=1, bn=form == "train")
    sd.update(_text_sd(cfg, seed=2))
    return sd


def test_fused_pytrees_equal_jax():
    """The port's copy of the ingestion gives the JAX package's pytree,
    leaf for leaf, for both trunks and both forms."""
    for name, form in (("fastvit-tiny-test", "train"),
                       ("fastvit-tiny-test", "deploy"),
                       ("mci-vit-tiny-test", "train"),
                       ("mci-vit-tiny-test", "deploy")):
        sd = _checkpoint(name, form)
        spec = jconfig.get_model_config(name).trunk
        want = jmci.mci_from_timm(sd, spec)
        got = tmci.mci_from_timm(sd, tconfig.get_model_config(name).trunk)
        assert jax.tree.structure(want) == jax.tree.structure(got)
        for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,form", [("fastvit-tiny-test", "train"),
                                       ("fastvit-tiny-test", "deploy"),
                                       ("mci-vit-tiny-test", "train"),
                                       ("mci-vit-tiny-test", "deploy")])
def test_trunk_checkpoints_through_both_packages(name, form):
    """A seeded OpenCLIP-layout `visual.trunk.*` checkpoint through both
    packages' `openclip_to_params`: equal features.  FastViT's deploy form
    holds the train form's weights fused, so the port reads it to the
    JAX package's train-form features; the MCi stem's "deploy" form is a
    biased conv without BN."""
    jcfg, tcfg = jconfig.get_model_config(name), tconfig.get_model_config(name)
    sd = _checkpoint(name, form)
    want_sd = _checkpoint(name, "train") if name == "fastvit-tiny-test" else sd
    jp = jax.tree.map(jnp.asarray, jinterop.openclip_to_params(want_sd, jcfg))
    module = tclip.CLIP(tcfg)
    module.load_state_dict(tinterop.resize_vision_pos_embed(
        tinterop.openclip_to_params(
            {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
            tcfg), tcfg))
    images = _images(3, 2, 32)
    tokens = np.random.default_rng(4).integers(1, 512, (2, 16)).astype(np.int32)
    want_i = jclip.encode_image_model(jp, jcfg, jnp.asarray(images))
    want_t = jclip.encode_text(jp["text"], jcfg.text, jnp.asarray(tokens))
    with torch.no_grad():
        got_i = module.eval().encode_image(torch.from_numpy(images))
        got_t = module.encode_text(torch.from_numpy(tokens))
    np.testing.assert_allclose(got_i.numpy(), _np(want_i), **TOL_CONV)
    np.testing.assert_allclose(got_t.numpy(), _np(want_t), **TOL)


def test_fastvit_qkv_bias_follows_the_weights():
    """timm's FastViT attention carries a qkv bias or not; the port's block
    takes whichever the weights have."""
    cfg = tconfig.get_model_config("fastvit-tiny-test")
    module = tclip.CLIP(cfg)
    blk = module.visual.stages[3].blocks[0]
    assert "qkv_b" not in blk.attn
    sd = _checkpoint("fastvit-tiny-test", "train")
    module.load_state_dict(tinterop.openclip_to_params(
        {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, cfg))
    assert blk.attn["qkv_b"].shape == (3 * cfg.trunk.dims[3],)


def test_missing_key_is_loud():
    sd = _synthetic_fastvit_sd(tconfig.get_model_config(
        "fastvit-tiny-test").trunk)
    del sd["visual.trunk.stem.0.conv_kxk.0.conv.weight"]
    with pytest.raises(KeyError, match="no conv_kxk.0/reparam_conv"):
        tmci.timm_fastvit_to_params(
            sd, tconfig.get_model_config("fastvit-tiny-test").trunk)


def test_mci_vit_matches_torch_oracle():
    """The hybrid MCi-ViT (timm vit_base_mci_224) written in torch from the
    published architecture, on the timm-layout weights the ingestion
    fuses: ConvStem (conv + BN + GELU, kernel == stride, pad 0), the 1x1
    projection, no_embed_class positions, the class token after them,
    pre-LN blocks, the final LN, the token pool and the trunk head (the
    oracle of tests/test_mci.py, held against the port)."""
    cfg = tconfig.get_model_config("mci-vit-tiny-test")
    spec = cfg.trunk
    sd_np = _synthetic_mci_vit_sd(spec, seed=5)
    sd = {k.replace("visual.trunk.", ""): torch.from_numpy(v)
          for k, v in sd_np.items()}
    imgs = _images(9, 2, spec.image_size)
    with torch.no_grad():
        x = torch.from_numpy(imgs).permute(0, 3, 1, 2)
        for i, k in enumerate(spec.stem_kernels):
            p = f"patch_embed.backbone.{i}."
            x = F.conv2d(x, sd[p + "conv.weight"], stride=k)
            x = F.batch_norm(x, sd[p + "bn.running_mean"],
                             sd[p + "bn.running_var"], sd[p + "bn.weight"],
                             sd[p + "bn.bias"], training=False)
            x = F.gelu(x)
        x = F.conv2d(x, sd["patch_embed.proj.weight"],
                     sd["patch_embed.proj.bias"])
        B, D = x.shape[:2]
        x = x.flatten(2).transpose(1, 2) + sd["pos_embed"]
        x = torch.cat([sd["cls_token"].expand(B, -1, -1), x], dim=1)
        hd = D // spec.heads
        for i in range(spec.layers):
            b = f"blocks.{i}."
            y = F.layer_norm(x, (D,), sd[b + "norm1.weight"],
                             sd[b + "norm1.bias"], spec.ln_eps)
            q, k, v = (t.reshape(B, -1, spec.heads, hd).transpose(1, 2)
                       for t in F.linear(y, sd[b + "attn.qkv.weight"],
                                         sd[b + "attn.qkv.bias"]).chunk(3, -1))
            a = ((q @ k.transpose(-2, -1)) * hd ** -0.5).softmax(dim=-1)
            o = (a @ v).transpose(1, 2).reshape(B, -1, D)
            x = x + F.linear(o, sd[b + "attn.proj.weight"],
                             sd[b + "attn.proj.bias"])
            y = F.layer_norm(x, (D,), sd[b + "norm2.weight"],
                             sd[b + "norm2.bias"], spec.ln_eps)
            x = x + F.linear(F.gelu(F.linear(y, sd[b + "mlp.fc1.weight"],
                                             sd[b + "mlp.fc1.bias"])),
                             sd[b + "mlp.fc2.weight"], sd[b + "mlp.fc2.bias"])
        x = F.layer_norm(x, (D,), sd["norm.weight"], sd["norm.bias"],
                         spec.ln_eps)
        want = F.linear(x[:, 0], sd["head.weight"], sd["head.bias"]).numpy()

    tower = tmci.MciViT(spec)
    state = tinterop.params_from_jax(
        {"visual": tmci.timm_mci_vit_to_params(sd_np, spec)})
    tower.load_state_dict({k[len("visual."):]: v for k, v in state.items()})
    with torch.no_grad():
        got = tower.eval().encode_image(torch.from_numpy(imgs))
    np.testing.assert_allclose(got.numpy(), want, **TOL_CONV)
