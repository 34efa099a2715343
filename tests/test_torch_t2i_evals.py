"""leaf_tpu_torch's CLIPScore, FID and text-to-image harness against the
JAX package's, in fp32 on the CPU at ViT-tiny-test.

One set of JAX-initialised weights goes to both packages (the port's copy
by way of `interop.params_from_jax`).  Held: `clip_score`,
`compute_clipscores` and `compute_clipscores_and_fid` to 1e-4 (the
black-image filter and the all-black case included), the Frechet
distance to 1e-8 relative, the CLIPScore command line on `.npy` and PNG
folders, the attacked captions of both attack modes, `generate_images`
with tiny injected components (DDIM, PLMS, v-prediction: identical), and
the text-to-image command line's stage-1 files, byte for byte.
"""
import json

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from leaf_tpu import convert as jconvert
from leaf_tpu.attacks import engine as jengine
from leaf_tpu.evals import clipscore as jclipscore
from leaf_tpu.evals import fid as jfid
from leaf_tpu.evals import text_to_image as jt2i
from leaf_tpu.models import clip as jclip
from leaf_tpu.models import config as jconfig
from leaf_tpu.tokenizer import get_tokenizer as jax_tokenizer
from leaf_tpu_torch.attacks import engine as tengine
from leaf_tpu_torch.evals import clipscore as tclipscore
from leaf_tpu_torch.evals import fid as tfid
from leaf_tpu_torch.evals import text_to_image as tt2i
from leaf_tpu_torch.models import interop as tinterop
from leaf_tpu_torch.models.factory import create_model
from leaf_tpu_torch.tokenizer import get_tokenizer as port_tokenizer

torch.set_num_threads(2)

MODEL = "ViT-tiny-test"
CAPTIONS = ["a photo of a cat", "stocks rally on earnings",
            "the match ended in a draw", "a red car near the river",
            "two dogs on a beach", "an old man sitting"]


def _models(seed):
    params = jax.tree.map(np.asarray, jclip.init_clip(
        jax.random.PRNGKey(seed), jconfig.get_model_config(MODEL)))
    model = create_model(MODEL, device="cpu")
    model.module.load_state_dict(tinterop.params_from_jax(params))
    return params, model


@pytest.fixture(scope="module")
def pkg():
    params, model = _models(0)
    return params, model, jconfig.get_model_config(MODEL)


def _images(rng, n, black=()):
    x = rng.uniform(0, 1, (n, 64, 64, 3)).astype(np.float32)
    for i in black:
        x[i] = rng.uniform(0, 3 / 255, (64, 64, 3))
    return x


# ---------------------------------------------------------------------------
# CLIPScore and FID
# ---------------------------------------------------------------------------

def test_clip_score_and_black_filter_match_jax():
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((2, 8, 16)).astype(np.float32)
    b[0] = -a[0]                                    # clipped at 0
    np.testing.assert_allclose(tclipscore.clip_score(a, b),
                               jclipscore.clip_score(a, b), atol=1e-4)
    assert tclipscore.clip_score(a, b)[0] == 0.0
    for img in _images(rng, 3, black=[1]):
        assert tclipscore.is_black_image(img) == jclipscore.is_black_image(img)


@pytest.mark.parametrize("black", [(1, 4), tuple(range(6))],
                         ids=["two_black", "all_black"])
def test_compute_clipscores_and_fid_match_jax(pkg, black):
    params, model, jcfg = pkg
    rng = np.random.default_rng(1)
    gen, real = _images(rng, 6, black), _images(rng, 6)
    jtok = jax_tokenizer()
    want = jclipscore.compute_clipscores_and_fid(
        params, jcfg, jtok, CAPTIONS, gen, real, batch_size=4)
    got = tclipscore.compute_clipscores_and_fid(
        model, port_tokenizer(), CAPTIONS, gen, real, batch_size=4)
    assert got.keys() == want.keys()
    assert got["n_black_filtered"] == len(black)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    if len(black) < 6:
        assert "fid_clip" in got and np.isfinite(got["fid_clip"])
    # without real images: the generated-vs-caption score alone
    want = jclipscore.compute_clipscores(params, jcfg, jtok, CAPTIONS, gen)
    got = tclipscore.compute_clipscores(model, port_tokenizer(), CAPTIONS,
                                        gen)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)


def test_frechet_distance_and_statistics_match_jax():
    rng = np.random.default_rng(2)
    f1 = rng.standard_normal((40, 12))
    f2 = rng.standard_normal((30, 12)) * 1.5 + 0.3
    s1, s2 = tfid.feature_statistics(f1), tfid.feature_statistics(f2)
    for a, b in zip(s1 + s2, jfid.feature_statistics(f1)
                    + jfid.feature_statistics(f2)):
        np.testing.assert_array_equal(a, b)
    got = tfid.frechet_distance(*s1, *s2)
    want = jfid.frechet_distance(*s1, *s2)
    assert abs(got - want) <= 1e-8 * abs(want)
    assert tfid.frechet_distance(*s1, *s1) == pytest.approx(0.0, abs=1e-6)


def test_clip_features_and_fid_match_jax(pkg):
    params, model, jcfg = pkg
    rng = np.random.default_rng(3)
    real, fake = _images(rng, 5), _images(rng, 5)
    jfn = jfid.make_clip_feature_fn(params, jcfg, batch_size=2)
    tfn = tfid.make_clip_feature_fn(model, batch_size=2)
    np.testing.assert_allclose(tfn(real), np.asarray(jfn(real)), atol=1e-5)
    np.testing.assert_allclose(tfid.compute_fid(real, fake, tfn),
                               jfid.compute_fid(real, fake, jfn), rtol=1e-4)


def test_inception_without_torchvision_falls_back_to_clip(pkg, monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "torchvision", None)
    assert tfid.make_inception_feature_fn() is None
    assert jfid.make_inception_feature_fn() is None
    params, model, jcfg = pkg
    rng = np.random.default_rng(4)
    gen, real = _images(rng, 4), _images(rng, 4)
    got = tclipscore.compute_clipscores_and_fid(
        model, port_tokenizer(), CAPTIONS[:4], gen, real,
        fid_features="inception")
    want = jclipscore.compute_clipscores_and_fid(
        params, jcfg, jax_tokenizer(), CAPTIONS[:4], gen, real,
        fid_features="inception")
    assert "fid_clip" in got and "fid_clip" in want
    np.testing.assert_allclose(got["fid_clip"], want["fid_clip"], rtol=1e-4)


def _checkpoint(params, d):
    jconvert.save_state_dict(jconvert.params_to_openclip(
        params, jconfig.get_model_config(MODEL)), str(d), "openclip")
    return str(d / "open_clip_model.safetensors")


def test_clipscore_main_on_npy_and_png_folders(pkg, tmp_path):
    """The command line on a folder of `.npy` arrays and on one of PNGs of
    the same pixels gives the same JSON; the JAX command line on the PNGs
    gives it too (1e-4)."""
    params = pkg[0]
    ckpt = _checkpoint(params, tmp_path)
    rng = np.random.default_rng(5)
    for name in ("gen_npy", "gen_png", "real_npy", "real_png"):
        (tmp_path / name).mkdir()
    for i in range(5):
        for kind in ("gen", "real"):
            img = rng.integers(0, 256, (80, 72, 3), dtype=np.uint8)
            if kind == "gen" and i == 2:
                img[:] = 1                                # blanked
            np.save(tmp_path / f"{kind}_npy" / f"{i:03d}.npy", img)
            Image.fromarray(img).save(tmp_path / f"{kind}_png" / f"{i:03d}.png")
    caps = tmp_path / "caps.json"
    caps.write_text(json.dumps(CAPTIONS[:5]))
    outs = []
    for kind in ("npy", "png"):
        outs.append(tclipscore.main([
            "--model", MODEL, "--pretrained", ckpt, "--gen-dir",
            str(tmp_path / f"gen_{kind}"), "--real-dir",
            str(tmp_path / f"real_{kind}"), "--captions", str(caps),
            "--batch-size", "2", "--output", str(tmp_path / f"{kind}.json"),
            "--device", "cpu"]))
    assert outs[0] == outs[1]
    assert json.loads((tmp_path / "npy.json").read_text()) == outs[0]
    assert outs[0]["n"] == 4 and outs[0]["n_black_filtered"] == 1
    want = jclipscore.main([
        "--model", MODEL, "--pretrained", ckpt, "--gen-dir",
        str(tmp_path / "gen_png"), "--real-dir", str(tmp_path / "real_png"),
        "--captions", str(caps), "--batch-size", "2"])
    assert outs[0].keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(outs[0][k], want[k], rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    with pytest.raises(SystemExit):
        tclipscore.main(["--gen-dir", "x", "--captions", str(caps),
                         "--device", "cpu"])


# ---------------------------------------------------------------------------
# text to image: the attack, the generation loop, the command line
# ---------------------------------------------------------------------------

def test_attack_captions_matches_jax_in_both_modes(tmp_path):
    """Single-encoder (batched Charmer) and dual-encoder (per caption, the
    second tower from another seed) modes pick the JAX sentences, and write
    the same CSV."""
    params0, model0 = _models(0)
    params1, model1 = _models(1)
    cfg = jconfig.get_model_config(MODEL)
    jscorer = jengine.CandidateScorer(cfg)
    tscorer = tengine.CandidateScorer(model0.cfg, "cpu")
    caps = CAPTIONS[:3]
    want = jt2i.attack_captions(jscorer, params0["text"], jax_tokenizer(),
                                caps, rho=4, k=2,
                                out_csv=str(tmp_path / "j.csv"))
    got = tt2i.attack_captions(tscorer, model0.module.text, port_tokenizer(),
                               caps, rho=4, k=2,
                               out_csv=str(tmp_path / "t.csv"))
    assert got == want and got != caps
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    want = jt2i.attack_captions(jscorer, params0["text"], jax_tokenizer(),
                                caps, rho=4, k=1,
                                text_params2=params1["text"])
    got = tt2i.attack_captions(tscorer, model0.module.text, port_tokenizer(),
                               caps, rho=4, k=1, text2=model1.module.text)
    assert got == want


class _DummyUNet(torch.nn.Module):
    """Noise predictor that depends on the latents, the timestep and the
    text embedding (so guidance and the text path are exercised)."""

    def __init__(self, ch=4, emb_dim=16):
        super().__init__()
        torch.manual_seed(0)
        self.conv = torch.nn.Conv2d(ch, ch, 3, padding=1)
        self.emb_proj = torch.nn.Linear(emb_dim, ch)

    def forward(self, x, t, emb):
        e = self.emb_proj(emb.mean(dim=1))[:, :, None, None]
        return self.conv(x) + e + 0.001 * float(t) * torch.tanh(x)


def dummy_components(cls, tokenizer, image_size=64, emb_dim=16):
    """Tiny random-weight SD components for `cls` (either package's
    `SDComponents`), built from the same seeds each call."""
    torch.manual_seed(1)
    text_emb = torch.nn.Embedding(49408, emb_dim)
    unet = _DummyUNet(emb_dim=emb_dim)
    decode = torch.nn.ConvTranspose2d(4, 3, 4, stride=4)
    with torch.no_grad():
        return cls(
            tokenize=lambda caps: torch.from_numpy(
                np.asarray(tokenizer(caps))).long(),
            text_encoder=lambda ids: text_emb.to(ids.device)(ids).detach(),
            unet=lambda x, t, emb: unet.to(x.device)(x, t, emb).detach(),
            vae_decode=lambda z: torch.tanh(decode.to(z.device)(z)).detach(),
            latent_channels=4, image_size=image_size, vae_factor=4,
            latent_scale=0.18215)


@pytest.mark.parametrize("scheduler,prediction", [
    ("ddim", "epsilon"), ("pndm", "epsilon"), ("ddim", "v_prediction"),
    ("pndm", "v_prediction")])
def test_generate_images_equals_jax(scheduler, prediction):
    caps = ["a photo of a cat", "stocks rally on earnings"]
    out = []
    for cls, gen, tok in ((jt2i.SDComponents, jt2i.generate_images,
                           jax_tokenizer()),
                          (tt2i.SDComponents, tt2i.generate_images,
                           port_tokenizer())):
        comps = dummy_components(cls, tok)
        comps.scheduler, comps.prediction_type = scheduler, prediction
        out.append(gen(caps, components=comps, num_inference_steps=6,
                       seed=3, device="cpu"))
    assert out[1].shape == (2, 64, 64, 3)
    np.testing.assert_array_equal(out[1], out[0])


def test_generation_refusals():
    comps = dummy_components(tt2i.SDComponents, port_tokenizer())
    with pytest.raises(ValueError, match="must be in"):
        tt2i.generate_images(["a"], components=comps, num_inference_steps=0,
                             device="cpu")
    with pytest.raises(ValueError, match="past the"):
        tt2i.generate_images(["a"], components=comps,
                             num_inference_steps=1000, device="cpu")
    with pytest.raises(ValueError, match="unsupported scheduler"):
        tt2i.SDComponents(None, None, None, None, scheduler="euler")
    # no diffusers here or on the card: the JAX package's RuntimeError
    with pytest.raises(RuntimeError, match="diffusers"):
        tt2i.SDComponents.from_pretrained("/nonexistent", device="cpu")
    for cfg in ({"_class_name": "DDIMScheduler"},
                {"_class_name": "PNDMScheduler", "skip_prk_steps": True},
                {"_class_name": "PNDMScheduler"},
                {"_class_name": "EulerDiscreteScheduler"}):
        assert tt2i._scheduler_from_config(cfg) == \
            jt2i._scheduler_from_config(cfg)


def test_text_to_image_main_stage_one_files_match_jax(pkg, tmp_path):
    params = pkg[0]
    ckpt = _checkpoint(params, tmp_path)
    caps = tmp_path / "caps.json"
    caps.write_text(json.dumps(CAPTIONS[:4]))
    flags = ["--model", MODEL, "--pretrained", ckpt, "--captions", str(caps),
             "--rho", "3", "--k", "1"]
    want = jt2i.main(flags + ["--output-dir", str(tmp_path / "jax")])
    got = tt2i.main(flags + ["--output-dir", str(tmp_path / "port"),
                             "--device", "cpu"])
    assert got == want
    for name in ("captions_adv.csv", "captions_adv.json"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tt2i.main(flags + ["--output-dir", str(tmp_path / "x")])
