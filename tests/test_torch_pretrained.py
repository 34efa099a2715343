"""leaf_tpu_torch's pretrained registry, the factory's overrides and the
preprocess geometry against the JAX package, on the CPU: `list_pretrained`
and every entry; the verified cache with an injected retriever (hash
check, corrupt-cache retry, persistent mismatch, no fetch without a
retriever) and the `hf-hub:` snapshots with an injected download;
`resolve_pretrained`'s passthrough and the registry-declared activation;
`create_model` from an `hf-hub:` name; the overrides' configs against the
JAX `create_model`'s; the eval pixels of every interpolation and resize
mode against Pillow's (the JAX package's); the train transform's
interpolations; and `openclip_all`.
"""
import dataclasses
import hashlib
import json
import logging
import os
import shutil

import numpy as np
import pytest
import torch

from leaf_tpu.benchmark import model_collection as jmc
from leaf_tpu.models import factory as jfactory
from leaf_tpu.models import preprocess as jpre
from leaf_tpu.models import pretrained as jreg
from leaf_tpu_torch.benchmark import model_collection as tmc
from leaf_tpu_torch.convert import params_to_openclip, save_state_dict
from leaf_tpu_torch.models import factory as tfactory
from leaf_tpu_torch.models import interop as tinterop
from leaf_tpu_torch.models import preprocess as tpre
from leaf_tpu_torch.models import pretrained as treg

torch.set_num_threads(2)

MODEL = "ViT-tiny-test"


@pytest.fixture
def fake_server():
    """An injected url_retrieve writing known bytes; counts its calls."""
    class Server:
        payload = b"fake checkpoint bytes"
        calls = 0

        def __call__(self, url, target):
            self.calls += 1
            with open(target, "wb") as f:
                f.write(self.payload)

        @property
        def sha(self):
            return hashlib.sha256(self.payload).hexdigest()

    return Server()


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------

def test_list_pretrained_equals_jax():
    pairs = treg.list_pretrained()
    assert pairs == jreg.list_pretrained()
    assert ("ViT-L-14", "openai") in pairs and ("ViT-H-14", "leaf") in pairs
    for model, tag in pairs:
        assert treg.get_pretrained_cfg(model, tag) == \
            jreg.get_pretrained_cfg(model, tag)
        assert treg.get_pretrained_url(model, tag) == \
            jreg.get_pretrained_url(model, tag)
    assert treg.get_pretrained_cfg("ViT-B-32", "laion400m_e32")["quick_gelu"]
    assert treg.get_pretrained_cfg("ViT-B-32", "no-such-tag") == {}


def test_openclip_all_enumerates_the_registry():
    assert tmc.expand_models(["openclip_all"]) == \
        [tuple(p) for p in treg.list_pretrained()] == \
        jmc.expand_models(["openclip_all"])


# ---------------------------------------------------------------------------
# The verified cache
# ---------------------------------------------------------------------------

def test_check_sha256_matches_jax(tmp_path):
    f = tmp_path / "w.bin"
    f.write_bytes(b"abc")
    sha = hashlib.sha256(b"abc").hexdigest()
    for prefix in ("", sha[:8], sha, "0" * 8):
        assert treg.check_sha256(str(f), prefix) == \
            jreg.check_sha256(str(f), prefix)


def test_download_and_cache(tmp_path, fake_server):
    url = "https://example.invalid/model/" + fake_server.sha + "/ckpt.pt"
    p = treg.download_pretrained_from_url(url, str(tmp_path),
                                          url_retrieve=fake_server)
    assert os.path.exists(p) and fake_server.calls == 1
    # a verified cached file is returned without a fetch
    assert treg.download_pretrained_from_url(
        url, str(tmp_path), url_retrieve=fake_server) == p
    assert treg.download_pretrained_from_url(url, str(tmp_path)) == p
    assert fake_server.calls == 1


@pytest.mark.parametrize("cached", [b"corrupted", b""])
def test_corrupt_or_empty_cache_is_fetched_again(tmp_path, fake_server,
                                                 cached):
    url = "https://example.invalid/model/" + fake_server.sha + "/ckpt.pt"
    (tmp_path / "ckpt.pt").write_bytes(cached)
    with pytest.warns(UserWarning, match="re-downloading"):
        p = treg.download_pretrained_from_url(url, str(tmp_path),
                                              url_retrieve=fake_server)
    assert fake_server.calls == 1 and treg.check_sha256(p, fake_server.sha)


def test_persistent_mismatch_raises_and_leaves_no_file(tmp_path,
                                                       fake_server):
    url = "https://example.invalid/model/" + "0" * 64 + "/ckpt.pt"
    with pytest.raises(RuntimeError, match="sha256"):
        treg.download_pretrained_from_url(url, str(tmp_path),
                                          url_retrieve=fake_server)
    assert os.listdir(tmp_path) == []


def test_no_fetch_without_a_retriever(tmp_path):
    url = "https://example.invalid/model/" + "0" * 64 + "/ckpt.pt"
    with pytest.raises(FileNotFoundError, match="no url_retrieve"):
        treg.download_pretrained_from_url(url, str(tmp_path))
    with pytest.raises(FileNotFoundError, match="checkpoint cache"):
        treg.resolve_pretrained("ViT-B-32", "openai", str(tmp_path))


def test_resolve_passthrough(tmp_path):
    f = tmp_path / "local.safetensors"
    f.write_bytes(b"x")
    for reg in (treg, jreg):
        assert reg.resolve_pretrained("ViT-L-14", str(f)) == str(f)
        assert reg.resolve_pretrained("ViT-L-14", "not-a-tag") == "not-a-tag"


def test_hf_hub_explicit_weight_file(tmp_path):
    """A three-part `hf-hub:org/repo/file.bin` id fetches that file (the
    config where there is one); a second resolve takes the cache."""
    fetched = []

    def fetch(repo, fname, local):
        fetched.append((repo, fname))
        if fname.endswith(".json"):
            raise OSError("no config in this repo")
        (open(os.path.join(local, fname), "wb")).write(b"weights")

    hub = "hf-hub:jienengchen/ViTamin-S/pytorch_model.bin"
    local = treg.download_pretrained_from_hf(hub, str(tmp_path), fetch)
    assert os.path.exists(os.path.join(local, "pytorch_model.bin"))
    assert ("jienengchen/ViTamin-S", "pytorch_model.bin") in fetched
    n = len(fetched)
    assert treg.download_pretrained_from_hf(hub, str(tmp_path), fetch) == local
    assert len(fetched) == n


def _snapshot_fetch(sd, model_cfg, quick_gelu=False, preprocess=None):
    """An injected hf_download serving an OpenCLIP snapshot."""
    calls = []

    def fetch(repo_id, filename, local_dir):
        calls.append((repo_id, filename))
        if filename == "open_clip_config.json":
            with open(os.path.join(local_dir, filename), "w") as f:
                json.dump({"model_cfg": {**model_cfg,
                                         "quick_gelu": quick_gelu},
                           "preprocess_cfg": preprocess or {}}, f)
            return
        if filename == "open_clip_model.safetensors":
            save_state_dict(sd, local_dir, "openclip")
            return
        raise FileNotFoundError(filename)

    return fetch, calls


def _tiny_openclip(seed=7):
    """(the port's state_dict of a seeded ViT-tiny-test, its OpenCLIP
    state dict, the OpenCLIP model_cfg)."""
    model = tfactory.create_model(MODEL, seed=seed, device="cpu")
    sd = model.module.state_dict()
    cfg = model.cfg
    model_cfg = {
        "embed_dim": cfg.embed_dim,
        "vision_cfg": {"image_size": cfg.vision.image_size,
                       "patch_size": cfg.vision.patch_size,
                       "width": cfg.vision.width,
                       "layers": cfg.vision.layers,
                       "head_width": cfg.vision.head_width},
        "text_cfg": {"context_length": cfg.text.context_length,
                     "vocab_size": cfg.text.vocab_size,
                     "width": cfg.text.width, "heads": cfg.text.heads,
                     "layers": cfg.text.layers}}
    return sd, params_to_openclip(sd, cfg), model_cfg


def test_hf_hub_snapshot_is_reused_offline(tmp_path):
    sd, oc, model_cfg = _tiny_openclip()
    fetch, calls = _snapshot_fetch(oc, model_cfg)
    local = treg.download_pretrained_from_hf("hf-hub:fake/tiny",
                                             str(tmp_path), fetch)
    assert os.path.exists(os.path.join(local, "open_clip_model.safetensors"))
    assert calls == [("fake/tiny", "open_clip_config.json"),
                     ("fake/tiny", "open_clip_model.safetensors")]

    def explode(*a):
        raise AssertionError("fetched despite a cached snapshot")

    assert treg.resolve_pretrained(MODEL, "hf-hub:fake/tiny", str(tmp_path),
                                   explode) == local
    # a registry tag whose source is a hub repo resolves the same way
    fetch2, _ = _snapshot_fetch(oc, model_cfg)
    assert os.path.isdir(treg.resolve_pretrained(
        "ViT-L-14", "fare2", str(tmp_path / "c2"),
        lambda r, f, d: fetch2("chs20/fare2-clip", f, d)))


def test_create_model_from_hub_name(tmp_path, monkeypatch):
    """`create_model('hf-hub:...')` takes the config and the weights from
    the snapshot, with its preprocess statistics and geometry, as the JAX
    package's does."""
    sd, oc, model_cfg = _tiny_openclip()
    pc = {"mean": [0.5, 0.5, 0.5], "std": [0.5, 0.5, 0.5],
          "interpolation": "bilinear", "resize_mode": "squash"}
    fetch, _ = _snapshot_fetch(oc, model_cfg, preprocess=pc)
    monkeypatch.setattr(treg, "DEFAULT_CACHE_DIR", str(tmp_path / "t"))
    monkeypatch.setattr(treg, "_default_hf_download", fetch)
    monkeypatch.setattr(jreg, "DEFAULT_CACHE_DIR", str(tmp_path / "j"))
    monkeypatch.setattr(jreg, "_default_hf_download", fetch)
    model, _, pre = tfactory.create_model_and_transforms(
        "hf-hub:fake/tiny", device="cpu")
    jmodel, _, jpre_val = jfactory.create_model_and_transforms(
        "hf-hub:fake/tiny")
    for f in ("image_mean", "image_std", "image_interpolation",
              "image_resize_mode", "embed_dim", "quick_gelu"):
        assert getattr(model.cfg, f) == getattr(jmodel.cfg, f), f
    got = model.module.state_dict()
    for k, v in sd.items():
        torch.testing.assert_close(got[k], v)
    img = np.random.default_rng(0).integers(0, 256, (40, 70, 3), np.uint8)
    np.testing.assert_allclose(pre(img), np.asarray(jpre_val(img)),
                               atol=1e-5, rtol=0)


def _hf_checkpoint(tmp_path, seed=0):
    model = tfactory.create_model(MODEL, seed=seed, device="cpu")
    path = str(tmp_path / "weights.bin")
    torch.save(tinterop.params_to_hf(model.module.state_dict(), model.cfg),
               path)
    return path


def test_registry_declared_activation_adopted(tmp_path, caplog,
                                              monkeypatch):
    """A raw checkpoint carries no activation; a registry entry that
    declares `quick_gelu` is adopted with a warning (in JAX as here)."""
    ck = _hf_checkpoint(tmp_path)
    entry = {"fake400m": {"url": "https://example.invalid/w.pt",
                          "quick_gelu": True}}
    monkeypatch.setitem(treg._PRETRAINED, MODEL, entry)
    monkeypatch.setattr(treg, "resolve_pretrained", lambda *a, **k: ck)
    with caplog.at_level(logging.WARNING):
        m = tfactory.create_model(MODEL, pretrained="fake400m", device="cpu")
    assert m.cfg.quick_gelu is True
    assert any("quick_gelu" in r.message for r in caplog.records)
    for tag in ("laion400m_e31", "laion400m_e32"):
        assert treg.get_pretrained_cfg("ViT-B-32", tag)["quick_gelu"] is True


def test_registry_activation_survives_preresolution(tmp_path, caplog,
                                                    monkeypatch):
    """`resolve_pretrained` writes the declared activation beside the
    cached file, so a driver that resolves the tag to a path first still
    adopts it; the injected retriever stands in for the fetch."""
    src = _hf_checkpoint(tmp_path)
    cache = tmp_path / "cache"
    cache.mkdir()
    monkeypatch.setitem(treg._PRETRAINED, MODEL, {
        "fake400m": {"url": "https://example.invalid/w.pt", "sha256": "",
                     "quick_gelu": True}})
    path = treg.resolve_pretrained(MODEL, "fake400m", str(cache),
                                   url_retrieve=lambda u, t: shutil.copy(
                                       src, t))
    assert os.path.exists(path + ".open_clip_config.json")
    assert tinterop.checkpoint_quick_gelu(path) is True
    with caplog.at_level(logging.WARNING):
        m = tfactory.create_model(MODEL, pretrained=path, device="cpu")
    assert m.cfg.quick_gelu is True
    # the same file by its tag, through the drivers' `local_checkpoint`
    monkeypatch.setattr(treg, "DEFAULT_CACHE_DIR", str(cache))
    assert tfactory.local_checkpoint("fake400m", "--pretrained",
                                     MODEL) == path
    with pytest.raises(FileNotFoundError, match="registry tag"):
        tfactory.local_checkpoint("nope", "--pretrained", MODEL)


# ---------------------------------------------------------------------------
# The overrides
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(force_quick_gelu=True), dict(force_patch_dropout=0.5),
    dict(force_image_size=32),
    dict(force_quick_gelu=True, force_patch_dropout=0.25,
         force_image_size=96)])
def test_override_configs_equal_jax(kw):
    j = jfactory.create_model(MODEL, **kw).cfg
    t = tfactory.create_model(MODEL, device="cpu", **kw).cfg
    assert dataclasses.asdict(j.vision) == dataclasses.asdict(t.vision)
    assert dataclasses.asdict(j.text) == dataclasses.asdict(t.text)
    assert j.quick_gelu == t.quick_gelu


def test_force_image_size_refusals_equal_jax():
    for name in ("RN50", "swin-tiny-test", "convnext-tiny-test"):
        with pytest.raises(ValueError, match="ViT towers"):
            tfactory.create_model(name, device="meta", force_image_size=64)
        with pytest.raises(ValueError, match="ViT towers"):
            jfactory.create_model(name, force_image_size=64)
    with pytest.raises(ValueError, match="CoCa"):
        tfactory.create_model("coca-tiny-test", device="cpu",
                              force_image_size=32)


def test_image_overrides_equal_jax():
    """`image_mean/std/interpolation/resize_mode` reach the transforms, and
    a new mean or std the model's config, as in the JAX package."""
    kw = dict(image_mean=(0.4, 0.5, 0.6), image_std=(0.2, 0.3, 0.4),
              image_interpolation="bilinear", image_resize_mode="longest")
    jm, _, jval = jfactory.create_model_and_transforms(MODEL, **kw)
    tm, ttrain, tval = tfactory.create_model_and_transforms(
        MODEL, device="cpu", **kw)
    assert (tm.cfg.image_mean, tm.cfg.image_std) == (jm.cfg.image_mean,
                                                     jm.cfg.image_std)
    img = np.random.default_rng(1).integers(0, 256, (30, 80, 3), np.uint8)
    np.testing.assert_allclose(tval(img), np.asarray(jval(img)), atol=1e-5,
                               rtol=0)
    assert ttrain is tval


# ---------------------------------------------------------------------------
# The preprocess geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("interp", ["bicubic", "bilinear", "random"])
@pytest.mark.parametrize("mode", ["shortest", "longest", "squash"])
def test_preprocess_pixels_equal_jax(interp, mode):
    """The eval transform against the JAX package's (Pillow's resize) on
    arrays taller, wider, smaller and larger than the output."""
    rng = np.random.default_rng(2)
    for shape in ((50, 70, 3), (90, 40, 3), (20, 33, 3), (64, 64, 3),
                  (41, 29)):
        a = rng.integers(0, 256, shape, dtype=np.uint8)
        for norm in (True, False):
            got = tpre.image_transform(48, do_normalize=norm,
                                       interpolation=interp,
                                       resize_mode=mode)(a)
            want = jpre.image_transform(48, do_normalize=norm,
                                        interpolation=interp,
                                        resize_mode=mode)(a)
            assert got.shape == (48, 48, 3) and got.dtype == np.float32
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("interp", ["bilinear", "random"])
def test_train_transform_interpolations_equal_jax(interp):
    """The random resized crop with each interpolation ('random' draws the
    filter from the same generator first) on the same seeded arrays: the
    JAX package's pixels within one uint8 level, as the bicubic case in
    tests/test_torch_augment.py."""
    rng = np.random.default_rng(3)
    arrays = [rng.integers(0, 256, s + (3,), dtype=np.uint8)
              for s in ((200, 300), (300, 180), (64, 97), (256, 256))]
    jt = jpre.train_image_transform(48, do_normalize=False,
                                    interpolation=interp, seed=5)
    tt = tpre.train_image_transform(48, do_normalize=False,
                                    interpolation=interp, seed=5)
    for a in arrays * 2:
        np.testing.assert_allclose(tt(a), jt(a), atol=1 / 255 + 1e-6)


@pytest.mark.parametrize("n_in,n_out", [(70, 48), (29, 48), (300, 7),
                                        (48, 48)])
def test_bilinear_resample_is_pillows(n_in, n_out):
    from PIL import Image
    a = np.random.default_rng(4).integers(0, 256, (n_in, n_in + 3, 3),
                                          dtype=np.uint8)
    want = np.asarray(Image.fromarray(a).resize((n_out, n_out),
                                                Image.BILINEAR))
    np.testing.assert_array_equal(
        tpre.resample(a, (n_out, n_out), "bilinear"), want)
