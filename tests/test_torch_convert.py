"""leaf_tpu_torch's checkpoint formats against the JAX package, on the
CPU in fp32: the activation a checkpoint declares and the position-grid
resize (both applied by `create_model`), the HF `CLIPModel` schema both
ways, `convert`'s command line and HF directory, and
`push_to_hf_hub`'s hub layout and upload.

The same JAX-initialised weights go through both packages, the port's
copy by way of `interop.params_from_jax`; features are held to 1e-5.
"""
import json
import logging
import os
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from leaf_tpu import convert as jconvert
from leaf_tpu import push_to_hf_hub as jhub
from leaf_tpu.models import clip as jclip
from leaf_tpu.models import config as jconfig
from leaf_tpu.models import factory as jfactory
from leaf_tpu.models import interop as jinterop
from leaf_tpu_torch import convert as tconvert
from leaf_tpu_torch import push_to_hf_hub as thub
from leaf_tpu_torch.models import config as tconfig
from leaf_tpu_torch.models import interop as tinterop
from leaf_tpu_torch.models.factory import create_model

torch.set_num_threads(2)

MODEL = "ViT-tiny-test"
TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def weights():
    """(JAX params as numpy, the port's state_dict of the same weights)."""
    params = jax.tree.map(np.asarray, jclip.init_clip(
        jax.random.PRNGKey(3), jconfig.get_model_config(MODEL)))
    return params, tinterop.params_from_jax(params)


def _inputs(size=64):
    rng = np.random.default_rng(0)
    tokens = np.zeros((3, 77), np.int32)
    for i, e in enumerate((5, 12, 76)):
        tokens[i, 0] = 49406
        tokens[i, 1:e] = rng.integers(1, 49400, size=e - 1)
        tokens[i, e] = 49407
    images = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    return tokens, images


def _port_features(model, tokens, images):
    with torch.no_grad():
        return (model.encode_text(tokens).numpy(),
                model.encode_image(images).numpy())


def _jax_features(model, tokens, images):
    cfg = model.cfg
    return (np.asarray(jclip.encode_text(model.params["text"], cfg.text,
                                         jnp.asarray(tokens),
                                         cfg.quick_gelu)),
            np.asarray(jclip.encode_image_model(model.params, cfg,
                                                jnp.asarray(images))))


def _write_openclip(params, directory, quick_gelu=None):
    """An OpenCLIP snapshot directory of `params` (the JAX writer), with an
    `open_clip_config.json` declaring `quick_gelu` when given."""
    jconvert.save_state_dict(jconvert.params_to_openclip(
        params, jconfig.get_model_config(MODEL)), str(directory), "openclip")
    if quick_gelu is not None:
        with open(os.path.join(directory, "open_clip_config.json"), "w") as f:
            json.dump({"model_cfg": {"quick_gelu": quick_gelu}}, f)
    return str(directory)


# ---------------------------------------------------------------------------
# the two repairs: activation adoption and the position-grid resize
# ---------------------------------------------------------------------------

def test_quick_gelu_checkpoint_loads_as_in_jax(weights, tmp_path):
    """A ViT-tiny-test checkpoint whose `open_clip_config.json` declares
    QuickGELU, loaded under the GELU name: both packages adopt QuickGELU,
    and the features agree to 1e-5."""
    d = _write_openclip(weights[0], tmp_path / "qg", quick_gelu=True)
    tokens, images = _inputs()
    j = jfactory.create_model(MODEL, d)
    t = create_model(MODEL, d, device="cpu")
    for a, b in zip(_port_features(t, tokens, images),
                    _jax_features(j, tokens, images)):
        np.testing.assert_allclose(a, b, **TOL)
    assert j.cfg.quick_gelu and t.cfg.quick_gelu
    # the activation matters: the GELU model of the same weights differs
    plain = tinterop.load_pretrained(d, t.cfg)
    g = create_model(MODEL, device="cpu")
    g.module.load_state_dict(plain)
    assert np.abs(_port_features(g, tokens, images)[0]
                  - _port_features(t, tokens, images)[0]).max() > 1e-4


def _layouts(root, weights):
    """Checkpoint layouts and what each declares."""
    out = {}
    d = _write_openclip(weights[0], root / "oc_true", quick_gelu=True)
    out["open_clip_config true (dir)"] = d
    out["open_clip_config true (file)"] = os.path.join(
        d, "open_clip_model.safetensors")
    out["open_clip_config false"] = _write_openclip(
        weights[0], root / "oc_false", quick_gelu=False)
    bare = _write_openclip(weights[0], root / "bare")
    out["no config"] = bare
    side = os.path.join(bare, "open_clip_model.safetensors")
    sidecar_dir = root / "sidecar"
    sidecar_dir.mkdir()
    f = str(sidecar_dir / "weights.safetensors")
    os.link(side, f)
    with open(f + ".open_clip_config.json", "w") as fh:
        json.dump({"model_cfg": {"quick_gelu": True}}, fh)
    out["per-file sidecar"] = f
    for name, cfg in (("hf quick_gelu", {"model_type": "clip", "text_config":
                                          {"hidden_act": "quick_gelu"}}),
                      ("hf gelu", {"model_type": "clip", "text_config":
                                   {"hidden_act": "gelu"}}),
                      ("hf no act", {"model_type": "clip"}),
                      ("hf other model", {"model_type": "siglip",
                                          "hidden_act": "quick_gelu"})):
        hd = root / name.replace(" ", "_")
        hd.mkdir()
        (hd / "config.json").write_text(json.dumps(cfg))
        out[name] = str(hd)
    return out


def test_checkpoint_quick_gelu_reads_what_jax_reads(weights, tmp_path,
                                                    monkeypatch):
    layouts = _layouts(tmp_path, weights)
    for name, path in layouts.items():
        assert tinterop.checkpoint_quick_gelu(path) == \
            jinterop.checkpoint_quick_gelu(path), name
    assert tinterop.checkpoint_quick_gelu(layouts["per-file sidecar"]) is True
    assert tinterop.checkpoint_quick_gelu(layouts["hf gelu"]) is False
    # a bare file name has no config directory, whatever sits in the cwd
    monkeypatch.chdir(layouts["hf quick_gelu"])
    assert tinterop.checkpoint_quick_gelu("x.safetensors") is None


def test_force_quick_gelu_keeps_quick_gelu_and_logs_as_jax(weights, tmp_path,
                                                           caplog):
    d = _write_openclip(weights[0], tmp_path / "gelu", quick_gelu=False)
    with caplog.at_level(logging.WARNING):
        t = create_model(MODEL, d, device="cpu", force_quick_gelu=True)
        j = jfactory.create_model(MODEL, d, force_quick_gelu=True)
    assert t.cfg.quick_gelu and j.cfg.quick_gelu
    msgs = [r.getMessage() for r in caplog.records
            if "quick_gelu was forced on" in r.getMessage()]
    assert len(msgs) == 2 and msgs[0] == msgs[1]
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        t = create_model(MODEL, _write_openclip(
            weights[0], tmp_path / "qg", quick_gelu=True), device="cpu")
        jfactory.create_model(MODEL, str(tmp_path / "qg"))
    msgs = [r.getMessage() for r in caplog.records
            if "adopting quick_gelu activation" in r.getMessage()]
    assert len(msgs) == 2 and msgs[0] == msgs[1]


@pytest.mark.parametrize("old,new", [(7, 16), (16, 7)])
def test_resize_vision_pos_embed_matches_jax(old, new):
    """The cubic, antialiased grid resize (Keys' a = -0.5, edges
    renormalised) of `jax.image.resize`, up and down, class token kept."""
    rng = np.random.default_rng(old)
    pe = rng.standard_normal((old * old + 1, 32)).astype(np.float32)
    jcfg = jconfig.get_model_config(MODEL)
    jcfg = jcfg.__class__(**{**jcfg.__dict__, "vision": jcfg.vision.__class__(
        **{**jcfg.vision.__dict__, "image_size": new * 16})})
    tcfg = tconfig.get_model_config(MODEL)
    tcfg = tcfg.__class__(**{**tcfg.__dict__, "vision": tcfg.vision.__class__(
        **{**tcfg.vision.__dict__, "image_size": new * 16})})
    want = np.asarray(jinterop.resize_vision_pos_embed(
        {"visual": {"positional_embedding": pe,
                    "class_embedding": pe[0]}}, jcfg)["visual"][
        "positional_embedding"])
    got = tinterop.resize_vision_pos_embed(
        {"visual.positional_embedding": torch.from_numpy(pe),
         "visual.class_embedding": torch.from_numpy(pe[0])}, tcfg)[
        "visual.positional_embedding"].numpy()
    assert got.shape == want.shape == (new * new + 1, 32)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(got[0], pe[0])


def test_checkpoint_at_another_resolution_loads_as_in_jax(weights, tmp_path):
    """A checkpoint whose position grid is 7 x 7 loads into ViT-tiny-test's
    4 x 4 grid in both packages, with equal features."""
    params = jax.tree.map(np.copy, weights[0])
    rng = np.random.default_rng(5)
    params["visual"]["positional_embedding"] = rng.standard_normal(
        (50, 64)).astype(np.float32)
    d = _write_openclip(params, tmp_path / "r7")
    tokens, images = _inputs()
    j = jfactory.create_model(MODEL, d)
    t = create_model(MODEL, d, device="cpu")
    assert t.module.visual.positional_embedding.shape == (17, 64)
    for a, b in zip(_port_features(t, tokens, images),
                    _jax_features(j, tokens, images)):
        np.testing.assert_allclose(a, b, **TOL)


# ---------------------------------------------------------------------------
# the HF schema
# ---------------------------------------------------------------------------

def test_params_to_hf_and_back_match_jax(weights):
    params, sd = weights
    jcfg = jconfig.get_model_config(MODEL)
    tcfg = tconfig.get_model_config(MODEL)
    want = jinterop.params_to_hf(params, jcfg)
    got = tinterop.params_to_hf(sd, tcfg)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
        assert got[k].is_contiguous()
    # HF -> port equals HF -> JAX -> port, with HF's "pre_layrnorm" (sic)
    # and the other spelling, and a text projection bias
    for pre in ("pre_layrnorm", "pre_layernorm"):
        hf = {k.replace("pre_layrnorm", pre): v for k, v in want.items()}
        hf["text_projection.bias"] = np.arange(64, dtype=np.float32)
        ours = tinterop.hf_to_params(hf, tcfg)
        theirs = tinterop.params_from_jax(jinterop.hf_to_params(hf, jcfg))
        assert ours.keys() == theirs.keys()
        assert "text.text_projection_bias" in ours
        for k in theirs:
            assert torch.equal(ours[k], theirs[k]), k
    # a tower without ln_pre / class token has no HF form
    no_pre = {k: v for k, v in sd.items() if not k.startswith("visual.ln_pre")}
    with pytest.raises(ValueError, match="pre_layrnorm"):
        tinterop.params_to_hf(no_pre, tcfg)


def test_hf_directory_loads_in_transformers_and_jax(weights, tmp_path):
    """The port's HF directory loads through transformers' CLIPModel with
    the state dict of the directory the JAX package writes (through
    transformers), declares the activation, and reads back exactly in both
    packages."""
    transformers = pytest.importorskip("transformers")
    params, sd = weights
    src = _write_openclip(params, tmp_path / "src")
    ours = tconvert.main(["--model", MODEL, "--input", src, "--output",
                          str(tmp_path / "port_hf"), "--to", "hf",
                          "--device", "cpu"])
    theirs = jconvert.main(["--model", MODEL, "--input", src, "--output",
                            str(tmp_path / "jax_hf"), "--to", "hf"])
    a = transformers.CLIPModel.from_pretrained(ours).state_dict()
    b = transformers.CLIPModel.from_pretrained(theirs).state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert jinterop.checkpoint_quick_gelu(ours) is False
    back = jinterop.load_pretrained(ours, jconfig.get_model_config(MODEL))
    for (path, x), (_, y) in zip(
            jax.tree_util.tree_leaves_with_path(back),
            jax.tree_util.tree_leaves_with_path(params)):
        np.testing.assert_array_equal(np.asarray(x), y, err_msg=str(path))
    mine = tinterop.load_pretrained(theirs, tconfig.get_model_config(MODEL))
    assert mine.keys() == sd.keys()
    for k in sd:
        assert torch.equal(mine[k], sd[k]), k


def test_convert_round_trips_openclip_hf_openclip(weights, tmp_path):
    params, sd = weights
    src = _write_openclip(params, tmp_path / "src")
    hf = tconvert.main(["--model", MODEL, "--input", src, "--output",
                        str(tmp_path / "hf"), "--to", "hf", "--verify",
                        "--device", "cpu"])
    assert sorted(os.listdir(hf)) == ["config.json", "model.safetensors"]
    back = tconvert.main(["--model", MODEL, "--input", hf, "--output",
                          str(tmp_path / "oc"), "--to", "openclip",
                          "--verify", "--device", "cpu"])
    start = tinterop.load_state_dict_file(
        os.path.join(src, "open_clip_model.safetensors"))
    end = tinterop.load_state_dict_file(back)
    assert start.keys() == end.keys()
    for k in start:
        # the JAX writer's logit_scale has shape [1], the port's ()
        assert torch.equal(start[k].reshape(end[k].shape), end[k]), k
    # and the round trip holds the features, through create_model
    tokens, images = _inputs()
    for a, b in zip(_port_features(create_model(MODEL, src, device="cpu"),
                                   tokens, images),
                    _port_features(create_model(MODEL, hf, device="cpu"),
                                   tokens, images)):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_verify_catches_a_broken_conversion(weights):
    sd = weights[1]
    cfg = tconfig.get_model_config(MODEL)
    hf = tinterop.params_to_hf(sd, cfg)
    key = "text_model.encoder.layers.0.self_attn.q_proj.bias"
    hf[key] = hf[key] + 1.0
    with pytest.raises(AssertionError, match="text parity failed"):
        tconvert.verify_parity(sd, cfg, hf, "hf")


def test_convert_refusals(weights, tmp_path):
    src = _write_openclip(weights[0], tmp_path / "src")
    with pytest.raises(NotImplementedError, match="item 11"):
        tconvert.main(["--model", "RN50", "--input", src, "--output",
                       str(tmp_path / "o"), "--to", "hf", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tconvert.main(["--model", MODEL, "--input", src, "--output",
                           str(tmp_path / "o"), "--to", "hf"])
    assert not os.path.exists(tmp_path / "o")


# ---------------------------------------------------------------------------
# push_to_hf_hub
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", tconfig.list_models())
def test_config_to_open_clip_dict_matches_jax(name):
    assert thub.config_to_open_clip_dict(tconfig.get_model_config(name)) == \
        jhub.config_to_open_clip_dict(jconfig.get_model_config(name))


def test_save_for_hub_writes_what_jax_writes(weights, tmp_path):
    params, sd = weights
    card = {"license": "apache-2.0", "description": "a tiny test model",
            "details": {"Dataset": "LAION", "Sizes": [1, 2],
                        "Resolution": {"h": 64}},
            "usage": "load it", "citation": ["@x{y}"]}
    ours = thub.save_for_hub(sd, tconfig.get_model_config(MODEL),
                             str(tmp_path / "ours"), model_card=card,
                             model_name="tiny")
    theirs = jhub.save_for_hub(params, jconfig.get_model_config(MODEL),
                               str(tmp_path / "theirs"), model_card=card,
                               model_name="tiny")
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs)) == [
        "README.md", "open_clip_config.json", "open_clip_model.safetensors"]
    for name in ("README.md", "open_clip_config.json"):
        with open(os.path.join(ours, name)) as a, \
                open(os.path.join(theirs, name)) as b:
            assert a.read() == b.read(), name
    a = tinterop.load_state_dict_file(
        os.path.join(ours, "open_clip_model.safetensors"))
    b = tinterop.load_state_dict_file(
        os.path.join(theirs, "open_clip_model.safetensors"))
    assert a.keys() == b.keys()
    for k in a:
        # the JAX writer's logit_scale has shape [1], the port's ()
        assert torch.equal(a[k], b[k].reshape(a[k].shape)), k


def test_push_uploads_through_huggingface_hub(weights, tmp_path,
                                              monkeypatch):
    """main with a stand-in `huggingface_hub`: the repo is created and the
    directory uploaded; --local-dir-only uploads nothing; without the
    package the JAX package's RuntimeError names the directory."""
    src = _write_openclip(weights[0], tmp_path / "src")
    calls = []
    hub = types.ModuleType("huggingface_hub")
    hub.create_repo = lambda repo_id, private, exist_ok: calls.append(
        ("create", repo_id, private, exist_ok))
    hub.upload_folder = lambda repo_id, folder_path, commit_message: \
        calls.append(("upload", repo_id, sorted(os.listdir(folder_path)),
                      commit_message))
    monkeypatch.setitem(sys.modules, "huggingface_hub", hub)
    out = thub.main(["--model", MODEL, "--input", src, "--repo-id",
                     "me/tiny", "--local-dir", str(tmp_path / "up"),
                     "--private"])
    assert out == str(tmp_path / "up")
    assert calls == [("create", "me/tiny", True, True),
                     ("upload", "me/tiny", ["README.md",
                                            "open_clip_config.json",
                                            "open_clip_model.safetensors"],
                      "Add model")]
    calls.clear()
    thub.main(["--model", MODEL, "--input", src, "--repo-id", "me/tiny",
               "--local-dir", str(tmp_path / "local"), "--local-dir-only"])
    assert calls == [] and os.path.exists(
        tmp_path / "local" / "open_clip_model.safetensors")
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(RuntimeError, match="--local-dir-only and upload"):
        thub.main(["--model", MODEL, "--input", src, "--repo-id", "me/t",
                   "--local-dir", str(tmp_path / "x")])
