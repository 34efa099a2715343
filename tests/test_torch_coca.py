"""leaf_tpu_torch's CoCa against the JAX package's, in fp32 on the CPU.

One set of JAX-initialised weights of a tiny CoCa (vocabulary 1,000,
context 12, 32 x 32 images) goes to the port by way of
`coca_interop.coca_params_from_jax`, with the same images and tokens from
numpy.  Held: the encoders (pad positions included), the decoder and the
training forward within 1e-5; `decode_one` against JAX's and the port's
cached generation against its uncached form; the top-p keep-set; greedy
and beam-search ids identical (the tiny model's logits are well
separated; sampling with top_k > 1 is not compared id for id, the two
frameworks' generators differ); `coca_loss`; one train step at lr 1e-4;
`coca_openclip_to_params` through both packages on one seeded
OpenCLIP-keyed dict; `benchmark.cli eval --task captioning` and
`contrastive_driver.main` against the JAX command lines on one OpenCLIP
checkpoint of `coca-tiny-test`; the profiler's CoCa row; the refusals of
the HF-text CoCa configs.
"""
import csv
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from leaf_tpu.benchmark import captioning as jcap
from leaf_tpu.benchmark import cli as jcli
from leaf_tpu.models import coca as jcoca
from leaf_tpu.models import coca_interop as jinterop
from leaf_tpu.models import config as jconfig
from leaf_tpu.models.loss import coca_loss as jcoca_loss
from leaf_tpu.train import contrastive as jcon
from leaf_tpu.train import contrastive_driver as jcdriver
from leaf_tpu.train.optim import make_optimizer as jmake_optimizer
from leaf_tpu.train.step import TrainState
from leaf_tpu.utils import profiler as jprofiler
from leaf_tpu_torch.benchmark import captioning as tcap
from leaf_tpu_torch.benchmark import cli as tcli
from leaf_tpu_torch.models import coca as tcoca
from leaf_tpu_torch.models import coca_interop as tinterop
from leaf_tpu_torch.models import config as tconfig
from leaf_tpu_torch.models import factory
from leaf_tpu_torch.models.loss import coca_loss
from leaf_tpu_torch.train import contrastive as tcon
from leaf_tpu_torch.train import contrastive_driver as tcdriver
from leaf_tpu_torch.train.optim import make_optimizer
from leaf_tpu_torch.utils import profiler as tprofiler

torch.set_num_threads(2)

SOT, EOS, V = 998, 999, 1000
LR = 1e-4
TINY = "coca-tiny-test"


def _cfg(mod, cfgmod):
    return mod.CoCaConfig(
        name="coca-parity", embed_dim=64,
        text=cfgmod.TextConfig(context_length=12, vocab_size=V, width=64,
                               heads=2, layers=2, output_dim=64),
        vision=cfgmod.VisionConfig(image_size=32, patch_size=16, width=64,
                                   layers=2, head_width=32, output_dim=64),
        multimodal=mod.MultimodalConfig(context_length=12, width=64, heads=2,
                                        layers=2, vocab_size=V),
        n_queries=8, attn_pooler_heads=2, sot_token_id=SOT,
        eos_token_id=EOS)


def _module(params, cfg):
    module = tcoca.CoCa(cfg)
    module.load_state_dict(tinterop.coca_params_from_jax(
        jax.tree.map(np.asarray, params)))
    return module.eval()


@pytest.fixture(scope="module")
def pair():
    """(JAX params, JAX config, the port's module, images [2, 32, 32, 3],
    tokens [2, 12]: SOT, 5 words, EOS, pads)."""
    jcfg, tcfg = _cfg(jcoca, jconfig), _cfg(tcoca, tconfig)
    params = jcoca.init_coca(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, SOT - 1, size=(2, 12))
    tokens[:, 0], tokens[:, 6], tokens[:, 7:] = SOT, EOS, 0
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    return params, jcfg, _module(params, tcfg), images, tokens


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_coca_params_from_jax_fills_every_parameter(pair):
    params, _, module, _, _ = pair
    got = tinterop.coca_params_from_jax(jax.tree.map(np.asarray, params))
    assert sorted(got) == sorted(module.state_dict())
    assert got["text_decoder.cross_blocks.1.ln_1_kv.scale"].shape == (64,)


def test_encode_image_matches_jax(pair):
    params, jcfg, module, images, _ = pair
    want = jcoca.encode_image_coca(params, jcfg, jnp.asarray(images))
    with torch.no_grad():
        got = module.encode_image(torch.from_numpy(images))
    assert got[1].shape == (2, 7, 64)
    for g, w in zip(got, want):
        _close(g, w)


def test_encode_text_matches_jax(pair):
    """The latent and every token embedding, the pad positions' too (the
    pad columns are masked in the CLS row alone)."""
    params, jcfg, module, _, tokens = pair
    want = jcoca.encode_text_coca(params, jcfg, jnp.asarray(tokens))
    with torch.no_grad():
        got = module.encode_text(torch.from_numpy(tokens))
    for g, w in zip(got, want):
        _close(g, w)
    mask = tcoca.cls_mask(torch.from_numpy(tokens), 0)
    assert torch.isinf(mask[:, -1, 8:]).all() and not mask[:, :-1].any()


def test_decode_and_forward_match_jax(pair):
    params, jcfg, module, images, tokens = pair
    _, embs = jcoca.encode_image_coca(params, jcfg, jnp.asarray(images))
    _, tembs = jcoca.encode_text_coca(params, jcfg, jnp.asarray(tokens))
    want = jcoca.decode(params, jcfg, embs, tembs)
    jout = jcoca.forward(params, jcfg, jnp.asarray(images),
                         jnp.asarray(tokens))
    with torch.no_grad():
        got = module.decode(torch.from_numpy(np.array(embs)),
                            torch.from_numpy(np.array(tembs)))
        out = module(torch.from_numpy(images), torch.from_numpy(tokens))
    _close(got, want)
    assert sorted(out) == sorted(jout)
    for k in ("image_features", "text_features", "logits", "logit_scale"):
        _close(out[k], jout[k])
    assert torch.equal(out["labels"], torch.from_numpy(tokens[:, 1:]))


def test_decode_one_matches_jax_and_the_uncached_decode(pair):
    """Position by position along the tokens: the port's cached step
    against JAX's, and against the row of the port's full encode +
    decode."""
    params, jcfg, module, images, tokens = pair
    _, embs = jcoca.encode_image_coca(params, jcfg, jnp.asarray(images))
    jcache = jcoca.init_generation_cache(params, jcfg, embs)
    jstep = jax.jit(lambda p, t, pos, c: jcoca.decode_one(p, jcfg, t, pos, c))
    with torch.no_grad():
        tembs = torch.from_numpy(np.array(embs))
        cache = tcoca.init_generation_cache(module, tembs)
        full = module.decode(tembs, module.encode_text(
            torch.from_numpy(tokens))[1])
        for pos in range(8):
            want, jcache = jstep(params, jnp.asarray(tokens[:, pos]), pos,
                                 jcache)
            got = tcoca.decode_one(module, torch.from_numpy(tokens[:, pos]),
                                   pos, cache)
            _close(got, want)
            torch.testing.assert_close(got, full[:, pos], atol=1e-5, rtol=0)


@pytest.mark.parametrize("top_p", [0.0, 0.1, 0.5, 0.9, 1.0])
def test_top_p_keep_set_matches_jax(top_p):
    rng = np.random.default_rng(3)
    logits = (3 * rng.standard_normal((4, 50))).astype(np.float32)
    want = np.isfinite(np.asarray(jcoca.top_p_filter(jnp.asarray(logits),
                                                     top_p)))
    got = torch.isfinite(tcoca.top_p_filter(torch.from_numpy(logits), top_p))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum(-1).min() >= 1


@pytest.mark.parametrize("kw", [dict(), dict(repetition_penalty=1.5),
                                dict(min_seq_len=8, seq_len=11)],
                         ids=["plain", "repetition", "min-len"])
def test_greedy_generation_matches_jax(pair, kw):
    params, jcfg, module, images, _ = pair
    kw = dict(kw)
    seq_len = kw.pop("seq_len", 10)
    want = jcoca.generate(params, jcfg, jnp.asarray(images),
                          jax.random.PRNGKey(0), seq_len=seq_len, **kw)
    got = tcoca.generate(module, torch.from_numpy(images), seq_len=seq_len,
                         **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[:, 0] == SOT).all() and (got == EOS).any(1).all()


@pytest.mark.parametrize("penalty", [1.0, 1.5])
def test_beam_search_matches_jax(pair, penalty):
    """K 6, G 3: the same ids, the EOS-less full-length hypotheses and
    the pad fill included."""
    params, jcfg, module, images, _ = pair
    want = jcoca.generate_beamsearch(params, jcfg, jnp.asarray(images),
                                     seq_len=10, repetition_penalty=penalty)
    got = tcoca.generate_beamsearch(module, torch.from_numpy(images),
                                    seq_len=10, repetition_penalty=penalty)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[:, 0] == SOT).all() and (got[:, 10:] == 0).all()


def test_sampling_draws_from_the_kept_tokens(pair):
    """top_k 3 and top_p 0.1 sample from a seeded generator: twice the
    same ids, and every row has ended in EOS by its last slot."""
    _, _, module, images, _ = pair
    x = torch.from_numpy(images)
    for kw in (dict(top_k=3), dict(top_p=0.1)):
        a = tcoca.generate(module, x, torch.Generator().manual_seed(1),
                           seq_len=10, **kw)
        b = tcoca.generate(module, x, torch.Generator().manual_seed(1),
                           seq_len=10, **kw)
        assert torch.equal(a, b) and a.shape == (2, 12)
        assert ((a == EOS).cumsum(1) > 0)[:, 9].all()


# ---------------------------------------------------------------------------
# the loss and the train step
# ---------------------------------------------------------------------------

def test_coca_loss_matches_jax():
    rng = np.random.default_rng(2)

    def unit(*shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    logits = rng.standard_normal((3, 5, 11)).astype(np.float32)
    labels = rng.integers(1, 11, (3, 5))
    labels[:, 3:] = 0
    args = [unit(3, 8), unit(3, 8), logits, labels,
            np.asarray(14.3, np.float32)]
    for weights in (dict(), dict(caption_loss_weight=1.0,
                                 clip_loss_weight=0.0)):
        want = jcoca_loss(*map(jnp.asarray, args), **weights)
        got = coca_loss(*map(torch.from_numpy, args), **weights)
        for g, w in zip(got, want):
            np.testing.assert_allclose(float(g), float(w), rtol=1e-5)


def _assert_params_close(module, params, lr=LR, atol=1e-4):
    """Every parameter within `atol`, each attention's key bias within
    2 lr: its true gradient is zero (softmax is shift invariant), so Adam
    turns each framework's rounding noise into a step of up to lr."""
    want = tinterop.coca_params_from_jax(jax.tree.map(np.asarray, params))
    got = module.state_dict()
    for k in want:
        g, w = got[k].detach().numpy(), want[k].numpy()
        if k.endswith("qkv_b"):
            d = g.shape[0] // 3
            np.testing.assert_allclose(g[d:2 * d], w[d:2 * d], atol=2 * lr,
                                       err_msg=k)
            g, w = np.delete(g, np.s_[d:2 * d]), np.delete(w, np.s_[d:2 * d])
        np.testing.assert_allclose(g, w, atol=atol, err_msg=k)


def test_coca_train_step_matches_jax(pair):
    params, jcfg, _, images, tokens = pair
    tx = jmake_optimizer(lambda s: LR, weight_decay=0.2)
    jstate = TrainState.create(jax.tree.map(jnp.copy, params), tx)
    jstep = jcon.make_coca_train_step(jcfg, tx)
    module = _module(params, _cfg(tcoca, tconfig))
    state = tcon.ContrastiveState(module, make_optimizer(
        module.named_parameters(), lambda s: LR, weight_decay=0.2))
    jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(tokens))
    state, tm = tcon.make_coca_train_step()(state, torch.from_numpy(images),
                                            torch.from_numpy(tokens))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["logit_scale"]),
                               float(jm["logit_scale"]), rtol=1e-6)
    assert state.step == 1
    _assert_params_close(module, jstate.text_params)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _openclip_key(name: str) -> str:
    """The OpenCLIP key of a port parameter name."""
    name = name.replace(".scale", ".weight")
    for port, oc in (("text.blocks.", "text.transformer.resblocks."),
                     ("visual.blocks.", "visual.transformer.resblocks."),
                     ("text_decoder.blocks.", "text_decoder.resblocks."),
                     ("text_decoder.cross_blocks.", "text_decoder.cross_attn.")):
        name = name.replace(port, oc)
    for port, oc in ((".attn.qkv_w", ".attn.in_proj_weight"),
                     (".attn.qkv_b", ".attn.in_proj_bias"),
                     (".attn.out_w", ".attn.out_proj.weight"),
                     (".attn.out_b", ".attn.out_proj.bias"),
                     (".mlp.fc_w", ".mlp.c_fc.weight"),
                     (".mlp.fc_b", ".mlp.c_fc.bias"),
                     (".mlp.proj_w", ".mlp.c_proj.weight"),
                     (".mlp.proj_b", ".mlp.c_proj.bias"),
                     ("attn_pool.q_w", "attn_pool.attn.q_proj_weight"),
                     ("attn_pool.k_w", "attn_pool.attn.k_proj_weight"),
                     ("attn_pool.v_w", "attn_pool.attn.v_proj_weight"),
                     ("attn_pool.qkv_b", "attn_pool.attn.in_proj_bias"),
                     ("attn_pool.out_w", "attn_pool.attn.out_proj.weight"),
                     ("attn_pool.out_b", "attn_pool.attn.out_proj.bias"),
                     ("text.token_embedding", "text.token_embedding.weight"),
                     ("visual.patch_embedding", "visual.conv1.weight")):
        if name.endswith(port):
            name = name[:-len(port)] + oc
    return name


def _openclip_dict(cfg, seed: int):
    """A seeded OpenCLIP-keyed CoCa state dict (torch nn.Linear layouts,
    the conv patch embedding, LayerNorm gains around 1)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in tcoca.CoCa(cfg).state_dict().items():
        a = 0.05 * rng.standard_normal(p.shape).astype(np.float32)
        if name.endswith(".scale"):
            a += 1.0
        if name == "logit_scale":
            a = np.float32(2.6592)
        elif name.endswith("patch_embedding"):
            p_ = cfg.vision.patch_size
            a = a.reshape(p_, p_, 3, -1).transpose(3, 2, 0, 1)
        elif name.endswith(("qkv_w", "out_w", "fc_w", "proj_w", "q_w",
                            "k_w", "v_w")):
            a = a.T           # [in, out] -> nn.Linear's [out, in]
        out[_openclip_key(name)] = torch.from_numpy(np.array(a))
    return out


def test_openclip_checkpoint_gives_jax_features(tmp_path):
    cfg, jcfg = tcoca.get_coca_config(TINY), jcoca.get_coca_config(TINY)
    sd = _openclip_dict(cfg, 5)
    want = jinterop.coca_openclip_to_params(
        {"module." + k: v.numpy() for k, v in sd.items()}, jcfg)
    module = tcoca.CoCa(cfg)
    module.load_state_dict(tinterop.coca_openclip_to_params(
        {"module." + k: v for k, v in sd.items()}, cfg))
    rng = np.random.default_rng(6)
    images = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    tokens = factory.get_tokenizer(TINY)(["a dog", "two red cars"])
    assert tokens.shape == (2, 16)
    jout = jcoca.forward(want, jcfg, jnp.asarray(images), jnp.asarray(tokens))
    with torch.no_grad():
        out = module(torch.from_numpy(images), torch.from_numpy(tokens))
    for k in ("image_features", "text_features", "logits"):
        _close(out[k], jout[k])
    # the file route: create_coca_model reads the same weights
    path = str(tmp_path / "coca.pt")
    torch.save(sd, path)
    loaded = tcoca.create_coca_model(TINY, path)
    for k, v in module.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


# ---------------------------------------------------------------------------
# the factory, the registry, the refusals
# ---------------------------------------------------------------------------

def test_factory_bundle_and_tokenizer():
    model = factory.create_model(TINY, device="cpu")
    assert isinstance(model, factory.CoCaModel)
    images = np.random.default_rng(7).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)
    beam = model.generate(images, seq_len=8)
    greedy = model.generate(images, generation_type="top_k", seq_len=8)
    assert beam.shape == greedy.shape == (2, 16)
    assert torch.equal(greedy, tcoca.generate(model.module,
                                              torch.from_numpy(images),
                                              seq_len=8))
    assert model.generate(images, generation_type="top_p",
                          seq_len=8).shape == (2, 16)
    with pytest.raises(ValueError, match="generation_type"):
        model.generate(images, generation_type="nucleus")
    feats = model.encode_image(images)
    np.testing.assert_allclose(feats.norm(dim=-1).detach().numpy(), 1.0,
                               rtol=1e-5)
    assert factory.get_tokenizer("coca_ViT-L-14").context_length == 76
    # the full-width config builds (random weights) on the CPU
    big = tcoca.create_coca_model("coca_ViT-L-14")
    assert big.visual.attn_pool.query.shape == (256, 768)
    assert len(big.visual.blocks) == 24


@pytest.mark.parametrize("name", ["coca_roberta-ViT-B-32",
                                  "coca-roberta-tiny-test"])
def test_hf_text_coca_raises_by_name(name):
    """The HF-text CoCa configs build since `hf_text` was ported (held to
    JAX in tests/test_torch_hf_text.py); their tokenizer (RoBERTa's) still
    raises by name: `transformers` and its vocabulary are absent."""
    assert name in tcoca.COCA_CONFIGS
    cfg = tcoca.get_coca_config(name)
    if name == "coca-roberta-tiny-test":
        module = tcoca.create_coca_model(name)
        assert isinstance(module.text, tcoca.HFTextTower)
        assert module.text.config.hidden_size == cfg.multimodal.width
    else:
        assert (cfg.hf_text_name, cfg.pad_id) == ("roberta-base", 1)
    with pytest.raises(NotImplementedError, match="vocabulary files"):
        factory.get_tokenizer(name)


# ---------------------------------------------------------------------------
# the command lines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """An OpenCLIP checkpoint of `coca-tiny-test` and a Karpathy-style
    set of 4 seeded 72 x 72 PNG images (the JAX builder decodes with
    Pillow) with 2 captions each."""
    from PIL import Image
    root = tmp_path_factory.mktemp("coca")
    ckpt = str(root / "coca.pt")
    torch.save(_openclip_dict(tcoca.get_coca_config(TINY), 9), ckpt)
    rng = np.random.default_rng(10)
    ann = []
    for i in range(4):
        Image.fromarray(rng.integers(0, 256, (72, 72, 3), dtype=np.uint8)
                        ).save(root / f"{i}.png")
        ann.append({"image": f"{i}.png",
                    "caption": ["a dog on the grass.", "two red cars."]})
    with open(root / "ann.json", "w") as f:
        json.dump(ann, f)
    return ckpt, str(root)


@pytest.mark.parametrize("extra", [
    # the JAX command line's beam search at this vocabulary (49,408)
    # compiles for ~15 s on the CPU
    pytest.param([], marks=pytest.mark.slow),
    ["--generation-type", "top_k"]], ids=["beam_search", "top_k"])
def test_captioning_command_line_matches_jax(files, monkeypatch, extra):
    """The same captions and metrics as the JAX command line (beam search,
    its default; the greedy loop through `evaluate_captioning` with
    generation_type "top_k", which the JAX command line cannot select).
    The beam search itself is held to JAX's, fast, by
    `test_beam_search_matches_jax`."""
    ckpt, root = files
    flags = ["eval", "--task", "captioning", "--model", TINY, "--pretrained",
             ckpt, "--dataset", "mscoco_captions", "--dataset-root", root,
             "--annotation-file", os.path.join(root, "ann.json"),
             "--batch-size", "4"]
    captions = {}
    for tag, mod in (("jax", jcap), ("torch", tcap)):
        inner = mod.bleu4

        def bleu4(cands, refs, _tag=tag, _inner=inner):
            captions[_tag] = list(cands)
            return _inner(cands, refs)
        monkeypatch.setattr(mod, "bleu4", bleu4)
    if extra:
        inner = jcap.evaluate_captioning
        monkeypatch.setattr(jcap, "evaluate_captioning",
                            lambda *a, **k: inner(*a, generation_type="top_k",
                                                  **k))
    want = jcli.main(flags)[0]
    got = tcli.main(flags + extra + ["--device", "cpu"])[0]
    assert captions["torch"] == captions["jax"]
    assert got["metrics"] == want["metrics"]
    assert got["metrics"]["num_samples"] == 4
    assert sorted(got) == sorted(want)


def _driver_flags(ckpt, logs):
    return ["--model", TINY, "--pretrained", ckpt, "--dataset-type",
            "synthetic", "--train-num-samples", "16", "--batch-size", "8",
            "--lr", "1e-4", "--logs", str(logs)]


def _rows(run_dir):
    with open(run_dir / "results.csv", newline="") as f:
        return list(csv.DictReader(f))


def test_captioning_command_line_bf16(files):
    """`--precision bf16` captions with the towers in bf16 (the JAX command
    line always computes in fp32)."""
    ckpt, root = files
    got = tcli.main(["eval", "--task", "captioning", "--model", TINY,
                     "--pretrained", ckpt, "--dataset", "mscoco_captions",
                     "--dataset-root", root, "--annotation-file",
                     os.path.join(root, "ann.json"), "--batch-size", "4",
                     "--generation-type", "top_k", "--precision", "bf16",
                     "--device", "cpu"])[0]["metrics"]
    assert got["num_samples"] == 4 and 0.0 <= got["bleu4"] <= 1.0


def test_contrastive_driver_trains_coca(files, tmp_path):
    """`--model coca-tiny-test` on synthetic pairs: two steps, the val
    eval skipped (as in JAX), a checkpoint; `--resume latest` goes on from
    the saved step.  The train step itself is held to JAX's by
    `test_coca_train_step_matches_jax`."""
    flags = _driver_flags(files[0], tmp_path) + ["--name", "run", "--device",
                                                  "cpu"]
    out = tcdriver.main(flags + ["--epochs", "1"])
    rows = _rows(tmp_path / "run")
    assert [r["epoch"] for r in rows] == ["0", "1"]
    assert rows[1]["clip_val_loss"] == "" and rows[0]["train_loss"] == "nan"
    assert np.isfinite(float(rows[1]["train_loss"])) and out["state"].step == 2
    out = tcdriver.main(flags + ["--epochs", "2", "--resume", "latest"])
    assert out["state"].step == 4
    assert [r["epoch"] for r in _rows(tmp_path / "run")] == ["0", "1", "2"]


# the JAX command line compiles its CoCa step for ~23 s on the CPU
@pytest.mark.slow
def test_contrastive_driver_trains_coca_as_jax(files, tmp_path):
    """The same results rows as the JAX command line from one checkpoint."""
    flags = _driver_flags(files[0], tmp_path) + ["--epochs", "1"]
    jcdriver.main(flags + ["--name", "jax"])
    tcdriver.main(flags + ["--name", "torch", "--device", "cpu"])
    got, want = _rows(tmp_path / "torch"), _rows(tmp_path / "jax")
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want]
    np.testing.assert_allclose(float(got[1]["train_loss"]),
                               float(want[1]["train_loss"]), rtol=1e-5)


@pytest.mark.parametrize("extra, match", [
    (["--siglip"], "contrastive\\+caption"),
    (["--accum-freq", "2"], "contrastive\\+caption")])
def test_contrastive_driver_refuses_what_coca_does_not_train(extra, match,
                                                             tmp_path):
    with pytest.raises(ValueError, match=match):
        tcdriver.main(["--model", TINY, "--dataset-type", "synthetic",
                       "--device", "cpu", "--logs", str(tmp_path)] + extra)


def test_profiler_coca_row_matches_jax():
    """`mparams` equal JAX's.  The operations: XLA counts the body of each
    tower's `lax.scan` over layers once and adds elementwise work, so
    JAX's figure is the port's with one block instead of L, within [1.0,
    1.3] of it at this size (the port counts the matrix products alone)."""
    want = jprofiler.profile_model(TINY)
    got = tprofiler.profile_model(TINY)
    for k in ("model", "image_size", "image_width", "text_width",
              "embed_dim", "mparams", "mparams_image", "mparams_text"):
        assert got[k] == want[k], k
    cfg = tcoca.get_coca_config(TINY)

    def block(L, D):
        return 2 * L * D * 3 * D + 2 * L * D * D + 4 * L * L * D \
            + 4 * L * D * 4 * D
    for tower, L, tc in (("image", cfg.vision.num_tokens, cfg.vision),
                         ("text", cfg.text.context_length + 1, cfg.text)):
        one_layer = got[f"gflops_{tower}"] * 1e9 \
            - (tc.layers - 1) * block(L, tc.width)
        assert 1.0 <= want[f"gflops_{tower}"] * 1e9 / one_layer <= 1.3, tower
