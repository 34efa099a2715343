"""leaf_tpu_torch's HF text towers against the JAX package's, in fp32 on the
CPU: RoBERTa, XLM-R, mT5 and T5 (the JAX side is Flax `transformers`, which
this test imports and the port does not), and the native M2M100 encoder,
each with every pooler and both heads, weights carried from the JAX
package by `interop.params_from_jax`; `call_with_tokens`; the
CustomTextCLIP bundle and the factory's HF-text route; the registry's HF
configs; local HF checkpoint directories saved by `transformers` loading
by key; and `coca-roberta-tiny-test`'s features and greedy ids.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

transformers = pytest.importorskip("transformers")

from leaf_tpu.models import coca as jcoca  # noqa: E402
from leaf_tpu.models import config as jconfig  # noqa: E402
from leaf_tpu.models import factory as jfactory  # noqa: E402
from leaf_tpu.models import hf_text as jhf  # noqa: E402
from leaf_tpu.models import m2m100 as jm2m  # noqa: E402
from leaf_tpu_torch.models import clip as tclip  # noqa: E402
from leaf_tpu_torch.models import coca as tcoca  # noqa: E402
from leaf_tpu_torch.models import coca_interop as tcinterop  # noqa: E402
from leaf_tpu_torch.models import config as tconfig  # noqa: E402
from leaf_tpu_torch.models import hf_encoders as tenc  # noqa: E402
from leaf_tpu_torch.models import hf_text as thf  # noqa: E402
from leaf_tpu_torch.models import interop as tinterop  # noqa: E402
from leaf_tpu_torch.models import m2m100 as tm2m  # noqa: E402
from leaf_tpu_torch.models.factory import create_model  # noqa: E402

torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=1e-4)
TINY = {
    "roberta": lambda: transformers.RobertaConfig(
        vocab_size=100, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=40, layer_norm_eps=1e-5),
    "xlm-roberta": lambda: transformers.XLMRobertaConfig(
        vocab_size=100, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=48,
        max_position_embeddings=40, layer_norm_eps=1e-5),
    "mt5": lambda: transformers.MT5Config(
        vocab_size=100, d_model=32, d_kv=8, d_ff=48, num_layers=2,
        num_heads=4),
    "t5": lambda: transformers.T5Config(
        vocab_size=100, d_model=32, d_kv=8, d_ff=48, num_layers=2,
        num_heads=4),
    "m2m_100": lambda: transformers.M2M100Config(
        vocab_size=100, d_model=32, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=4, decoder_attention_heads=4,
        encoder_ffn_dim=64, decoder_ffn_dim=64, max_position_embeddings=64),
}


def _np(t):
    return np.asarray(t, np.float32)


def _ids(seed=0, B=3, S=12, pad=1):
    """Seeded ids with ragged padding (row 1 from 7, row 2 from 4), and
    the matching mask."""
    ids = np.random.default_rng(seed).integers(3, 90, (B, S)).astype(
        np.int32)
    mask = np.ones((B, S), np.int32)
    for row, start in ((1, 7), (2, 4)):
        ids[row, start:] = pad
        mask[row, start:] = 0
    return ids, mask


def _pair(kind, pooler="mean_pooler", proj="linear", output_dim=16):
    """(JAX HFTextTower, the port's tower holding the same weights)."""
    cfg = TINY[kind]()
    j = jhf.HFTextTower(cfg, output_dim=output_dim, pooler_type=pooler,
                        proj_type=proj)
    t = thf.HFTextTower(cfg, output_dim=output_dim, pooler_type=pooler,
                        proj_type=proj)
    t.load_state_dict(tinterop.hf_text_params_from_jax(
        jax.tree.map(np.asarray, j.params)))
    return j, t.eval()


# ---------------------------------------------------------------------------
# The towers against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pooler", thf.POOLERS)
@pytest.mark.parametrize("proj", ["linear", "mlp"])
@pytest.mark.parametrize("kind", ["roberta", "xlm-roberta", "mt5"])
def test_poolers_and_heads_match_jax(kind, proj, pooler):
    j, t = _pair(kind, pooler, proj)
    ids, mask = _ids(pad=t.config.pad_token_id)
    want = j(j.params, ids, mask)
    want_n = j(j.params, ids, mask, normalize=True)
    with torch.no_grad():
        got = t(torch.from_numpy(ids), torch.from_numpy(mask))
        got_n = t(torch.from_numpy(ids), torch.from_numpy(mask), True)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    np.testing.assert_allclose(got_n.numpy(), _np(want_n), **TOL)


@pytest.mark.parametrize("kind", ["t5", "m2m_100"])
@pytest.mark.parametrize("pooler", ["mean_pooler", "cls_pooler"])
def test_t5_and_m2m100_towers_match_jax(kind, pooler):
    j, t = _pair(kind, pooler)
    ids, mask = _ids(1, pad=t.config.pad_token_id)
    with torch.no_grad():
        got = t(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), _np(j(j.params, ids, mask)),
                               **TOL)


@pytest.mark.parametrize("kind", list(TINY))
def test_mask_from_the_towers_pad_id_matches_jax(kind):
    """Without a mask both build it from the tower's own pad id; the mean
    pooler then respects it (a padded row differs from its unpadded
    form)."""
    j, t = _pair(kind)
    ids, _ = _ids(2, pad=t.config.pad_token_id)
    with torch.no_grad():
        got = t(torch.from_numpy(ids))
        full = t(torch.from_numpy(ids), torch.ones(ids.shape, dtype=torch.long))
    np.testing.assert_allclose(got.numpy(), _np(j(j.params, ids)), **TOL)
    assert (got[1] - full[1]).abs().max() > 1e-6
    torch.testing.assert_close(got[0], full[0])


@pytest.mark.parametrize("pooler", ["cls_pooler",
                                    "cls_last_hidden_state_pooler",
                                    "mean_pooler"])
def test_call_with_tokens_matches_jax(pooler):
    """The pooled features and the unprojected token states; the cls
    position is dropped for the cls pooler alone."""
    j, t = _pair("roberta", pooler)
    ids, mask = _ids(3)
    want_p, want_t = j.call_with_tokens(j.params, ids, mask)
    with torch.no_grad():
        got_p, got_t = t.call_with_tokens(torch.from_numpy(ids),
                                          torch.from_numpy(mask))
    assert got_t.shape[1] == (11 if pooler == "cls_pooler" else 12)
    np.testing.assert_allclose(got_p.numpy(), _np(want_p), **TOL)
    np.testing.assert_allclose(got_t.numpy(), _np(want_t), **TOL)


def test_roberta_pooler_exists_only_for_the_cls_pooler():
    for pooler in thf.POOLERS:
        t = thf.HFTextTower(TINY["roberta"](), 16, pooler)
        has = any(k.startswith("hf.pooler.") for k in t.state_dict())
        assert has == (pooler == "cls_pooler"), pooler


# ---------------------------------------------------------------------------
# M2M100
# ---------------------------------------------------------------------------

def _m2m_spec():
    return tm2m.M2M100Spec(vocab_size=100, d_model=32, layers=2, heads=4,
                           ffn_dim=64, max_positions=64)


def test_m2m100_tables_match_jax():
    np.testing.assert_array_equal(tm2m.sinusoid_table(66, 32, 1),
                                  jm2m.sinusoid_table(66, 32, 1))
    np.testing.assert_array_equal(tm2m.sinusoid_table(10, 7, 1),
                                  jm2m.sinusoid_table(10, 7, 1))
    ids, _ = _ids(4)
    np.testing.assert_array_equal(
        tm2m.position_ids_from_tokens(torch.from_numpy(ids), 1).numpy(),
        np.asarray(jm2m.position_ids_from_tokens(jnp.asarray(ids), 1)))


@pytest.mark.parametrize("masked", ["explicit", "from_pads"])
def test_m2m100_encode_matches_jax(masked):
    spec = tm2m.M2M100Spec(**dataclasses.asdict(_m2m_spec()))
    params = jax.tree.map(np.asarray, jm2m.init_m2m100_encoder(
        jax.random.PRNGKey(5), jm2m.M2M100Spec(**dataclasses.asdict(spec))))
    enc = tm2m.M2M100Encoder(spec)
    enc.load_state_dict(tm2m.m2m100_state_dict(params))
    ids, mask = _ids(6)
    m = mask if masked == "explicit" else None
    want = jm2m.m2m100_encode(jax.tree.map(jnp.asarray, params),
                              jm2m.M2M100Spec(**dataclasses.asdict(spec)),
                              jnp.asarray(ids), m)
    with torch.no_grad():
        got, pooled = enc(torch.from_numpy(ids),
                          None if m is None else torch.from_numpy(m))
    assert pooled is None
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_m2m100_checkpoint_loads_as_transformers_runs(tmp_path):
    """A saved `M2M100Model` (`model.encoder.*` keys) loads through
    `HFTextTower(dir, pretrained=True)`; its encoder gives transformers'
    last hidden state."""
    torch.manual_seed(0)
    model = transformers.M2M100Model(TINY["m2m_100"]()).eval()
    model.save_pretrained(tmp_path / "nllb")
    tower = thf.HFTextTower(str(tmp_path / "nllb"), 16, "cls_pooler",
                            pretrained=True, seed=0)
    ids, mask = _ids(7)
    with torch.no_grad():
        want = model.encoder(input_ids=torch.from_numpy(ids).long(),
                             attention_mask=torch.from_numpy(mask).long())
        got, _ = tower.hf(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(),
                               want.last_hidden_state.numpy(), **TOL)


# ---------------------------------------------------------------------------
# HF checkpoints by key
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,cls,pooler", [
    ("roberta", "RobertaModel", "cls_pooler"),
    ("roberta", "RobertaForMaskedLM", "mean_pooler"),
    ("xlm-roberta", "XLMRobertaModel", "mean_pooler"),
    ("mt5", "MT5EncoderModel", "mean_pooler"),
    ("mt5", "MT5ForConditionalGeneration", "mean_pooler")])
def test_saved_hf_checkpoint_loads_by_key(kind, cls, pooler, tmp_path,
                                          monkeypatch):
    """A directory written by `save_pretrained` (`config.json` and
    `model.safetensors`, read by the port's own reader) loads by key, the
    task heads' prefixes and extra keys left out; the tower then gives the
    torch model's last hidden state (and its pooler output)."""
    torch.manual_seed(1)
    model = getattr(transformers, cls)(TINY[kind]()).eval()
    model.save_pretrained(tmp_path / "m")
    tower = thf.HFTextTower(str(tmp_path / "m"), 16, pooler,
                            pretrained=True, seed=0)
    assert tower.config.model_type == kind
    ids, mask = _ids(8, pad=tower.config.pad_token_id)
    base = getattr(model, "roberta", None) or model
    if kind == "mt5":
        base = model.get_encoder() if hasattr(model, "get_encoder") else model
    with torch.no_grad():
        out = base(input_ids=torch.from_numpy(ids).long(),
                   attention_mask=torch.from_numpy(mask).long())
        got, got_pool = tower.hf(torch.from_numpy(ids),
                                 torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), out.last_hidden_state.numpy(),
                               **TOL)
    if cls == "RobertaModel":
        np.testing.assert_allclose(got_pool.numpy(),
                                   out.pooler_output.numpy(), **TOL)


def test_missing_pooler_keeps_its_init_and_other_keys_raise(tmp_path):
    torch.manual_seed(2)
    model = transformers.RobertaForMaskedLM(TINY["roberta"]())
    sd = model.state_dict()
    tower = thf.HFTextTower(TINY["roberta"](), 16, "cls_pooler", seed=0)
    before = tower.hf.pooler.dense.weight.clone()
    tenc.load_hf_weights(tower.hf, sd)
    assert torch.equal(tower.hf.pooler.dense.weight, before)
    del sd["roberta.encoder.layer.1.output.dense.weight"]
    with pytest.raises(KeyError, match="output.dense.weight"):
        tenc.load_hf_weights(tower.hf, sd)


@pytest.mark.parametrize("name", ["roberta-ViT-B-32",
                                  "xlm-roberta-base-ViT-B-32",
                                  "xlm-roberta-large-ViT-H-14",
                                  "mt5-base-ViT-B-32", "mt5-xl-ViT-H-14"])
def test_registry_towers_have_the_torch_models_keys(name):
    """Every HF-text registry tower, built on the meta device from its
    published config, has the key names and shapes of `transformers`'
    torch encoder (T5's tied `encoder.embed_tokens` aside)."""
    cfg = tconfig.get_model_config(name)
    d = thf._offline_hf_config(cfg.text.hf_model_name)
    kind = d["model_type"]
    hf_cfg = {"roberta": transformers.RobertaConfig,
              "xlm-roberta": transformers.XLMRobertaConfig,
              "mt5": transformers.MT5Config}[kind](**d)
    with torch.device("meta"):
        tower = thf.HFTextTower(cfg.text.hf_model_name, cfg.embed_dim,
                                cfg.text.hf_pooler_type,
                                cfg.text.hf_proj_type)
        ref = (transformers.MT5EncoderModel(hf_cfg) if kind == "mt5" else
               transformers.AutoModel.from_config(
                   hf_cfg, add_pooling_layer=False))
    want = {k: tuple(v.shape) for k, v in ref.state_dict().items()
            if k != "encoder.embed_tokens.weight"
            and not k.endswith("position_ids")}
    got = {k[3:]: tuple(v.shape) for k, v in tower.state_dict().items()
           if k.startswith("hf.")}
    assert got == want
    assert tuple(tower.proj["w"].shape) == (tower.config.d_model if
                                            kind == "mt5" else
                                            tower.config.hidden_size,
                                            cfg.embed_dim)


# ---------------------------------------------------------------------------
# CustomTextCLIP
# ---------------------------------------------------------------------------

def test_registry_hf_configs_match_jax():
    names = [n for n in jconfig.list_models(include_coca=False)
             if jconfig.get_model_config(n).text.hf_model_name]
    assert sorted(names) == sorted(
        ["roberta-ViT-B-32", "xlm-roberta-base-ViT-B-32",
         "xlm-roberta-large-ViT-H-14", "mt5-base-ViT-B-32",
         "mt5-xl-ViT-H-14", "nllb-clip-base", "nllb-clip-large",
         "nllb-clip-base-siglip", "nllb-clip-large-siglip"])
    for n in names:
        j, t = jconfig.get_model_config(n), tconfig.get_model_config(n)
        assert dataclasses.asdict(j.text) == dataclasses.asdict(t.text), n
        assert dataclasses.asdict(j.vision) == dataclasses.asdict(t.vision)
        for f in ("embed_dim", "quick_gelu", "init_logit_bias",
                  "image_mean", "image_std"):
            assert getattr(j, f) == getattr(t, f), (n, f)
        assert (j.trunk is None) == (t.trunk is None)


def _tiny_custom(module):
    return module.config_from_open_clip_dict("hf-tiny-test", {
        "embed_dim": 16,
        "vision_cfg": {"image_size": 32, "patch_size": 16, "width": 32,
                       "layers": 2, "head_width": 16},
        "text_cfg": {"hf_model_name": "_tiny_roberta_test",
                     "hf_pooler_type": "mean_pooler",
                     "hf_proj_type": "linear"}})


def test_custom_text_clip_route_matches_jax(monkeypatch):
    """A CustomTextCLIP config (an HF tower beside a ViT) through both
    factories: the JAX bundle's weights carried to the port give its image
    and text features; the HF tower stays fp32 under bf16 and a unified
    checkpoint is refused, as in the JAX package."""
    jcfg, tcfg = _tiny_custom(jconfig), _tiny_custom(tconfig)
    monkeypatch.setitem(jconfig._REGISTRY, "hf-tiny-test", jcfg)
    monkeypatch.setitem(tconfig._REGISTRY, "hf-tiny-test", tcfg)
    jm = jfactory.create_model("hf-tiny-test")
    module = tclip.CLIP(tcfg)
    module.load_state_dict(tinterop.params_from_jax(
        jax.tree.map(np.asarray, jm.params)))
    ids, _ = _ids(9)
    images = np.random.default_rng(10).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        got_t = module.encode_text(torch.from_numpy(ids), normalize=True)
        got_i = module.encode_image(torch.from_numpy(images))
    np.testing.assert_allclose(got_t.numpy(),
                               _np(jm.encode_text(ids, normalize=True)),
                               **TOL)
    np.testing.assert_allclose(got_i.numpy(), _np(jm.encode_image(images)),
                               **TOL)
    bf16 = create_model("hf-tiny-test", precision="bf16", device="cpu")
    assert isinstance(bf16.module.text, thf.HFTextTower)
    assert all(p.dtype == torch.float32
               for p in bf16.module.text.parameters())
    assert bf16.module.visual.patch_embedding.dtype == torch.bfloat16
    assert bf16.encode_text(ids).dtype == torch.float32
    with pytest.raises(ValueError, match="unified checkpoint"):
        create_model("hf-tiny-test", pretrained=__file__, device="cpu")


def test_custom_text_clip_bundle_matches_jax():
    cfg = TINY["roberta"]()
    jt = jhf.HFTextTower(cfg, output_dim=16)
    vcfg = dict(image_size=32, patch_size=16, width=32, layers=1,
                head_width=16, output_dim=16)
    jparams, jimg, jtxt = jhf.create_custom_text_clip(
        jconfig.VisionConfig(**vcfg), jt, 16)
    tt = thf.HFTextTower(cfg, output_dim=16)
    module, timg, ttxt = thf.create_custom_text_clip(
        tconfig.VisionConfig(**vcfg), tt, 16)
    sd = tinterop.params_from_jax(jax.tree.map(np.asarray, jparams))
    module.load_state_dict(sd)
    ids, mask = _ids(11)
    images = np.random.default_rng(12).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        got_t = ttxt(torch.from_numpy(ids), torch.from_numpy(mask), True)
        got_i = timg(torch.from_numpy(images), True)
    np.testing.assert_allclose(
        got_t.numpy(), _np(jtxt(jparams, ids, mask, normalize=True)), **TOL)
    np.testing.assert_allclose(
        got_i.numpy(), _np(jimg(jparams, jnp.asarray(images),
                                normalize=True)), **TOL)


# ---------------------------------------------------------------------------
# coca_roberta
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def coca_pair():
    jcfg = jcoca.get_coca_config("coca-roberta-tiny-test")
    tcfg = tcoca.get_coca_config("coca-roberta-tiny-test")
    params = jcoca.init_coca(jax.random.PRNGKey(3), jcfg)
    module = tcoca.CoCa(tcfg)
    module.load_state_dict(tcinterop.coca_params_from_jax(
        jax.tree.map(np.asarray, params)))
    return jcfg, params, module.eval()


def test_coca_roberta_features_match_jax(coca_pair):
    jcfg, params, module = coca_pair
    ids = np.random.default_rng(13).integers(3, 99, (3, 16)).astype(np.int32)
    ids[1, 9:] = 1
    images = np.random.default_rng(14).standard_normal(
        (3, 64, 64, 3)).astype(np.float32)
    want_t, want_tok = jcoca.encode_text_coca(params, jcfg, jnp.asarray(ids))
    want_i, _ = jcoca.encode_image_coca(params, jcfg, jnp.asarray(images))
    with torch.no_grad():
        got_t, got_tok = module.encode_text(torch.from_numpy(ids))
        got_i, _ = module.encode_image(torch.from_numpy(images))
    assert isinstance(module.text, thf.HFTextTower)
    np.testing.assert_allclose(got_t.numpy(), _np(want_t), **TOL)
    np.testing.assert_allclose(got_tok.numpy(), _np(want_tok), **TOL)
    np.testing.assert_allclose(got_i.numpy(), _np(want_i), **TOL)


def test_coca_roberta_greedy_ids_match_jax(coca_pair):
    """Greedy generation re-encodes the whole sequence at each step (the
    bidirectional tower is not prefix-stable, as the JAX package's
    `use_cache=False`); the ids are identical.  The tiny config keeps the
    CLIP BPE's special ids, outside its 100-token vocabulary (JAX's
    gathers clamp them, torch's raise), so both are given roberta's
    (bos 0, eos 2, pad 1)."""
    jcfg, params, module = coca_pair
    images = np.random.default_rng(15).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)
    ids = dict(sot_token_id=0, eos_token_id=2, pad_id=1)
    want = jcoca.generate(params, jcfg, jnp.asarray(images),
                          jax.random.PRNGKey(0), seq_len=8, top_k=1, **ids)
    got = tcoca.generate(module, torch.from_numpy(images), seq_len=8, **ids)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[:, 0] == 0).all() and (got[:, 7] == 2).all()


def test_coca_roberta_beam_search_ids_match_jax(coca_pair):
    """The group beam search on the re-encoded prefix (no cache for the
    bidirectional tower), K 4 in G 2 groups: the JAX package's ids."""
    jcfg, params, module = coca_pair
    images = np.random.default_rng(16).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)
    ids = dict(sot_token_id=0, eos_token_id=2, pad_id=1)
    want = jcoca.generate_beamsearch(params, jcfg, jnp.asarray(images),
                                     num_beams=4, num_beam_groups=2,
                                     seq_len=7, **ids)
    got = tcoca.generate_beamsearch(module, torch.from_numpy(images),
                                    num_beams=4, num_beam_groups=2,
                                    seq_len=7, **ids)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
