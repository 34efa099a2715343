"""leaf_tpu_torch.models.prefix_encode against the JAX package's
`prefix_encode`, in fp32 on the CPU: one case for each of
`tests/test_prefix_encode.py`'s four (suffix = full, packed = full, the
identical candidate, bucket padding), on the same numpy-seeded captions
and JAX-initialised weights, at the JAX tests' own tolerance (atol 2e-5,
rtol 1e-5) against JAX and against the port's own full encode.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from leaf_tpu.attacks import edits
from leaf_tpu.attacks.engine import bucket_tokens
from leaf_tpu.models import clip as jclip
from leaf_tpu.models import prefix_encode as jpe
from leaf_tpu.models.config import get_model_config as jget_config
from leaf_tpu.tokenizer import get_tokenizer
from leaf_tpu_torch.models import clip as tclip
from leaf_tpu_torch.models import interop as tinterop
from leaf_tpu_torch.models import prefix_encode as tpe
from leaf_tpu_torch.models.config import get_model_config as tget_config

torch.set_num_threads(2)

MODEL = "ViT-tiny-test"
TOL = dict(atol=2e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config(MODEL)
    params = jclip.init_clip(jax.random.PRNGKey(0), jcfg)
    module = tclip.CLIP(tget_config(MODEL))
    module.load_state_dict(tinterop.params_from_jax(
        jax.tree.map(np.asarray, params)))
    tok = get_tokenizer(context_length=jcfg.text.context_length)
    rng = np.random.default_rng(0)
    words = "stocks rally tech chip world cup final ancient fossil".split()
    texts = [" ".join(rng.choice(words, size=4)) for _ in range(8)]
    clean = bucket_tokens(np.asarray(tok(texts)))
    cand, sent_idx = _attack_candidates(texts, tok, rng)
    return jcfg, params, module.eval().text, clean, bucket_tokens(cand), \
        sent_idx


def _attack_candidates(texts, tok, rng, rho=6):
    """Leaf probes (a space substituted at rho random positions) and one
    row identical to its clean sentence."""
    space_u = edits.DEFAULT_VOCAB.index(ord(" "))
    cands, sent_idx = [], []
    for i, s in enumerate(texts):
        for z in edits.sample_positions(len(s), rho, rng=rng):
            cands.append(edits.apply_edit(s, int(z), space_u,
                                          alternative=-1))
            sent_idx.append(i)
    cands.append(texts[0])
    sent_idx.append(0)
    return np.asarray(tok(cands)), np.asarray(sent_idx, np.int32)


def _split_both(cand, clean, sent_idx, bucket=0):
    """suffix_split in both packages: identical integers."""
    got = tpe.suffix_split(cand, clean, sent_idx, bucket)
    want = jpe.suffix_split(cand, clean, sent_idx, bucket)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    return got


def _jax_full(jcfg, params, cand):
    return np.asarray(jclip.encode_text(
        params["text"], jcfg.text, jnp.asarray(cand), jcfg.quick_gelu, True,
        jnp.float32))


def _port(tower, clean, suffix, sent_idx, prefix_len, packed, target=128):
    t = torch.from_numpy
    with torch.no_grad():
        ks, vs = tpe.clean_kv(tower, t(clean))
        fn = tpe.encode_text_suffix_packed if packed else \
            tpe.encode_text_suffix
        kw = {"target": target} if packed else {}
        return fn(tower, t(suffix), t(sent_idx), t(prefix_len), ks, vs,
                  normalize=True, **kw).numpy()


def _jax(jcfg, params, clean, suffix, sent_idx, prefix_len, packed,
         target=128):
    ks, vs = jpe.clean_kv(params["text"], jcfg.text, jnp.asarray(clean),
                          jcfg.quick_gelu, jnp.float32)
    args = (params["text"], jcfg.text, jnp.asarray(suffix),
            jnp.asarray(sent_idx), jnp.asarray(prefix_len), ks, vs,
            jcfg.quick_gelu, True, jnp.float32)
    if packed:
        return np.asarray(jpe.encode_text_suffix_packed(*args,
                                                        target=target))
    return np.asarray(jpe.encode_text_suffix(*args))


def test_clean_kv_matches_jax(setup):
    jcfg, params, tower, clean, _, _ = setup
    want = jpe.clean_kv(params["text"], jcfg.text, jnp.asarray(clean),
                        jcfg.quick_gelu, jnp.float32)
    with torch.no_grad():
        got = tpe.clean_kv(tower, torch.from_numpy(clean))
    L, (B, S) = jcfg.text.layers, clean.shape
    for g, w in zip(got, want):
        assert tuple(g.shape) == (L, B, S, jcfg.text.width)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_suffix_encode_matches_full(setup):
    jcfg, params, tower, clean, cand, sent_idx = setup
    suffix, prefix_len = _split_both(cand, clean, sent_idx)
    assert suffix.shape[1] < clean.shape[1]     # there are savings
    got = _port(tower, clean, suffix, sent_idx, prefix_len, packed=False)
    with torch.no_grad():
        full = tower.encode_text(torch.from_numpy(cand),
                                 normalize=True).numpy()
    np.testing.assert_allclose(got, full, **TOL)
    np.testing.assert_allclose(got, _jax_full(jcfg, params, cand), **TOL)
    np.testing.assert_allclose(
        got, _jax(jcfg, params, clean, suffix, sent_idx, prefix_len, False),
        **TOL)


def test_suffix_encode_packed_matches_full(setup):
    jcfg, params, tower, clean, cand, sent_idx = setup
    n = (cand.shape[0] // 8) * 8                # N divides into the groups
    cand, sent_idx = cand[:n], sent_idx[:n]
    suffix, prefix_len = _split_both(cand, clean, sent_idx, bucket=4)
    got = _port(tower, clean, suffix, sent_idx, prefix_len, packed=True,
                target=32)
    with torch.no_grad():
        full = tower.encode_text(torch.from_numpy(cand),
                                 normalize=True).numpy()
    np.testing.assert_allclose(got, full, **TOL)
    np.testing.assert_allclose(got, _jax_full(jcfg, params, cand), **TOL)
    np.testing.assert_allclose(
        got, _jax(jcfg, params, clean, suffix, sent_idx, prefix_len, True,
                  target=32), **TOL)


def test_suffix_split_identical_candidate(setup):
    jcfg, params, tower, clean, _, _ = setup
    cand = clean[:1].copy()
    sent_idx = np.zeros(1, np.int32)
    suffix, prefix_len = _split_both(cand, clean, sent_idx)
    eot = int(clean[0].argmax())
    assert prefix_len[0] == eot and suffix[0, 0] == clean[0, eot]
    # the identical row re-derives its EOT state alone: still the full
    # encode's features
    got = _port(tower, clean, suffix, sent_idx, prefix_len, packed=False)
    np.testing.assert_allclose(got, _jax_full(jcfg, params, cand), **TOL)


def test_suffix_split_bucket_padding(setup):
    jcfg, params, tower, clean, cand, sent_idx = setup
    suffix, prefix_len = _split_both(cand, clean, sent_idx, bucket=4)
    assert suffix.shape[1] % 4 == 0
    # padding past each suffix is id 0, and the features do not move
    got = _port(tower, clean, suffix, sent_idx, prefix_len, packed=False)
    np.testing.assert_allclose(got, _jax_full(jcfg, params, cand), **TOL)
