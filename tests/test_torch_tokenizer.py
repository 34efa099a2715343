"""leaf_tpu_torch's tokenizer and context bucketing against the JAX
package's.

The port's tokenizer runs on the standard library's `re` (with Unicode
letter/number classes built from `unicodedata`); the ids must equal
those of `leaf_tpu.tokenizer`, which runs on `regex`.
"""
import numpy as np
import pytest
import torch

from leaf_tpu.attacks import engine as jengine
from leaf_tpu.models import config as jconfig
from leaf_tpu.tokenizer import get_tokenizer as jax_tokenizer
from leaf_tpu_torch.attacks import engine as tengine
from leaf_tpu_torch.models import config as tconfig
from leaf_tpu_torch.tokenizer import get_tokenizer as port_tokenizer

torch.set_num_threads(2)

CORPUS = [
    "a photo of a cat",
    "A stock market rally; the match ended 3-2.",
    "it's the dog's toy, isn't it? we'll see, they'd've known, I'm here",
    "1234 apples cost $5.60 (about 50%)!!!",
    "Tom &amp; Jerry & friends",
    "café résumé naïve Ångström façade",
    "é combining acute, ñ tilde",
    "½ ² Ⅻ ⅻ ٣ ४",
    "中文 一 二 三 日本語のテキスト 한국어",
    "emoji 😀🎉👍🏽 ❤️",
    "tabs\tand\nnewlines  and   spaces",
    "ypogegrammeni aͅb ͅ",
    "control \x1c\x1f characters",
    "<start_of_text> literal <end_of_text>",
    "UPPER lower MiXeD CaSe",
    "word " * 100,            # truncated to the context
    "",
]


@pytest.fixture(scope="module")
def tokenizers():
    return jax_tokenizer(), port_tokenizer()


def test_ids_match_jax(tokenizers):
    jtok, ttok = tokenizers
    np.testing.assert_array_equal(ttok(CORPUS), jtok(CORPUS))
    for text in CORPUS:
        assert ttok.encode(text) == jtok.encode(text), text


def test_context_length_and_truncation(tokenizers):
    jtok, ttok = tokenizers
    for ctx in (16, 77):
        out = ttok(CORPUS, context_length=ctx)
        np.testing.assert_array_equal(out, jtok(CORPUS, context_length=ctx))
        assert out.shape == (len(CORPUS), ctx)
        assert (out.argmax(-1) <= ctx - 1).all()
    long = ttok(["word " * 100])[0]
    assert long[-1] == ttok.eot_token_id and long[0] == ttok.sot_token_id


def test_tokenize_arrays_and_decode_match_jax(tokenizers):
    jtok, ttok = tokenizers
    for a, b in zip(ttok.tokenize_arrays(CORPUS), jtok.tokenize_arrays(CORPUS)):
        np.testing.assert_array_equal(a, b)
    for text in CORPUS:
        ids = jtok.encode(text)
        assert ttok.decode(ids) == jtok.decode(ids)


def test_bucketing_matches_jax(tokenizers):
    jtok, _ = tokenizers
    rng = np.random.default_rng(0)
    buffers = [jtok(CORPUS[:4]), jtok(CORPUS)]
    for n_eot in (3, 15, 31, 40, 63, 76):
        toks = rng.integers(1, 49000, size=(6, 77)).astype(np.int32)
        toks[:, n_eot] = 49407
        toks[:, n_eot + 1:] = 0
        buffers.append(toks)
    for toks in buffers:
        assert tengine.bucket_need(toks) == jengine.bucket_need(toks)
        np.testing.assert_array_equal(tengine.bucket_tokens(toks),
                                      jengine.bucket_tokens(toks))
        np.testing.assert_array_equal(tengine.bucket_tokens(toks, need=50),
                                      jengine.bucket_tokens(toks, need=50))
    assert tengine.CONTEXT_BUCKETS == jengine.CONTEXT_BUCKETS
    for name in ("ViT-tiny-test", "ViT-L-14-quickgelu"):
        assert tengine.can_bucket(tconfig.get_model_config(name)) \
            == jengine.can_bucket(jconfig.get_model_config(name))
    noncausal = tconfig.get_model_config("ViT-tiny-test")
    noncausal = type(noncausal)(**{**noncausal.__dict__, "text": type(
        noncausal.text)(no_causal_mask=True)})
    assert not tengine.can_bucket(noncausal)
