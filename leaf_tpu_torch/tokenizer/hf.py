"""Text cleaning of the HF-backed tokenizers (port of the plain-Python part
of `leaf_tpu/tokenizer/hf.py`).

`canonicalize_text` is big_vision's prompt canonicalizer, SigLIP's
`clean='canonicalize'`; `get_clean_fn` picks a cleaner by name.  The
tokenizers themselves (`HFTokenizer`, `SigLipTokenizer`) need the
`transformers` package and the SentencePiece, BERT, RoBERTa, XLM-R, mT5
or NLLB vocabularies, which neither the repository nor the card machine
has: they wait for those files (ROADMAP, "waiting for files"), and
`models.factory.get_tokenizer` raises for a config that names one.  The
towers themselves (`models/hf_text.py`) take token ids.
"""
from __future__ import annotations

import string

from leaf_tpu_torch.tokenizer.bpe import basic_clean, whitespace_clean


def canonicalize_text(text: str, *, keep_punctuation_exact_string=None,
                      trans_punctuation: dict = str.maketrans(
                          "", "", string.punctuation)) -> str:
    """Lowercase, strip punctuation and collapse whitespace (big_vision's
    prompt canonicalizer); `keep_punctuation_exact_string` survives."""
    text = text.replace("_", " ")
    if keep_punctuation_exact_string:
        text = keep_punctuation_exact_string.join(
            part.translate(trans_punctuation)
            for part in text.split(keep_punctuation_exact_string))
    else:
        text = text.translate(trans_punctuation)
    text = text.lower()
    text = " ".join(text.split())
    return text.strip()


def get_clean_fn(kind: str):
    if kind == "canonicalize":
        return lambda x: canonicalize_text(basic_clean(x))
    if kind == "lower":
        return lambda x: whitespace_clean(basic_clean(x)).lower()
    if kind == "whitespace":
        return lambda x: whitespace_clean(basic_clean(x))
    raise ValueError(f"invalid clean function {kind!r}")
