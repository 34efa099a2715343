"""Word-validity constraint for text attacks (port of
`leaf_tpu/attacks/constraint.py`).

The constrained attack mode only accepts an edit if it does not create
new dictionary words: the count of *distinct dictionary words* in the
sentence must strictly decrease (IEEE 10741578; used with `--constrain`,
the setting of every released LEAF model).

The reference uses NLTK's `words` corpus + Punkt tokenization.  Those
corpora require downloads, so the dictionary here is pluggable:

  * if a local NLTK `words` corpus is available it is used verbatim;
  * otherwise we fall back to a built-in lexicon derived from the CLIP
    BPE vocabulary's full-word entries (tokens ending in `</w>`), which
    covers the frequent English words that matter for the "did the edit
    create a new word" test.

Tokenization is a Punkt-approximation: split on whitespace, strip
punctuation into separate tokens, split standard contractions.  The
word pattern runs on the standard library's `re`, with `\\p{L}`, `\\p{N}`
and `\\s` spelled out as code-point ranges (`tokenizer.bpe`), and gives
the JAX package's tokens.
"""
from __future__ import annotations

import functools
import re
from typing import List, Optional, Sequence, Set, Union

import numpy as np

from leaf_tpu_torch.attacks import edits
from leaf_tpu_torch.tokenizer.bpe import _LETTER, _NUMBER, _SPACE

_TOKEN_RE = re.compile(rf"[{_LETTER}{_NUMBER}]+(?:'[{_LETTER}]+)?"
                       rf"|[^{_SPACE}{_LETTER}{_NUMBER}]")
_CONTRACTION_RE = re.compile(
    rf"^([{_LETTER}{_NUMBER}]+)('(?:s|t|re|ve|m|ll|d))$", re.IGNORECASE)


def word_tokenize(text: str) -> List[str]:
    """Lightweight word tokenizer (Punkt stand-in for validity checks)."""
    out: List[str] = []
    for tok in _TOKEN_RE.findall(text):
        m = _CONTRACTION_RE.match(tok)
        if m:
            out.extend(m.groups())
        else:
            out.append(tok)
    return out


@functools.lru_cache()
def _nltk_words() -> Optional[frozenset]:
    try:
        from nltk.corpus import words
        return frozenset(words.words())
    except Exception:
        return None


@functools.lru_cache()
def _bpe_words() -> frozenset:
    """English lexicon from the BPE vocab's whole-word entries."""
    from leaf_tpu_torch.tokenizer import get_tokenizer
    tok = get_tokenizer()
    out = set()
    for t in tok.encoder:
        if t.endswith("</w>"):
            w = t[:-4]
            if len(w) >= 2 and w.isalpha() and w.isascii():
                out.add(w)
    return frozenset(out)


class WordConstraint:
    """Validity checker: attack valid iff distinct-dictionary-word count
    strictly decreases vs the original sentence."""

    def __init__(self, words: Optional[Set[str]] = None):
        if words is None:
            words = _nltk_words() or _bpe_words()
        self.words = words
        self._native_checked = False
        self._native = None

    def _get_native(self):
        """The native checker for this word set (built at first use; a
        failed build raises), or None when `LEAF_TPU_NO_NATIVE_TOKENIZER`
        asks for the Python path."""
        if not self._native_checked:
            from leaf_tpu_torch.tokenizer.native_binding import NativeWordDict
            self._native = NativeWordDict.create(self.words)
            self._native_checked = True
        return self._native

    def valid_edits_batch(self, originals: Sequence[str], zs, cps,
                          alternative: int = -1):
        """Vectorised validity for [B, rho] (slot, codepoint) edits —
        the constrained fused-step fast path (C++ for ASCII sentences; the
        Python recount otherwise).  Semantics identical to
        `valid(original, apply_edit(original, z, ·))` per slot."""
        zs = np.asarray(zs)
        cps = np.asarray(cps)
        native = self._get_native()
        if native is not None and all(
                s.isascii() for s in originals):
            return native.valid_edits(originals, zs, cps, alternative)
        out = np.zeros(zs.shape, bool)
        for i, S in enumerate(originals):
            lo = self.count(S)
            for j in range(zs.shape[1]):
                cand = edits.apply_edit(S, int(zs[i, j]), 0,
                                         [int(cps[i, j])],
                                         alternative=alternative)
                out[i, j] = self.count(cand) < lo
        return out

    def count(self, sentence: str) -> int:
        return len(self.words.intersection(word_tokenize(sentence.lower())))

    def valid(self, original: str, attacked: Union[str, Sequence[str]]) -> List[bool]:
        """Per-candidate validity."""
        if isinstance(attacked, str):
            attacked = [attacked]
        lo = self.count(original)
        return [self.count(a) < lo for a in attacked]

    def filter(self, original: str, attacked: Sequence[str]) -> List[str]:
        """Replace invalid candidates by the original sentence — the
        in-place no-op used by every constrained attack."""
        v = self.valid(original, attacked)
        return [a if ok else original for a, ok in zip(attacked, v)]

    def filter_batched(self, originals: Sequence[str],
                       attacked: Sequence[Sequence[str]]) -> List[List[str]]:
        return [self.filter(o, cands) for o, cands in zip(originals, attacked)]
