"""Plain text side of the reference: CLIP's byte-level BPE tokenizer, the
LEAF character edit and the word-validity constraint.

A frozen copy of the published algorithms (OpenAI CLIP's
`simple_tokenizer.py`, the LEAF paper's interleaved-slot edit and its
"distinct dictionary words must strictly decrease" constraint), written
out here so that the benchmark's yardstick does not move when the
program's tokenizer or attack code does.  Nothing here imports the program.

Departures from OpenAI's tokenizer: `ftfy` is not applied (the benchmark's
captions and edits are printable ASCII, which `ftfy` leaves alone), and the
word pattern's `\\p{L}`, `\\p{N}` and `\\s` are spelled out as code-point
ranges for the standard library's `re`.
"""
from __future__ import annotations

import functools
import gzip
import html
import os
import re
import string
import sys
import unicodedata
from typing import Dict, List, Sequence, Tuple

import numpy as np

VOCAB_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "bpe_simple_vocab_16e6.txt.gz")
CONTEXT = 77

# the attack's character vocabulary: delete (-1), lowercase, space,
# uppercase, digits, punctuation
EDIT_VOCAB: List[int] = (
    [-1] + [ord(c) for c in string.ascii_lowercase + " "
            + string.ascii_uppercase + string.digits + string.punctuation])


def _ranges(prefix: str) -> str:
    out, start = [], None
    for cp in range(sys.maxunicode + 2):
        inside = (cp <= sys.maxunicode
                  and unicodedata.category(chr(cp)).startswith(prefix))
        if inside and start is None:
            start = cp
        elif not inside and start is not None:
            out.append(f"\\U{start:08x}-\\U{cp - 1:08x}")
            start = None
    return "".join(out)


@functools.lru_cache()
def _classes() -> Tuple[str, str, str]:
    space = ("\\t-\\r \\x85\\xa0\\u1680\\u2000-\\u200a\\u2028\\u2029"
             "\\u202f\\u205f\\u3000")
    return _ranges("L"), _ranges("N"), space


def _bytes_to_unicode() -> Dict[int, str]:
    printable = (list(range(ord("!"), ord("~") + 1))
                 + list(range(ord("¡"), ord("¬") + 1))
                 + list(range(ord("®"), ord("ÿ") + 1)))
    mapping = {b: chr(b) for b in printable}
    shift = 0
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(256 + shift)
            shift += 1
    return mapping


class Tokenizer:
    """OpenAI CLIP's tokenizer: lower-cased, whitespace-collapsed text,
    split by CLIP's word pattern, each word byte-pair encoded; rows of
    SOT + ids + EOT, zero padded to 77, truncated with EOT kept last."""

    def __init__(self, path: str = VOCAB_FILE):
        b2u = _bytes_to_unicode()
        self.byte_encoder = b2u
        with gzip.open(path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")[1:49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(b2u.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += ["<start_of_text>", "<end_of_text>"]
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.sot = self.encoder["<start_of_text>"]
        self.eot = self.encoder["<end_of_text>"]
        letter, number, space = _classes()
        self.pattern = re.compile(
            r"<start_of_text>|<end_of_text>|'s|'t|'re|'ve|'m|'ll|'d"
            rf"|[{letter}]+|[{number}]|[^{space}{letter}{number}]+",
            re.IGNORECASE)
        self.cache: Dict[str, Tuple[int, ...]] = {}

    def whole_words(self) -> List[str]:
        """The vocabulary's whole-word entries of two or more ASCII
        letters, in merge order (frequent words first)."""
        out = []
        for tok in self.encoder:
            if tok.endswith("</w>"):
                w = tok[:-4]
                if len(w) >= 2 and w.isalpha() and w.isascii():
                    out.append(w)
        return out

    def _bpe(self, token: str) -> Tuple[int, ...]:
        hit = self.cache.get(token)
        if hit is not None:
            return hit
        word = [self.byte_encoder[b] for b in token.encode("utf-8")]
        word[-1] += "</w>"
        while len(word) > 1:
            pairs = [(self.ranks.get((a, b), None), i)
                     for i, (a, b) in enumerate(zip(word, word[1:]))]
            ranked = [p for p in pairs if p[0] is not None]
            if not ranked:
                break
            first, second = word[min(ranked)[1]], word[min(ranked)[1] + 1]
            out, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first \
                        and word[i + 1] == second:
                    out.append(first + second)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = out
        ids = tuple(self.encoder[w] for w in word)
        self.cache[token] = ids
        return ids

    def encode(self, text: str) -> List[int]:
        text = html.unescape(html.unescape(text)).strip()
        text = " ".join(text.split()).strip().lower()
        out: List[int] = []
        for word in self.pattern.findall(text):
            out.extend(self._bpe(word))
        return out

    def length(self, text: str) -> int:
        """Tokens of the row from SOT to EOT (at most the context)."""
        return min(len(self.encode(text)) + 2, CONTEXT)

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        rows = np.zeros((len(texts), CONTEXT), np.int64)
        for i, text in enumerate(texts):
            ids = self.encode(text)[:CONTEXT - 2]
            rows[i, :len(ids) + 2] = [self.sot, *ids, self.eot]
        return rows


@functools.lru_cache()
def tokenizer() -> Tokenizer:
    return Tokenizer()


def apply_edit(sentence: str, slot: int, code: int) -> str:
    """One LEAF edit at `slot` of the interleaved slot string (an empty
    slot before every character and one after the last: 2L + 1 slots):
    `code` -1 deletes, a character equal to the one already there deletes
    it too, any other character is written (an insertion into an empty
    slot, a substitution over a character)."""
    chars: List[str] = []
    real: List[bool] = []
    for ch in sentence:
        chars += ["_", ch]
        real += [False, True]
    chars.append("_")
    real.append(False)
    if code == -1 or chars[slot] == chr(code):
        real[slot] = False
    else:
        chars[slot] = chr(code)
        real[slot] = True
    return "".join(c for c, keep in zip(chars, real) if keep)


_WORD = None
_CONTRACTION = None


def _word_res():
    global _WORD, _CONTRACTION
    if _WORD is None:
        letter, number, space = _classes()
        _WORD = re.compile(rf"[{letter}{number}]+(?:'[{letter}]+)?"
                           rf"|[^{space}{letter}{number}]")
        _CONTRACTION = re.compile(
            rf"^([{letter}{number}]+)('(?:s|t|re|ve|m|ll|d))$",
            re.IGNORECASE)
    return _WORD, _CONTRACTION


class Constraint:
    """An edit is valid when the sentence's count of distinct dictionary
    words strictly decreases; the dictionary is the vocabulary's
    whole-word entries (no NLTK corpus on the card).  An invalid candidate
    is replaced by the clean sentence."""

    def __init__(self, words: Sequence[str]):
        self.words = frozenset(words)

    def count(self, sentence: str) -> int:
        word_re, contraction = _word_res()
        found = set()
        for tok in word_re.findall(sentence.lower()):
            m = contraction.match(tok)
            found.update(m.groups() if m else (tok,))
        return len(self.words & found)

    def apply(self, clean: str, edited: Sequence[str]) -> List[str]:
        lo = self.count(clean)
        return [e if self.count(e) < lo else clean for e in edited]
