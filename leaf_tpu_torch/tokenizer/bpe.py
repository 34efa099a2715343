"""Byte-pair-encoding CLIP tokenizer (port of `leaf_tpu/tokenizer/bpe.py`).

The OpenAI CLIP byte-BPE scheme (vocab `bpe_simple_vocab_16e6.txt.gz`,
49408 ids, SOT=49406, EOT=49407, context length 77), giving the same ids
as the JAX package's tokenizer.  Differences:

  * the word pattern runs on the standard library's `re`, which has no
    `\\p{L}` / `\\p{N}`: both classes are built once at import from
    `unicodedata` categories (`L*`, `N*`), folded into code-point
    ranges.  `[^\\W\\d_]` is not a substitute (Python's `\\w` also admits
    No/Nl characters such as '½');
  * the native C++ fast path (`native_binding`, built at first use) is
    taken for printable-ASCII batches as there, but a failed build raises
    instead of falling back, and `CLIPTokenizer.counts` records how many
    calls and texts went each way;
  * the vocabulary file is the port's own copy, in
    `leaf_tpu_torch/models/assets/`.
"""
from __future__ import annotations

import functools
import gzip
import html
import os
import re
import sys
import unicodedata
from typing import Iterable, List, Optional, Sequence, Union

import numpy as np

try:  # text fixing is optional (ascii-only attack text is unaffected)
    import ftfy

    def _fix_text(t: str) -> str:
        return ftfy.fix_text(t)
except ImportError:  # pragma: no cover
    def _fix_text(t: str) -> str:
        return t

# printable ASCII without '&' (the Python clean html-unescapes it): the
# native fast path's contract; control characters would truncate at NUL
_NATIVE_SAFE = re.compile(r"[ -%'-~]*")

DEFAULT_CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408
SOT_ID = 49406
EOT_ID = 49407

DEFAULT_BPE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "models",
    "assets", "bpe_simple_vocab_16e6.txt.gz")


def _class_body(ranges) -> str:
    """Character-class body (no brackets) for inclusive code-point ranges."""
    return "".join(f"\\U{a:08x}" if a == b else f"\\U{a:08x}-\\U{b:08x}"
                   for a, b in ranges)


def _category_ranges(prefix: str):
    """Code-point ranges of every character whose Unicode general category
    starts with `prefix`."""
    ranges = []
    start = None
    for cp in range(sys.maxunicode + 2):
        inside = (cp <= sys.maxunicode
                  and unicodedata.category(chr(cp)).startswith(prefix))
        if inside and start is None:
            start = cp
        elif not inside and start is not None:
            ranges.append((start, cp - 1))
            start = None
    return ranges


_LETTER = _class_body(_category_ranges("L"))
_NUMBER = _class_body(_category_ranges("N"))
# the Unicode White_Space property, which is what `regex` means by \s;
# the standard library's \s also admits \x1c-\x1f
_SPACE = _class_body([(0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0),
                      (0x1680, 0x1680), (0x2000, 0x200A), (0x2028, 0x2029),
                      (0x202F, 0x202F), (0x205F, 0x205F), (0x3000, 0x3000)])

# `leaf_tpu.tokenizer.bpe._WORD_PATTERN` with \p{L}, \p{N} and \s spelled out
_WORD_PATTERN = (
    r"""<start_of_text>|<end_of_text>|'s|'t|'re|'ve|'m|'ll|'d"""
    rf"""|[{_LETTER}]+|[{_NUMBER}]|[^{_SPACE}{_LETTER}{_NUMBER}]+"""
)
# U+0345 (a combining mark) case-folds to a letter: under IGNORECASE the
# standard library counts it as a letter, while `regex` matches it with
# no alternative, so it only separates tokens there.  A space does the same.
_UNMATCHED = {0x345: " "}


@functools.lru_cache()
def byte_to_unicode() -> dict:
    """Reversible byte->printable-unicode map (standard GPT-2/CLIP scheme).

    Insertion order matters: the first 256 vocab ids follow this dict's
    order, printable bytes first ('!'..'~', '¡'..'¬', '®'..'ÿ'), then the
    remaining bytes mapped to shifted code points.
    """
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


def basic_clean(text: str) -> str:
    text = _fix_text(text)
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return " ".join(text.split()).strip()


def clean_lower(text: str) -> str:
    return whitespace_clean(basic_clean(text)).lower()


class CLIPTokenizer:
    """CLIP byte-BPE tokenizer with batched fixed-shape output."""

    def __init__(self,
                 bpe_path: str = DEFAULT_BPE_PATH,
                 context_length: Optional[int] = DEFAULT_CONTEXT_LENGTH):
        b2u = byte_to_unicode()
        self._byte_enc = [b2u[b] for b in range(256)]
        self._byte_dec = {v: k for k, v in b2u.items()}

        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # line 0 is a version header; 48894 merges follow (49152-256-2 slots)
        merges = [tuple(line.split()) for line in lines[1:48894 + 1]]

        vocab: List[str] = list(b2u.values())
        vocab += [tok + "</w>" for tok in b2u.values()]
        vocab += ["".join(pair) for pair in merges]
        vocab += ["<start_of_text>", "<end_of_text>"]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.merge_rank = {pair: i for i, pair in enumerate(merges)}

        self.vocab_size = len(vocab)
        self.sot_token_id = self.encoder["<start_of_text>"]
        self.eot_token_id = self.encoder["<end_of_text>"]
        self.context_length = context_length
        self.pattern = re.compile(_WORD_PATTERN, re.IGNORECASE)
        # raw regex token -> tuple of ids
        self._cache: dict = {
            "<start_of_text>": (self.sot_token_id,),
            "<end_of_text>": (self.eot_token_id,),
        }
        self._bpe_path = bpe_path
        # the native tokenizer is looked up (and built) at the first call
        self._native = None
        self._native_checked = False
        # which path took the work: `__call__` counts its calls and texts,
        # the attacks' fused edit+tokenize grids count as native
        self.counts = {"native_calls": 0, "native_texts": 0,
                       "python_calls": 0, "python_texts": 0}

    def native(self):
        """The native tokenizer of this vocabulary (built at first use), or
        None when `LEAF_TPU_NO_NATIVE_TOKENIZER` asks for the Python path."""
        if not self._native_checked:
            from leaf_tpu_torch.tokenizer.native_binding import get_native
            self._native = get_native(self._bpe_path)
            self._native_checked = True
        return self._native

    def count(self, path: str, texts: int) -> None:
        self.counts[f"{path}_calls"] += 1
        self.counts[f"{path}_texts"] += texts

    # -- core BPE ----------------------------------------------------------

    def _bpe_ids(self, token: str) -> tuple:
        """Encode one regex token into BPE ids (cached)."""
        hit = self._cache.get(token)
        if hit is not None:
            return hit
        units = [self._byte_enc[b] for b in token.encode("utf-8")]
        units[-1] += "</w>"
        rank = self.merge_rank
        # iteratively merge the lowest-rank adjacent pair
        while len(units) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(units) - 1):
                r = rank.get((units[i], units[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_i < 0:
                break
            merged = units[best_i] + units[best_i + 1]
            # merge *every* occurrence of this pair left-to-right
            out = []
            i = 0
            first, second = units[best_i], units[best_i + 1]
            while i < len(units):
                if i < len(units) - 1 and units[i] == first and units[i + 1] == second:
                    out.append(merged)
                    i += 2
                else:
                    out.append(units[i])
                    i += 1
            units = out
        enc = self.encoder
        ids = tuple(enc[u] for u in units)
        self._cache[token] = ids
        return ids

    def encode(self, text: str) -> List[int]:
        """Encode one string -> list of BPE ids (no SOT/EOT)."""
        out: List[int] = []
        words = self.pattern.findall(clean_lower(text).translate(_UNMATCHED))
        for token in words:
            out.extend(self._bpe_ids(token))
        return out

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        raw = bytearray(self._byte_dec[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    # -- batched fixed-shape API ------------------------------------------

    def __call__(self, texts: Union[str, Sequence[str]],
                 context_length: Optional[int] = None) -> np.ndarray:
        """Tokenize to a fixed [N, context_length] int32 array: SOT + ids +
        EOT, zero padding; truncation keeps EOT as the final token."""
        if isinstance(texts, str):
            texts = [texts]
        ctx = context_length or self.context_length
        # native C++ fast path for printable-ASCII batches (the attack
        # workload); the Python path below stays the source of truth and
        # takes every other input
        native = self.native()
        if native is not None and all(
                _NATIVE_SAFE.fullmatch(t) for t in texts):
            self.count("native", len(texts))
            return native.encode_batch(list(texts), ctx)
        self.count("python", len(texts))
        result = np.zeros((len(texts), ctx), dtype=np.int32)
        sot, eot = self.sot_token_id, self.eot_token_id
        for i, text in enumerate(texts):
            ids = self.encode(text)
            if len(ids) > ctx - 2:
                ids = ids[:ctx - 2]
                result[i, :] = [sot] + ids + [eot]
            else:
                result[i, 0] = sot
                result[i, 1:1 + len(ids)] = ids
                result[i, 1 + len(ids)] = eot
        return result

    def tokenize_arrays(self, texts: Sequence[str],
                        context_length: Optional[int] = None):
        """Tokenize -> (tokens [N,C] int32, lengths [N] int32)."""
        # length = EOT position + 1 (EOT is the max id), not a nonzero
        # count: vocab id 0 is the '!' byte token
        toks = self(texts, context_length)
        lengths = (toks.argmax(axis=-1) + 1).astype(np.int32)
        return toks, lengths


@functools.lru_cache()
def get_tokenizer(context_length: int = DEFAULT_CONTEXT_LENGTH) -> CLIPTokenizer:
    return CLIPTokenizer(context_length=context_length)
