"""Levenshtein-k sentence edit machinery (host-side, pure functions; a
copy of `leaf_tpu/attacks/edits.py`, which is numpy only).

The interleaved-slot encoding of the LEAF reference: a sentence of length L is
expanded to a slot string with k insertion slots before every character
and k trailing slots — (k+1)·L + k editable positions.  Writing a
character into an empty slot is an *insertion*; overwriting a character
position is a *substitution*; writing the delete id (-1), or writing a
character equal to the one already there when `alternative == -1`, is a
*deletion*.  One (position, char-id) pair therefore encodes any single
Levenshtein edit.

These functions are deliberately tiny and pure: they are the part of
the attack that stays on the host (Python strings).  Every draw from the
generator happens in the JAX package's order, so one seed gives both
packages the same candidates (`tests/test_torch_attack.py`).  Everything
downstream operates on fixed-shape token buffers on the device.
"""
from __future__ import annotations

import string
from typing import List, Optional, Sequence

import numpy as np

# Attack vocabulary: delete (-1) + lowercase + space + uppercase + digits +
# punctuation: 96 ids.
DEFAULT_VOCAB: List[int] = (
    [-1] + [ord(c) for c in string.ascii_lowercase + " "
            + string.ascii_uppercase + string.digits + string.punctuation])

SPACE_VOCAB: List[int] = [ord(" ")]   # probe vocab for position scoring


def num_slots(sentence_len: int, k: int = 1) -> int:
    """Number of editable positions: (k+1)·L + k."""
    return (k + 1) * sentence_len + k


def expand_slots(sentence: str, k: int = 1):
    """Return (slot_chars, is_char) — the expanded slot string and a mask
    marking real characters (True) vs empty insertion slots (False)."""
    chars: List[str] = []
    is_char: List[bool] = []
    for ch in sentence:
        chars.extend("_" * k)
        is_char.extend([False] * k)
        chars.append(ch)
        is_char.append(True)
    chars.extend("_" * k)
    is_char.extend([False] * k)
    return chars, is_char


def apply_edit(sentence: str, z: int, u: int, vocab: Sequence[int] = DEFAULT_VOCAB,
               k: int = 1, alternative: Optional[int] = None) -> str:
    """Apply the single edit (slot z ← vocab[u]) and collapse slots.

    `alternative` handles the degenerate self-substitution case: when the
    written character equals the one already at z, write `alternative`
    instead (or delete, if alternative == -1).  The reference uses
    alternative=-1 throughout, making self-substitution a deletion.
    """
    chars, mask = expand_slots(sentence, k)
    code = vocab[u]
    if code != -1:
        ch = chr(code)
        if chars[z] == ch and alternative is not None:
            if alternative == -1:
                mask[z] = False
            else:
                chars[z] = chr(alternative)
                mask[z] = True
        else:
            chars[z] = ch
            mask[z] = True
    else:
        mask[z] = False
    return "".join(c for c, m in zip(chars, mask) if m)


def generate_all_sentences_at_z(sentence: str, z: int,
                                vocab: Sequence[int] = DEFAULT_VOCAB,
                                k: int = 1, alternative: Optional[int] = -1) -> List[str]:
    """All |V| single-edit variants at slot z.

    Equivalent to `[apply_edit(sentence, z, u, ...) for u in
    range(len(vocab))]` but hoists the slot expansion out of the vocab
    loop: for a fixed (sentence, z) the collapsed prefix/suffix strings
    are constant, so each variant is a single O(L) concat instead of a
    Python-level slot rebuild.
    NB `existing` is the raw slot char including the '_' placeholder of
    empty insertion slots — writing '_' into an empty slot must take
    the self-substitution branch, as in apply_edit."""
    chars, mask = expand_slots(sentence, k)
    existing = chars[z]
    prefix = "".join(c for c, m in zip(chars[:z], mask[:z]) if m)
    suffix = "".join(c for c, m in zip(chars[z + 1:], mask[z + 1:]) if m)
    removed = prefix + suffix
    out: List[str] = []
    for code in vocab:
        if code == -1:
            out.append(removed)
            continue
        ch = chr(code)
        if ch == existing and alternative is not None:
            out.append(removed if alternative == -1
                       else prefix + chr(alternative) + suffix)
        else:
            out.append(prefix + ch + suffix)
    return out


def generate_all_sentences(sentence: str,
                           vocab: Sequence[int] = DEFAULT_VOCAB,
                           subset_z: Optional[Sequence[int]] = None,
                           k: int = 1, alternative: Optional[int] = None) -> List[str]:
    """All single-edit variants over `subset_z` (default: every slot),
    ordered position-major then vocab.  Duplicates are kept:
    determinism over minimality, as in the reference."""
    if subset_z is None:
        subset_z = range(num_slots(len(sentence), k))
    out: List[str] = []
    for z in subset_z:
        out.extend(generate_all_sentences_at_z(sentence, z, vocab, k, alternative))
    return out


def generate_random_sentences_at_z(sentence: str, z: int,
                                   vocab: Sequence[int],
                                   n: int, k: int = 1,
                                   alternative: Optional[int] = -1,
                                   rng: Optional[np.random.Generator] = None) -> List[str]:
    """n random-vocab single edits at fixed slot z; sampled without
    replacement when n ≤ |V|."""
    rng = rng or np.random.default_rng()
    us = rng.choice(len(vocab), size=n, replace=(n > len(vocab)))
    return [apply_edit(sentence, z, int(u), vocab, k, alternative) for u in us]


def generate_random_sentences(sentence: str, vocab: Sequence[int], n: int,
                              subset_z: Optional[Sequence[int]] = None,
                              k: int = 1, alternative: Optional[int] = None,
                              insert: bool = True,
                              rng: Optional[np.random.Generator] = None) -> List[str]:
    """n random sentences at Levenshtein distance ≤ k: k successive
    random single edits."""
    rng = rng or np.random.default_rng()
    out = [sentence] * n
    for _ in range(k):
        if k == 1:
            zs = subset_z
            if not insert:
                zs = [i for i in range(num_slots(len(sentence))) if i % 2]
            if zs is None:
                zs = range(num_slots(len(sentence)))
            positions = rng.choice(list(zs), size=n)
        else:
            positions = []
            for s in out:
                if insert:
                    positions.append(rng.integers(num_slots(len(s))))
                else:
                    positions.append(
                        rng.choice([i for i in range(num_slots(len(s))) if i % 2]))
        us = rng.choice(len(vocab), size=n)
        out = [apply_edit(s, int(z), int(u), vocab, 1, alternative)
               for s, z, u in zip(out, positions, us)]
    return out


def sample_positions(sentence_len: int, n: int, k: int = 1,
                     rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Sample n candidate slots (without replacement when possible),
    the training attack's position sampling."""
    rng = rng or np.random.default_rng()
    total = num_slots(sentence_len, k)
    return rng.choice(total, size=n, replace=(n > total))
