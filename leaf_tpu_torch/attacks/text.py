"""Character-level (Levenshtein-k) text attacks (port of
`leaf_tpu/attacks/text.py`; the LEAF training attack so far).

The search structure (probe positions with a space substitution, then
try characters at the best position) is the reference's; each round is
host string edits plus one fixed-shape device scoring call (see
`engine.CandidateScorer`).

Ported: `attack_text_leaf`, on the native fused edit+tokenize grids
(`_edit_tokens_fast`: the C++ tokenizer applies each (slot, codepoint)
edit and tokenizes in one pass, so candidate strings are never made) and
on the string path (`edits.apply_edit` and the tokenizer; the word
constraint's `filter_batched` runs there); `_fused_ok` decides between
the two.  `_constrain_grid` applies the word constraint to such a grid;
its callers in the JAX package, the charmer and bruteforce attacks, are
not ported yet, nor are the classification attacks.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from leaf_tpu_torch.attacks import edits
from leaf_tpu_torch.attacks.constraint import WordConstraint
from leaf_tpu_torch.attacks.engine import CandidateScorer
from leaf_tpu_torch.models.clip import TextTower, l2_normalize


def _normalize_np(a) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.asarray(a))
    return l2_normalize(a.float())


def _native_of(tokenizer):
    """Native fused edit+tokenize handle of a tokenizer: None for a
    tokenizer without one, or when the Python path was asked for."""
    native = getattr(tokenizer, "native", None)
    return native() if callable(native) else None


def _pad_rows(tokenizer, sentences, rows):
    """Ragged per-sentence candidate rows -> ([B, n_max, C] tokens,
    [B, n_max] valid mask); short rows pad with the clean sentence."""
    n_max = max(len(r) for r in rows)
    mask = np.zeros((len(rows), n_max), bool)
    flat = []
    for i, row in enumerate(rows):
        mask[i, :len(row)] = True
        flat.extend(row + [sentences[i]] * (n_max - len(row)))
    return tokenizer(flat).reshape(len(rows), n_max, -1), mask


def _fused_ok(native, constraint, sentences, vocab) -> bool:
    """The C++ fused edit+tokenize path applies when unconstrained,
    native is built, every sentence is printable ASCII (same guard as
    `_edit_tokens_fast`), and every vocab codepoint is single-byte
    ASCII (the native ApplyEdit writes one char per edit; a bare
    inserted '&' is fine: html-unescape only rewrites full entity
    sequences, which the ASCII-'&'-free sentence guard covers)."""
    return (constraint is None and native is not None
            and all(s.isascii() and "&" not in s for s in sentences)
            and all(c == -1 or 0 < c < 128 for c in vocab))


def _constrain_grid(constraint, sentences, tokens, grid_mask, zs, cps,
                    native, ctx):
    """Apply the word-validity constraint to a fused (z, cp) grid the
    way the string path's `filter_batched` does: invalid candidates are
    REPLACED by the clean sentence (they score as the original, not
    -inf), preserving index<->slot correspondence.  Returns the validity
    array so the caller can freeze the winner when an invalid (== the
    original) candidate wins."""
    if constraint is None:
        return None
    valid = np.asarray(
        constraint.valid_edits_batch(sentences, zs, cps, alternative=-1),
        bool)
    clean = native.encode_batch(list(sentences), ctx)
    repl = ~valid & grid_mask
    if repl.any():
        i_idx, j_idx = np.nonzero(repl)
        tokens[i_idx, j_idx] = clean[i_idx]
    return valid


def _edit_tokens_fast(tokenizer, sentences, zs: np.ndarray, cps: np.ndarray):
    """[B] sentences + [B, rho] (slot, codepoint) edits -> [B, rho, C]
    tokens via the C++ fused path, or None when it does not apply (no
    native handle, or a sentence that is not ASCII or holds '&')."""
    native = _native_of(tokenizer)
    if native is None:
        return None
    if not all(s.isascii() and "&" not in s for s in sentences):
        return None
    ctx = getattr(tokenizer, "context_length", 77)
    B, rho = zs.shape
    tokenizer.count("native", B * rho)
    return native.encode_edits(list(sentences), zs, cps, ctx).reshape(
        B, rho, ctx)


def attack_text_leaf(
    scorer: CandidateScorer,
    text: TextTower,
    tokenizer,
    sentences: Sequence[str],
    anchor_features,
    objective: str = "l2",
    n: int = 10,
    k: int = 1,
    vocab: Sequence[int] = edits.DEFAULT_VOCAB,
    constraint: Optional[WordConstraint] = None,
    rng: Optional[np.random.Generator] = None,
    seconds: Optional[dict] = None,
) -> Tuple[np.ndarray, List[str]]:
    """LEAF training attack, batch-parallel over sentences.

    Per round: (1) probe rho=n random slots per sentence with a space
    substitution, scored in one [B, n] device call, keep the best slot;
    (2) try rho random vocabulary characters at that slot, scored in a
    second [B, n] call, keep the argmax-loss sentence.  The generator is
    drawn from in the JAX package's order: per round, every sentence's
    positions, then every sentence's characters.

    Unconstrained, with a single-byte-ASCII vocabulary and ASCII
    sentences, the candidates go through the native (slot, codepoint)
    grids and only the B winners are rebuilt as strings; otherwise
    through `edits.apply_edit`, the constraint's `filter_batched` (an
    invalid candidate is replaced by the clean sentence) and the
    tokenizer.

    `seconds`, if given, has its "host" entry raised by the wall seconds
    spent editing and tokenizing (either way) and its "device" entry by those
    spent in the scoring calls (each ends in a copy of the winners to the
    host, so it includes the wait for the device).

    Returns (adversarial features [B, D] float32 numpy, adversarial
    sentences).
    """
    rng = rng or np.random.default_rng()
    sentences = list(sentences)
    B = len(sentences)
    if objective in ("sim", "dissim"):
        anchor_features = _normalize_np(anchor_features)
    clock = {"host": 0.0, "device": 0.0}

    def timed(kind, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        clock[kind] += time.perf_counter() - t0
        return out

    native = _native_of(tokenizer)
    vocab_arr = np.asarray(vocab, np.int32)

    def string_tokens(rows):
        """Candidate strings -> [B, n, C] tokens, constraint applied."""
        if constraint is not None:
            rows = constraint.filter_batched(sentences, rows)
        flat = [s for row in rows for s in row]
        return rows, tokenizer(flat).reshape(B, n, -1)

    def probe_tokens(positions, fast):
        if fast:
            space = np.full((B, n), ord(" "), np.int32)
            return _edit_tokens_fast(tokenizer, sentences, positions, space)
        return string_tokens([
            [edits.apply_edit(S, int(z), 0, edits.SPACE_VOCAB, alternative=-1)
             for z in positions[i]]
            for i, S in enumerate(sentences)])[1]

    def cand_tokens(best_pos, us, fast):
        """(candidate strings or None on the fused path, tokens)."""
        if fast:
            zs = np.repeat(np.asarray(best_pos, np.int32)[:, None], n, axis=1)
            return None, _edit_tokens_fast(tokenizer, sentences, zs,
                                           vocab_arr[us])
        return string_tokens([
            [edits.apply_edit(S, best_pos[i], int(u), vocab, alternative=-1)
             for u in us[i]]
            for i, S in enumerate(sentences)])

    best_feats = None
    for _ in range(k):
        # a round's sentences are the last round's winners: decide anew
        fast = _fused_ok(native, constraint, sentences, vocab)
        # ---- phase 1: find the most vulnerable position per sentence
        positions = np.stack([edits.sample_positions(len(S), n, rng=rng)
                              for S in sentences])
        tokens = timed("host", probe_tokens, positions, fast)
        best_idx, _, _ = timed("device", scorer.score_rows, text, tokens,
                               anchor_features, objective)
        best_pos = [int(positions[i][best_idx[i]]) for i in range(B)]

        # ---- phase 2: try random characters at the winning position
        us = np.stack([rng.choice(len(vocab), size=n,
                                  replace=(n > len(vocab)))
                       for _ in range(B)])
        cand_rows, tokens = timed("host", cand_tokens, best_pos, us, fast)
        best_idx, best_feats, _ = timed("device", scorer.score_rows, text,
                                        tokens, anchor_features, objective)
        if cand_rows is None:
            sentences = [edits.apply_edit(S, best_pos[i],
                                          int(us[i][best_idx[i]]), vocab,
                                          alternative=-1)
                         for i, S in enumerate(sentences)]
        else:
            sentences = [cand_rows[i][best_idx[i]] for i in range(B)]

    if seconds is not None:
        for kind, value in clock.items():
            seconds[kind] = seconds.get(kind, 0.0) + value
    return best_feats.float().cpu().numpy(), sentences
