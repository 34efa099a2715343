"""Character-level (Levenshtein-k) text attacks (port of
`leaf_tpu/attacks/text.py`; the LEAF training attack so far).

The search structure (probe positions with a space substitution, then
try characters at the best position) is the reference's; each round is
host string edits plus one fixed-shape device scoring call (see
`engine.CandidateScorer`).

Ported: `attack_text_leaf` on the string path (`edits.apply_edit` and the
tokenizer).  Not ported yet: the native fused edit+tokenize grids
(`_edit_tokens_fast` in the JAX package), the word constraint, and the
charmer, bruteforce and classification attacks.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from leaf_tpu_torch.attacks import edits
from leaf_tpu_torch.attacks.engine import CandidateScorer
from leaf_tpu_torch.models.clip import TextTower, l2_normalize


def _normalize_np(a) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.asarray(a))
    return l2_normalize(a.float())


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
    constraint=None,
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

    `seconds`, if given, has its "host" entry raised by the wall seconds
    spent editing and tokenizing strings and its "device" entry by those
    spent in the scoring calls (each ends in a copy of the winners to the
    host, so it includes the wait for the device).

    Returns (adversarial features [B, D] float32 numpy, adversarial
    sentences).
    """
    if constraint is not None:
        raise NotImplementedError(
            "the word constraint (attacks/constraint.py) is not ported yet: "
            "ROADMAP 'Next, in order' item 1")
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

    def tokenize_rows(rows):
        flat = [s for row in rows for s in row]
        return tokenizer(flat).reshape(B, n, -1)

    best_feats = None
    for _ in range(k):
        # ---- phase 1: find the most vulnerable position per sentence
        positions = np.stack([edits.sample_positions(len(S), n, rng=rng)
                              for S in sentences])
        tokens = timed("host", lambda: tokenize_rows([
            [edits.apply_edit(S, int(z), 0, edits.SPACE_VOCAB, alternative=-1)
             for z in positions[i]]
            for i, S in enumerate(sentences)]))
        best_idx, _, _ = timed("device", scorer.score_rows, text, tokens,
                               anchor_features, objective)
        best_pos = [int(positions[i][best_idx[i]]) for i in range(B)]

        # ---- phase 2: try random characters at the winning position
        us = np.stack([rng.choice(len(vocab), size=n,
                                  replace=(n > len(vocab)))
                       for _ in range(B)])
        cand_rows = timed("host", lambda: [
            [edits.apply_edit(S, best_pos[i], int(u), vocab, alternative=-1)
             for u in us[i]]
            for i, S in enumerate(sentences)])
        tokens = timed("host", tokenize_rows, cand_rows)
        best_idx, best_feats, _ = timed("device", scorer.score_rows, text,
                                        tokens, anchor_features, objective)
        sentences = [cand_rows[i][best_idx[i]] for i in range(B)]

    if seconds is not None:
        for kind, value in clock.items():
            seconds[kind] = seconds.get(kind, 0.0) + value
    return best_feats.float().cpu().numpy(), sentences
