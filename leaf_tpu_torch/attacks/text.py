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
the two.  The Charmer classification attack of the zero-shot text eval,
per sentence and batched (`_fused_probe_grid` / `_fused_cand_grid` for
the grids).  `_constrain_grid` applies the word constraint to a grid;
its callers in the JAX package, the retrieval charmer and bruteforce
attacks, are not ported yet (ROADMAP Queue 1 item 8).
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


def _fused_probe_grid(native, sentences, ctx):
    """Space probes at every slot, as (z, cp) grids through the fused
    tokenizer: returns (tokens [B, P, ctx], mask [B, P], n_slots, zs,
    cps).  Probe index == slot index, the order of the string path's
    `generate_all_sentences(S, SPACE_VOCAB)`."""
    B = len(sentences)
    n_slots = [edits.num_slots(len(S)) for S in sentences]
    P = max(n_slots)
    zs = np.zeros((B, P), np.int32)
    cps = np.full((B, P), -1, np.int32)  # pad = no-op delete at slot 0
    mask = np.zeros((B, P), bool)
    for i, m in enumerate(n_slots):
        zs[i, :m] = np.arange(m)
        cps[i, :m] = ord(" ")
        mask[i, :m] = True
    tokens = native.encode_edits(sentences, zs, cps, ctx).reshape(B, P, ctx)
    return tokens, mask, n_slots, zs, cps


def _fused_cand_grid(native, sentences, top, n, vocab, n_slots, ctx):
    """Full-vocabulary candidates at the top-n slots: returns (tokens
    [B, n*|V|, ctx], mask, zs, cps).  Candidate order is position-major,
    then vocabulary, that of `generate_all_sentences(S, vocab,
    subset_z=top)`; the winner b decodes as (z=zs[i, b], u=b % |V|)."""
    B = len(sentences)
    vcodes = np.asarray(vocab, np.int32)
    nv = len(vcodes)
    R = n * nv
    zs = np.zeros((B, R), np.int32)
    cps = np.full((B, R), -1, np.int32)
    mask = np.zeros((B, R), bool)
    for i, m in enumerate(n_slots):
        vn = min(n, m)
        zs[i, :vn * nv] = np.repeat(top[i, :vn], nv)
        cps[i, :vn * nv] = np.tile(vcodes, vn)
        mask[i, :vn * nv] = True
    tokens = native.encode_edits(sentences, zs, cps, ctx).reshape(B, R, ctx)
    return tokens, mask, zs, cps


def attack_text_charmer_classification(
    scorer: CandidateScorer,
    text: TextTower,
    tokenizer,
    sentence: str,
    class_features,
    label: int,
    n: int = 10,
    k: int = 1,
    vocab: Sequence[int] = edits.DEFAULT_VOCAB,
) -> Tuple[str, int]:
    """Charmer with the margin loss over class-anchor similarities, one
    sentence; stops once the prediction flips.  Returns (adversarial
    sentence, rounds run)."""
    class_features = _normalize_np(class_features)
    dist = 0
    for dist in range(k):
        probes = edits.generate_all_sentences(
            sentence, edits.SPACE_VOCAB, alternative=-1)
        loss, _ = scorer.score_classification(
            text, tokenizer(probes), class_features, label)
        top = np.argsort(-loss, kind="stable")[:min(n, len(loss))]

        candidates = edits.generate_all_sentences(
            sentence, vocab, subset_z=top.tolist(), alternative=-1)
        loss, preds = scorer.score_classification(
            text, tokenizer(candidates), class_features, label)
        best = int(np.argmax(loss))
        sentence = candidates[best]
        if preds[best] != label:
            break
    return sentence, dist + 1


def attack_text_charmer_classification_batched(
    scorer: CandidateScorer,
    text: TextTower,
    tokenizer,
    sentences: Sequence[str],
    class_features,
    labels: Sequence[int],
    n: int = 10,
    k: int = 1,
    vocab: Sequence[int] = edits.DEFAULT_VOCAB,
) -> List[str]:
    """Charmer classification attack over a batch: each sentence's search
    is that of `attack_text_charmer_classification`, the early exit
    included (a sentence whose prediction has flipped is frozen for the
    remaining rounds); probes and candidates share device batches.
    ASCII batches with a single-byte vocabulary run on the native (slot,
    codepoint) grids, where no candidate string is made; the others on
    the string path, with the same decisions."""
    sentences = list(sentences)
    B = len(sentences)
    class_features = _normalize_np(class_features)
    labels = np.asarray(labels)
    done = np.zeros(B, bool)

    native = _native_of(tokenizer)
    if _fused_ok(native, None, sentences, vocab):
        ctx = getattr(tokenizer, "context_length", 77)
        nv = len(vocab)
        for _ in range(k):
            if done.all():
                break
            tokens, pmask, n_slots, _, _ = _fused_probe_grid(
                native, sentences, ctx)
            tokenizer.count("native", pmask.size)
            loss, _ = scorer.score_classification_rows(
                text, tokens, class_features, labels, pmask)
            top = np.argsort(-loss, axis=1, kind="stable")
            tokens, cmask, zs2, _ = _fused_cand_grid(
                native, sentences, top, n, vocab, n_slots, ctx)
            tokenizer.count("native", cmask.size)
            loss, preds = scorer.score_classification_rows(
                text, tokens, class_features, labels, cmask)
            best = np.argmax(loss, axis=1)
            for i in range(B):
                if done[i]:
                    continue      # frozen after an earlier flip
                b = int(best[i])
                sentences[i] = edits.apply_edit(
                    sentences[i], int(zs2[i, b]), b % nv, vocab, 1, -1)
                if preds[i, b] != labels[i]:
                    done[i] = True
        return sentences

    for _ in range(k):
        if done.all():
            break
        # ---- phase 1: margin loss over every space probe, padded
        probe_rows = [edits.generate_all_sentences(S, edits.SPACE_VOCAB,
                                                   alternative=-1)
                      for S in sentences]
        tokens, mask = _pad_rows(tokenizer, sentences, probe_rows)
        loss, _ = scorer.score_classification_rows(
            text, tokens, class_features, labels, mask)
        top = np.argsort(-loss, axis=1, kind="stable")

        # ---- phase 2: the whole vocabulary at the top-n positions
        cand_rows = [
            edits.generate_all_sentences(
                S, vocab,
                subset_z=top[i][:min(n, len(probe_rows[i]))].tolist(),
                alternative=-1)
            for i, S in enumerate(sentences)
        ]
        tokens, mask = _pad_rows(tokenizer, sentences, cand_rows)
        loss, preds = scorer.score_classification_rows(
            text, tokens, class_features, labels, mask)
        best = np.argmax(loss, axis=1)
        for i in range(B):
            if done[i]:
                continue          # frozen after an earlier flip
            sentences[i] = cand_rows[i][best[i]]
            if preds[i, best[i]] != labels[i]:
                done[i] = True
    return sentences
