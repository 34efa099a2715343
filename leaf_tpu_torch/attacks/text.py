"""Character-level (Levenshtein-k) text attacks (port of
`leaf_tpu/attacks/text.py`).

The search structure (probe positions with a space substitution, then
try characters at the best positions) is the reference's; each round is
host string edits plus one fixed-shape device scoring call (see
`engine.CandidateScorer`).

Every attack has the JAX package's three paths, and `_grids_ok` (or
`_fused_ok`, unconstrained) decides between them:
  * the native fused grids: the C++ tokenizer applies each (slot,
    codepoint) edit and tokenizes in one pass (`_edit_tokens_fast`,
    `_fused_probe_grid`, `_fused_cand_grid`), so candidate strings are
    never made and only the winners are rebuilt as strings;
  * the constrained grids: the same, with the word constraint's native
    validity masks (`_constrain_grid`): an invalid candidate's tokens are
    replaced by the clean sentence's, as the string path's `filter` does;
  * the string path (`edits.apply_edit`, `edits.generate_all_sentences`,
    the constraint's `filter`, the tokenizer), for non-ASCII sentences, a
    vocabulary beyond single-byte ASCII, or no native library.
All three make the same decisions.  The attacks: `attack_text_leaf` (the
LEAF training attack; its constraint takes the string path), the
Charmer per sentence (`attack_text_charmer_inference`, with the
dual-encoder mode, and `attack_text_charmer_constrained_ret`) and
batched (`attack_text_charmer_batched`), `attack_text_bruteforce`, and
the Charmer classification attacks of the zero-shot text evals.  Beyond
the JAX package, the per-sentence Charmers run on the grids too, and a
candidate grid is only as wide as its widest sentence needs (`min(n,
slots) * |V|` columns, not `n * |V|`): the columns cut were masked.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from leaf_tpu_torch.attacks import edits
from leaf_tpu_torch.attacks.constraint import WordConstraint
from leaf_tpu_torch.attacks.engine import CandidateScorer
from leaf_tpu_torch.models.clip import TextTower, l2_normalize


def _normalize_np(a) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a))
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


def _grids_ok(native, constraint, sentences, vocab) -> bool:
    """The fused grids apply, a constrained search's too when the word
    constraint's validity masks are native (the Python validity fallback
    would recount the words of every candidate, slower than the string
    path it replaces)."""
    return _fused_ok(native, None, sentences, vocab) and (
        constraint is None or constraint._get_native() is not None)


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


def _clock(seconds: Optional[dict]):
    """A `timed(kind, fn, *args)` that adds fn's wall seconds to
    `seconds[kind]` (no-op bookkeeping when `seconds` is None)."""
    def timed(kind, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if seconds is not None:
            seconds[kind] = seconds.get(kind, 0.0) + time.perf_counter() - t0
        return out
    return timed


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
    timed = _clock(seconds)

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
    [B, R, ctx], mask, zs, cps) with R = max(min(n, slots)) * |V|.
    Candidate order is position-major, then vocabulary, that of
    `generate_all_sentences(S, vocab, subset_z=top)`; the winner b
    decodes as (z=zs[i, b], u=b % |V|)."""
    B = len(sentences)
    vcodes = np.asarray(vocab, np.int32)
    nv = len(vcodes)
    R = max(min(n, m) for m in n_slots) * nv
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


def attack_text_bruteforce(
    scorer: CandidateScorer,
    text: TextTower,
    tokenizer,
    sentence: str,
    anchor_features,
    objective: str = "l2",
    k: int = 1,
    vocab: Sequence[int] = edits.DEFAULT_VOCAB,
    constraint: Optional[WordConstraint] = None,
) -> Tuple[str, int]:
    """Exhaustive k=1 attack: score every ((k+1)L+k)*|V| single edit of
    one sentence and keep the best.  Returns (adversarial sentence, 1)."""
    if objective in ("sim", "dissim"):
        anchor_features = _normalize_np(anchor_features)

    native = _native_of(tokenizer)
    if _grids_ok(native, constraint, [sentence], vocab):
        ctx = getattr(tokenizer, "context_length", 77)
        nv = len(vocab)
        m = edits.num_slots(len(sentence))
        zs = np.repeat(np.arange(m, dtype=np.int32), nv)[None]
        cps = np.tile(np.asarray(vocab, np.int32), m)[None]
        tokens = native.encode_edits([sentence], zs, cps, ctx)
        tokenizer.count("native", m * nv)
        # the reshape is a view: invalid rows are replaced in `tokens`
        valid = _constrain_grid(constraint, [sentence],
                                tokens.reshape(1, m * nv, ctx),
                                np.ones((1, m * nv), bool), zs, cps,
                                native, ctx)
        loss = scorer.score_flat(text, tokens, anchor_features, objective)
        b = int(np.argmax(loss))
        if valid is not None and not valid[0, b]:
            return sentence, 1  # an invalid winner is the original
        return edits.apply_edit(sentence, int(zs[0, b]), b % nv,
                                vocab, 1, -1), 1

    candidates = edits.generate_all_sentences(sentence, vocab, alternative=-1)
    if constraint is not None:
        candidates = constraint.filter(sentence, candidates)
    loss = scorer.score_flat(text, tokenizer(candidates), anchor_features,
                             objective)
    return candidates[int(np.argmax(loss))], 1


def _charmer_sentence(tokenizer, sentence: str, score: Callable, n: int,
                      k: int, vocab: Sequence[int],
                      constraint: Optional[WordConstraint]
                      ) -> Tuple[str, int]:
    """The per-sentence Charmer search: per round, every space probe
    scored with `score(tokens, 1)`, the top-n slots kept, the whole
    vocabulary at them scored with `score(tokens, 2)` (each -> loss [N]
    numpy), the best kept.  On the grids when `_grids_ok`, else on
    strings; invalid candidates stand as the clean sentence either way."""
    native = _native_of(tokenizer)
    fast = _grids_ok(native, constraint, [sentence], vocab)
    ctx = getattr(tokenizer, "context_length", 77)
    nv = len(vocab)
    dist = 0
    for dist in range(k):
        if fast:
            tokens, pmask, n_slots, zs, cps = _fused_probe_grid(
                native, [sentence], ctx)
            tokenizer.count("native", pmask.size)
            _constrain_grid(constraint, [sentence], tokens, pmask, zs, cps,
                            native, ctx)
            loss = score(tokens[0], 1)
        else:
            probes = edits.generate_all_sentences(
                sentence, edits.SPACE_VOCAB, alternative=-1)
            if constraint is not None:
                probes = constraint.filter(sentence, probes)
            loss = score(tokenizer(probes), 1)
        top = np.argsort(-loss, kind="stable")[:min(n, len(loss))]

        if fast:
            tokens, cmask, zs2, cps2 = _fused_cand_grid(
                native, [sentence], top[None], n, vocab, n_slots, ctx)
            tokenizer.count("native", cmask.size)
            valid = _constrain_grid(constraint, [sentence], tokens, cmask,
                                    zs2, cps2, native, ctx)
            b = int(np.argmax(score(tokens[0], 2)))
            if valid is None or valid[0, b]:
                sentence = edits.apply_edit(sentence, int(zs2[0, b]), b % nv,
                                            vocab, 1, -1)
            continue
        candidates = edits.generate_all_sentences(
            sentence, vocab, subset_z=top.tolist(), alternative=-1)
        if constraint is not None:
            candidates = constraint.filter(sentence, candidates) or [sentence]
        sentence = candidates[int(np.argmax(score(tokenizer(candidates), 2)))]
    return sentence, dist + 1


def attack_text_charmer_inference(
    scorer: CandidateScorer,
    text: TextTower,
    tokenizer,
    sentence: str,
    anchor_features,
    objective: str = "l2",
    n: int = 10,
    k: int = 1,
    vocab: Sequence[int] = edits.DEFAULT_VOCAB,
    constraint: Optional[WordConstraint] = None,
    text2: Optional[TextTower] = None,
    anchor_features2=None,
    scorer2: Optional[CandidateScorer] = None,
) -> Tuple[str, int]:
    """Charmer attack (arXiv:2405.04346), one sentence: per round, score
    every space substitution, take the top-n positions, then try the
    whole vocabulary at them.  With a second encoder (`text2`,
    `anchor_features2`, and `scorer2` when its architecture differs) the
    two models' losses are averaged.  Returns (sentence, rounds run)."""
    if objective in ("sim", "dissim"):
        anchor_features = _normalize_np(anchor_features)
        if anchor_features2 is not None:
            anchor_features2 = _normalize_np(anchor_features2)

    def score(tokens, phase):
        return scorer.score_flat(text, tokens, anchor_features, objective,
                                 anchor2=anchor_features2, text2=text2,
                                 scorer2=scorer2)

    return _charmer_sentence(tokenizer, sentence, score, n, k, vocab,
                             constraint)


def attack_text_charmer_batched(
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
    seconds: Optional[dict] = None,
) -> List[str]:
    """Charmer over a batch of sentences: each sentence's search is that
    of `attack_text_charmer_inference`; the searches share device batches
    (probes padded to the longest sentence's slot count and masked).  All
    sentences run k rounds.

    Unconstrained, or constrained with native validity masks, ASCII
    sentences with a single-byte vocabulary go through the native grids,
    where only the winning edit is applied as a string.  `seconds`, if
    given, has its "host" entry raised by the wall seconds spent making
    candidates (grids or strings, masks, tokenizing) and its "device"
    entry by those of the scoring calls, each ending in a copy to the
    host.  Returns the adversarial sentences."""
    sentences = list(sentences)
    B = len(sentences)
    if objective in ("sim", "dissim"):
        anchor_features = _normalize_np(anchor_features)
    timed = _clock(seconds)

    def probe_top(tokens, mask):
        """Each sentence's n best probe slots."""
        _, _, loss = scorer.score_rows(text, tokens, anchor_features,
                                       objective, mask=mask)
        return np.argsort(-loss.cpu().numpy(), axis=1, kind="stable")[:, :n]

    native = _native_of(tokenizer)
    if _grids_ok(native, constraint, sentences, vocab):
        ctx = getattr(tokenizer, "context_length", 77)
        nv = len(vocab)

        def probe_grid():
            tokens, pmask, n_slots, zs, cps = _fused_probe_grid(
                native, sentences, ctx)
            tokenizer.count("native", pmask.size)
            _constrain_grid(constraint, sentences, tokens, pmask, zs, cps,
                            native, ctx)
            return tokens, pmask, n_slots

        def cand_grid(top, n_slots):
            tokens, cmask, zs2, cps2 = _fused_cand_grid(
                native, sentences, top, n, vocab, n_slots, ctx)
            tokenizer.count("native", cmask.size)
            valid = _constrain_grid(constraint, sentences, tokens, cmask,
                                    zs2, cps2, native, ctx)
            return tokens, cmask, zs2, valid

        for _ in range(k):
            tokens, pmask, n_slots = timed("host", probe_grid)
            top = timed("device", probe_top, tokens, pmask)
            tokens, cmask, zs2, cvalid = timed("host", cand_grid, top,
                                               n_slots)
            best_idx, _, _ = timed("device", scorer.score_rows, text, tokens,
                                   anchor_features, objective, mask=cmask)
            # only the winners become strings; an invalid winner IS the
            # original sentence (the string path's in-place replacement)
            sentences = [
                sentences[i] if cvalid is not None and not cvalid[i, b]
                else edits.apply_edit(sentences[i], int(zs2[i, b]),
                                      int(b) % nv, vocab, 1, -1)
                for i, b in enumerate(best_idx)]
        return sentences

    def rows_tokens(rows):
        if constraint is not None:
            rows = [c or [s] for c, s in
                    zip(constraint.filter_batched(sentences, rows),
                        sentences)]
        return (rows,) + _pad_rows(tokenizer, sentences, rows)

    for _ in range(k):
        # ---- phase 1: every space substitution, padded across sentences
        probe_rows, tokens, mask = timed("host", rows_tokens, [
            edits.generate_all_sentences(S, edits.SPACE_VOCAB,
                                         alternative=-1)
            for S in sentences])
        top = timed("device", probe_top, tokens, mask)

        # ---- phase 2: the whole vocabulary at the top-n positions
        cand_rows, tokens, mask = timed("host", rows_tokens, [
            edits.generate_all_sentences(
                S, vocab, subset_z=top[i][:min(n, len(probe_rows[i]))].tolist(),
                alternative=-1)
            for i, S in enumerate(sentences)])
        best_idx, _, _ = timed("device", scorer.score_rows, text, tokens,
                               anchor_features, objective, mask=mask)
        sentences = [cand_rows[i][best_idx[i]] for i in range(B)]
    return sentences


def attack_text_charmer_constrained_ret(
    scorer: CandidateScorer,
    text: TextTower,
    tokenizer,
    sentence: str,
    anchor_features=None,
    objective: str = "l2",
    n: int = 10,
    k: int = 1,
    vocab: Sequence[int] = edits.DEFAULT_VOCAB,
    constraint: Optional[WordConstraint] = None,
) -> Tuple[str, int]:
    """The retrieval variant of the per-sentence Charmer.  With
    `anchor_features` set, the objective is taken against that (target)
    caption; with None, the sentence is repelled from its own clean
    features (l2 -> negl2, dissim -> sim on the original features).

    Kept from the reference: phase 1 scores l2/negl2 on NORMALISED
    candidate features against the raw anchor, phase 2 on raw ones
    (the "_normfeat" objective of `engine.CandidateScorer`)."""
    if anchor_features is None:
        anchor = scorer.encode_text(text, tokenizer([sentence]))[0]
        obj = {"l2": "negl2", "dissim": "sim"}[objective]
    else:
        anchor, obj = anchor_features, objective
    if obj in ("sim", "dissim"):
        anchor = _normalize_np(anchor)
    p1_obj = obj + "_normfeat" if obj in ("l2", "negl2") else obj

    def score(tokens, phase):
        return scorer.score_flat(text, tokens, anchor,
                                 p1_obj if phase == 1 else obj)

    return _charmer_sentence(tokenizer, sentence, score, n, k, vocab,
                             constraint)


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
