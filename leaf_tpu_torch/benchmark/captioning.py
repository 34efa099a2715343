"""Captioning metrics (port of the scoring half of
`leaf_tpu/benchmark/captioning.py`): corpus BLEU-4 with the brevity
penalty and CIDEr-D, on token n-grams, in plain Python.

`evaluate_captioning` generates captions with a CoCa model, which is not
ported yet: it raises naming ROADMAP Queue 1 item 11.
"""
from __future__ import annotations

import math
import re
from collections import Counter, defaultdict
from typing import List, Sequence

import numpy as np

_WORD_RE = re.compile(r"\w+|[^\w\s]", re.UNICODE)


def _tok(s: str) -> List[str]:
    return _WORD_RE.findall(s.lower())


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def bleu4(candidates: Sequence[str], references: Sequence[Sequence[str]]
          ) -> float:
    """Corpus BLEU-4 with uniform weights and the brevity penalty."""
    log_precisions = []
    cand_toks = [_tok(c) for c in candidates]
    ref_toks = [[_tok(r) for r in refs] for refs in references]
    for n in range(1, 5):
        match, total = 0, 0
        for cand, refs in zip(cand_toks, ref_toks):
            cg = _ngrams(cand, n)
            max_ref: Counter = Counter()
            for r in refs:
                for g, c in _ngrams(r, n).items():
                    max_ref[g] = max(max_ref[g], c)
            match += sum(min(c, max_ref[g]) for g, c in cg.items())
            total += sum(cg.values())
        if total == 0 or match == 0:
            return 0.0
        log_precisions.append(math.log(match / total))
    c_len = sum(len(c) for c in cand_toks)
    # the reference length closest to each candidate's (shorter on ties)
    r_len = sum(min((abs(len(r) - len(c)), len(r)) for r in refs)[1]
                for c, refs in zip(cand_toks, ref_toks))
    bp = 1.0 if c_len > r_len else math.exp(1 - r_len / max(c_len, 1))
    return bp * math.exp(sum(log_precisions) / 4)


def cider_d(candidates: Sequence[str], references: Sequence[Sequence[str]],
            n_max: int = 4, sigma: float = 6.0) -> float:
    """CIDEr-D: TF-IDF-weighted n-gram cosine with the Gaussian length
    penalty and clipped candidate counts (Vedantam et al., 2015)."""
    cand_toks = [_tok(c) for c in candidates]
    ref_toks = [[_tok(r) for r in refs] for refs in references]
    n_imgs = len(cand_toks)

    # document frequency over the reference sets
    dfs = [defaultdict(float) for _ in range(n_max)]
    for refs in ref_toks:
        for n in range(n_max):
            seen = set()
            for r in refs:
                seen.update(_ngrams(r, n + 1).keys())
            for g in seen:
                dfs[n][g] += 1

    def tfidf_vec(tokens, n):
        vec, norm = {}, 0.0
        for g, c in _ngrams(tokens, n + 1).items():
            idf = math.log(max(n_imgs, 1.0)) - math.log(
                max(dfs[n].get(g, 0.0), 1.0))
            vec[g] = c * idf
            norm += vec[g] * vec[g]
        return vec, math.sqrt(norm)

    scores = []
    for cand, refs in zip(cand_toks, ref_toks):
        score_n = np.zeros(n_max)
        for n in range(n_max):
            cv, cn = tfidf_vec(cand, n)
            for r in refs:
                rv, rn = tfidf_vec(r, n)
                num = sum(min(cv[g], rv.get(g, 0.0)) * rv.get(g, 0.0)
                          for g in cv)
                delta = len(cand) - len(r)
                penalty = math.exp(-(delta ** 2) / (2 * sigma ** 2))
                if cn > 0 and rn > 0:
                    score_n[n] += penalty * num / (cn * rn)
            score_n[n] /= max(len(refs), 1)
        scores.append(10.0 * score_n.mean())
    return float(np.mean(scores)) if scores else 0.0


def evaluate_captioning(*args, **kwargs):
    raise NotImplementedError(
        "captioning generates with a CoCa model, which is not ported to "
        "leaf_tpu_torch yet: ROADMAP Queue 1 item 11")
