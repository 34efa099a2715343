"""PEZ inversion metrics: token and word accuracy, BLEU, the mean cosine
similarity (port of `leaf_tpu/evals/pez_metrics.py`).

Reads the `results-*.json` files that `leaf_tpu_torch.evals.pez_driver`
writes and reports how well the reconstructed prompts recover the
originals.  BLEU needs `sacrebleu`, imported where it is scored; without
it the metric is left out.

  python -m leaf_tpu_torch.evals.pez_metrics results_inversions/
"""
from __future__ import annotations

import argparse
import json
import logging
import os
from typing import List, Optional

from leaf_tpu_torch.utils.logging_utils import setup_logging

LOG = logging.getLogger(__name__)


def compute_token_accuracy(reconstructions_ids: List[List[int]],
                           references_ids: List[List[int]]) -> float:
    """Fraction of reference token ids present in the reconstruction
    (`compute_metrics.py:8-17`; SOT/EOT and pad stripped from the
    reference, pads from the reconstruction)."""
    n_correct = n_total = 0
    for rec, ref in zip(reconstructions_ids, references_ids):
        rec = [t for t in rec if t != 0]
        ref = [t for t in ref if t != 0][1:-1]   # strip SOT/EOT
        if not rec:
            continue
        n_correct += sum(t in rec for t in ref)
        n_total += len(rec)
    return n_correct / max(n_total, 1)


def compute_word_accuracy(reconstructions: List[str],
                          references: List[str]) -> float:
    """Fraction of reference words present in the reconstruction
    (`compute_metrics.py:19-27`)."""
    n_correct = n_total = 0
    for rec, ref in zip(reconstructions, references):
        rec_w = rec.lower().split()
        ref_w = ref.lower().split()
        if not rec_w:
            continue
        n_correct += sum(t in rec_w for t in ref_w)
        n_total += len(rec_w)
    return n_correct / max(n_total, 1)


def compute_bleu(reconstructions: List[str],
                 references: List[str]) -> Optional[float]:
    """Corpus BLEU of reconstructions vs originals
    (`compute_metrics.py:36,62-63`); None if sacrebleu is unavailable."""
    try:
        from sacrebleu.metrics import BLEU
    except ImportError:
        return None
    bleu = BLEU(references=[[r] for r in references])
    return float(bleu.corpus_score(reconstructions, references=None).score)


def evaluate_results(payload: dict) -> dict:
    res = payload["results"]
    if res and not all("original" in r for r in res):
        raise ValueError(
            "results have no reference captions (image-target inversion "
            "from `pez_driver --images`?) — token/word accuracy metrics "
            "are only defined for caption inversion; the cosine "
            "similarity is already in the results file")
    refs = [r["original"] for r in res]
    recs = [r["reconstructed"] for r in res]
    sims = [r.get("cosine_sim", r.get("sim", 0.0)) for r in res]
    metrics = {
        "n": len(res),
        "mean_cosine_sim": sum(sims) / max(len(sims), 1),
        "word_accuracy": compute_word_accuracy(recs, refs),
    }
    if all("ids_rec" in r and "ids_orig" in r for r in res):
        metrics["token_accuracy"] = compute_token_accuracy(
            [r["ids_rec"] for r in res], [r["ids_orig"] for r in res])
    bleu = compute_bleu(recs, refs)
    if bleu is not None:
        metrics["bleu"] = bleu
    return metrics


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser("leaf_tpu_torch PEZ inversion metrics")
    p.add_argument("results", help="a results-*.json file or a directory "
                                   "of them")
    args = p.parse_args(argv)
    setup_logging()

    paths = [args.results]
    if os.path.isdir(args.results):
        paths = sorted(
            os.path.join(args.results, f) for f in os.listdir(args.results)
            if f.startswith("results-") and f.endswith(".json"))
    out = {}
    for path in paths:
        with open(path) as f:
            payload = json.load(f)
        metrics = evaluate_results(payload)
        out[os.path.basename(path)] = metrics
        LOG.info("%s: %s", os.path.basename(path),
                 {k: round(v, 4) if isinstance(v, float) else v
                  for k, v in metrics.items()})
    print(json.dumps(out, indent=2, default=float))
    return out


if __name__ == "__main__":
    main()
