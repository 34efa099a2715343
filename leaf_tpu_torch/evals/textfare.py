"""TextFARE evaluation: embedding drift under character attack (port of
`leaf_tpu/evals/textfare.py`):

    python -m leaf_tpu_torch.evals.textfare --model ViT-L-14 \\
        --pretrained <checkpoint> --dataset synthetic --attack_name charmer

For each sentence, attack the *eval model* (anchored on its own clean
features), then measure the squared-L2 drift of the clean and the
adversarial embeddings from a *clean reference model* (the original
non-robust CLIP).  Streaming CSV with columns sentence, adv_sentence,
textfare_clean, textfare_adv.  It runs on `--device` (default `cuda`).

Against the JAX package: `--pretrained` and `--clean-pretrained` take a
local OpenCLIP checkpoint (file or snapshot directory); a registry tag
raises.  Where neither is given both models are the same seeded init, so
the reference model is the eval model itself, not a second copy.  Drifts
are summed in fp32 whatever `--precision` (the JAX package sums bf16
features in bf16).
"""
from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from leaf_tpu_torch.attacks import edits
from leaf_tpu_torch.attacks.engine import CandidateScorer
from leaf_tpu_torch.attacks.text import (attack_text_bruteforce,
                                         attack_text_charmer_batched,
                                         attack_text_leaf)
from leaf_tpu_torch.models.clip import TextTower
from leaf_tpu_torch.utils.results import ResultsLedger

LOG = logging.getLogger(__name__)


def eval_textfare(
    scorer: CandidateScorer,
    eval_text: TextTower,
    clean_text: TextTower,
    tokenizer,
    samples: Sequence,
    attack_name: str = "leaf",
    rho: int = 50,
    k: int = 1,
    vocab: Optional[Sequence[int]] = None,
    constraint=None,
    n_test: Optional[int] = None,
    out_csv: Optional[str] = None,
    seed: int = 0,
    attack_batch: int = 32,
) -> Dict[str, float]:
    """Mean clean and adversarial TextFARE losses; rows stream to
    `out_csv` as each sentence is done.

    Sentences are attacked `attack_batch` at a time: the leaf attack is
    batch-parallel, charmer runs batched (each sentence's search that of
    the per-sentence attack), bruteforce per sentence (its candidate
    count is exhaustive and length-dependent)."""
    vocab = vocab or edits.DEFAULT_VOCAB
    ledger = ResultsLedger(out_csv, fresh=True, stream=True, columns=[
        "sentence", "adv_sentence", "textfare_clean", "textfare_adv",
    ]) if out_csv else None
    rng = np.random.default_rng(seed)

    all_samples = samples[:n_test] if n_test is not None else samples
    texts = [d["text"] if isinstance(d, dict) else d for d in all_samples]

    def host(feats) -> np.ndarray:
        return feats.float().cpu().numpy()

    clean_losses: List[float] = []
    adv_losses: List[float] = []
    for start in range(0, len(texts), attack_batch):
        chunk = texts[start:start + attack_batch]
        tokens = tokenizer(chunk)
        ref_feats = host(scorer.encode_text(clean_text, tokens))
        own_feats = scorer.encode_text(eval_text, tokens)

        if attack_name == "leaf":
            _, adv_chunk = attack_text_leaf(
                scorer, eval_text, tokenizer, chunk, own_feats,
                objective="l2", n=rho, k=k, vocab=vocab,
                constraint=constraint, rng=rng)
        elif attack_name == "charmer":
            adv_chunk = attack_text_charmer_batched(
                scorer, eval_text, tokenizer, chunk, own_feats,
                objective="l2", n=rho, k=k, vocab=vocab,
                constraint=constraint)
        elif attack_name == "bruteforce":
            adv_chunk = [attack_text_bruteforce(
                scorer, eval_text, tokenizer, sentence, anchor,
                objective="l2", vocab=vocab, constraint=constraint)[0]
                for sentence, anchor in zip(chunk, own_feats)]
        else:
            raise ValueError(f"unknown attack {attack_name!r}")

        adv_feats = host(scorer.encode_text(eval_text, tokenizer(adv_chunk)))
        own_np = host(own_feats)
        for j, sentence in enumerate(chunk):
            loss_clean = float(np.square(ref_feats[j] - own_np[j]).sum())
            loss_adv = float(np.square(ref_feats[j] - adv_feats[j]).sum())
            clean_losses.append(loss_clean)
            adv_losses.append(loss_adv)
            if ledger is not None:
                ledger.append({"sentence": sentence,
                               "adv_sentence": adv_chunk[j],
                               "textfare_clean": loss_clean,
                               "textfare_adv": loss_adv})

    return {
        "textfare_clean": float(np.mean(clean_losses)) if clean_losses else 0.0,
        "textfare_adv": float(np.mean(adv_losses)) if adv_losses else 0.0,
        "n": len(clean_losses),
    }


def _load_eval_samples(dataset: str, n_test: Optional[int]):
    """'synthetic', a JSON file of [{'text': ...}, ...] (or of strings),
    or a text-classification registry name (needs the `datasets`
    package) -> (samples, attack vocabulary or None)."""
    if dataset == "synthetic":
        rng = np.random.default_rng(0)
        words = ("stocks rally market team won cup government policy "
                 "tech chip ancient fossil film review great terrible").split()
        return [{"text": " ".join(rng.choice(words, size=8)), "label": 0}
                for _ in range(n_test or 16)], None
    if os.path.exists(dataset):
        with open(dataset) as f:
            data = json.load(f)
        return [{"text": d} if isinstance(d, str) else d for d in data], None
    from leaf_tpu_torch.data.textcls import get_text_classification_dataset
    data = get_text_classification_dataset(dataset, n_samples=n_test or 1000)
    # the reference attacks with the dataset's train-split character
    # vocabulary, not the generic ASCII set
    return data.samples, data.vocab


def main(argv=None) -> Dict[str, float]:
    """Command line: attack the eval model per sentence, measure clean
    and adversarial embedding drift from a clean reference model, stream
    the CSV."""
    import argparse

    from leaf_tpu_torch.attacks.constraint import WordConstraint
    from leaf_tpu_torch.models.factory import (create_model, get_tokenizer,
                                               local_checkpoint)

    p = argparse.ArgumentParser("leaf_tpu_torch TextFARE eval")
    p.add_argument("--model", default="ViT-L-14")
    p.add_argument("--pretrained", default=None,
                   help="eval checkpoint (a local file or directory)")
    p.add_argument("--clean-pretrained", default=None,
                   help="clean reference checkpoint; default = the "
                        "eval model's init (fresh weights if none)")
    p.add_argument("--dataset", default="agnews",
                   help="textcls name | JSON file | 'synthetic'")
    p.add_argument("--attack_name", default="leaf",
                   choices=["leaf", "charmer", "bruteforce"])
    p.add_argument("--rho", type=int, default=50)
    p.add_argument("--k", type=int, default=1)
    p.add_argument("--n_test", type=int, default=100)
    p.add_argument("--constrain", action="store_true")
    p.add_argument("--attack-batch", type=int, default=32)
    p.add_argument("--precision", default="fp32")
    p.add_argument("--output-dir", default="results_textfare")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    pretrained = local_checkpoint(args.pretrained, "--pretrained")
    clean_pre = local_checkpoint(args.clean_pretrained, "--clean-pretrained")
    model = create_model(args.model, pretrained, precision=args.precision,
                         device=args.device, master_weights=True)
    # the same source gives the same weights: one model serves as both
    clean = model if clean_pre == pretrained else create_model(
        args.model, clean_pre, precision=args.precision, device=args.device,
        master_weights=True)
    tokenizer = get_tokenizer(args.model)
    scorer = CandidateScorer(model.cfg, model.device)
    constraint = WordConstraint() if args.constrain else None

    samples, ds_vocab = _load_eval_samples(args.dataset, args.n_test)
    os.makedirs(args.output_dir, exist_ok=True)
    tag = args.model.split("/")[-1]
    out_csv = os.path.join(
        args.output_dir,
        f"{tag}_{os.path.basename(args.dataset)}_{args.attack_name}"
        f"_k{args.k}_rho_{args.rho}"
        + ("_constrained" if args.constrain else "") + ".csv")
    out = eval_textfare(
        scorer, model.module.text, clean.module.text, tokenizer, samples,
        attack_name=args.attack_name, rho=args.rho, k=args.k, vocab=ds_vocab,
        constraint=constraint, n_test=args.n_test, out_csv=out_csv,
        seed=args.seed, attack_batch=args.attack_batch)
    LOG.info("textfare %s: %s -> %s", args.attack_name, out, out_csv)
    print(out)
    return out


if __name__ == "__main__":
    main()
