"""Where the batched Charmer's time goes (port of
`tools/profile_charmer.py`).

Usage, from the root of a checkout:
  python -m leaf_tpu_torch.profile_charmer [--model ViT-L-14-quickgelu]
      [--batch 16] [--words 10] [--n 20] [--k 1] [--reps 3]
      [--precision bf16] [--device cuda] [--out profile_charmer.json]

`attack_text_charmer_batched` shares device batches across sentences
where the per-sentence attack (`attack_text_charmer_inference`) scores
one sentence at a time.  This measures both end to end (ms per sentence,
median of `--reps`, after two warm-up runs of each) on seeded sentences
of `--words` words with the "sim" objective against the sentences' own
clean features, then splits one round of the batched attack into its
steps: on the string path, host edit generation, tokenizing and padding,
phase-1 (probe) scoring and phase-2 (candidate) scoring; on the native
grids (the default path), the grid encodes and the two scoring calls.
Each step ends in a copy to the host, so device steps include the wait
for the device.  Prints one JSON line with the device's name (and the
card's power limit) beside the numbers; `--device cpu` runs the same
code on the CPU's plain kernel versions, and its times are CPU times.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

WORDS = ("market stocks rally government policy team cup season tech chip "
         "quarterly earnings ancient fossil researchers film festival review "
         "study climate report city council launch satellite orbit trade "
         "deal talks").split()


def profile_charmer(model_name: str, batch: int, words: int, n: int, k: int,
                    reps: int, precision: str, device: str) -> dict:
    from leaf_tpu_torch.attacks import edits
    from leaf_tpu_torch.attacks import text as attacks
    from leaf_tpu_torch.attacks.engine import CandidateScorer
    from leaf_tpu_torch.models.factory import create_model, get_tokenizer

    model = create_model(model_name, precision=precision, seed=0,
                         device=device, master_weights=True)
    text = model.module.text
    tokenizer = get_tokenizer(model_name)
    scorer = CandidateScorer(model.cfg, device)
    rng = np.random.default_rng(0)
    sentences = [" ".join(rng.choice(WORDS, size=words)) for _ in range(batch)]
    anchors = scorer.encode_text(text, tokenizer(sentences), normalize=True)

    def ms_per_sentence(fn) -> tuple:
        """(median ms per sentence over `reps` runs, the last output)."""
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t0) * 1e3 / batch)
        return float(np.median(times)), out

    def sequential():
        return [attacks.attack_text_charmer_inference(
            scorer, text, tokenizer, s, anchors[i], "sim", n=n, k=k)[0]
            for i, s in enumerate(sentences)]

    def batched():
        return attacks.attack_text_charmer_batched(
            scorer, text, tokenizer, sentences, anchors, "sim", n=n, k=k)

    for _ in range(2):
        sequential()
        batched()
    seq_ms, seq_out = ms_per_sentence(sequential)
    bat_ms, bat_out = ms_per_sentence(batched)

    def losses(tokens, mask) -> np.ndarray:
        return scorer.score_rows(text, tokens, anchors, "sim",
                                 mask=mask)[2].cpu().numpy()

    # ---- one round of the string path, step by step
    string = {}

    def step(key, fn):
        string[key], out = ms_per_sentence(fn)
        return out

    probe_rows = step("host_probe_gen_ms", lambda: [
        edits.generate_all_sentences(S, edits.SPACE_VOCAB, alternative=-1)
        for S in sentences])
    tokens, mask = step("probe_tokenize_pad_ms", lambda: attacks._pad_rows(
        tokenizer, sentences, probe_rows))
    n_probes = tokens.shape[1]
    loss = step("phase1_score_ms", lambda: losses(tokens, mask))
    top = np.argsort(-loss, axis=1, kind="stable")[:, :n]
    cand_rows = step("host_cand_gen_ms", lambda: [
        edits.generate_all_sentences(
            S, edits.DEFAULT_VOCAB,
            subset_z=top[i][:min(n, len(probe_rows[i]))].tolist(),
            alternative=-1)
        for i, S in enumerate(sentences)])
    ctokens, cmask = step("cand_tokenize_pad_ms", lambda: attacks._pad_rows(
        tokenizer, sentences, cand_rows))
    n_cands = ctokens.shape[1]
    step("phase2_score_ms", lambda: losses(ctokens, cmask))

    # ---- one round of the native grids, step by step
    fused = {}
    native = attacks._native_of(tokenizer)
    if native is not None:
        ctx = tokenizer.context_length

        def fstep(key, fn):
            fused[key], out = ms_per_sentence(fn)
            return out

        ftokens, fmask, n_slots, _, _ = fstep(
            "p1_grid_encode_ms",
            lambda: attacks._fused_probe_grid(native, sentences, ctx))
        floss = fstep("p1_score_ms", lambda: losses(ftokens, fmask))
        ftop = np.argsort(-floss, axis=1, kind="stable")[:, :n]
        ctok2, cmask2, _, _ = fstep(
            "p2_grid_encode_ms", lambda: attacks._fused_cand_grid(
                native, sentences, ftop, n, edits.DEFAULT_VOCAB, n_slots, ctx))
        fstep("p2_score_ms", lambda: losses(ctok2, cmask2))

    return {
        "model": model_name, "precision": precision, "batch": batch, "n": n,
        "k": k, "mean_chars": float(np.mean([len(s) for s in sentences])),
        "probes_per_sentence": int(n_probes),
        "cands_per_sentence": int(n_cands),
        "sequential_ms_per_sentence": seq_ms,
        "batched_ms_per_sentence": bat_ms,
        "speedup": seq_ms / bat_ms,
        # equal in fp32; in bf16 a near-tie may fall the other way, since
        # the two pack their candidates into other rows
        "same_sentences": seq_out == bat_out,
        "phases_string_path": string,
        "phase_sum_ms": sum(string.values()),
        "phases_fused_path": fused,
        "fused_phase_sum_ms": sum(fused.values()),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="ViT-L-14-quickgelu")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--words", type=int, default=10,
                    help="caption length in words (AG-News sentences are "
                         "longer; sweep this for the length ladder)")
    ap.add_argument("--n", type=int, default=20)
    ap.add_argument("--k", type=int, default=1)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--precision", default="bf16")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write the JSON here too")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            raise SystemExit("profile_charmer: CUDA is not available")
        from leaf_tpu_torch.profile_serve import card
        where = {"device": torch.cuda.get_device_name(0), "card": card()}
    else:
        where = {"device": args.device}
    result = {**where, "torch": torch.__version__, **profile_charmer(
        args.model, args.batch, args.words, args.n, args.k, args.reps,
        args.precision, args.device)}
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    return result


if __name__ == "__main__":
    main()
