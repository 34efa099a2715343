"""Fused attack+train step for the LEAF training attack (port of
`leaf_tpu/train/fused.py`).

The released LEAF models all train with k_adv=1.  For that case a step
is two phases on the device with one hard host sync between them (k>1
runs the same two phases per edit round, with the train update fused
into the last round):

  phase 1: frozen-tower anchor encode + probe scoring -> best probe
    index per sentence (the only value the host must read: it places the
    phase-2 edits at the winning slots);
  phase 2: candidate scoring -> winner selection on the device
    (`argmax`, `gather` on the candidate token buffer) -> TextFARE loss,
    backward and the AdamW update.

The adversarial *strings* never return to the host: the winning tokens
feed the train forward on the device.  Selection semantics are those of
`attack_text_leaf` (same probe and candidate generation, same argmax);
`tests/test_torch_fused.py` pins the equivalence against the unfused
path and against the JAX package's fused step.

Against the JAX module: a phase body is a plain function on the port's
`TextTower` (no jit, no `cfg`/`tx`/`dtype` arguments: the tower knows its
config and compute dtype, the `TrainState` holds the optimizer), scoring
runs under `torch.no_grad()`, and the state is updated in place.  The
mesh, `shard_map` and multi-host parts are not carried over; they belong
to the multi-GPU slice.  Everything is enqueued on the current CUDA
stream, so a train step, its in-place AdamW update and the next step's
phase 1 keep a single stream's order; only the best-probe readback uses
a second stream (`_Readback`).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from leaf_tpu_torch.attacks import edits
from leaf_tpu_torch.attacks.engine import (bucket_tokens,
                                           can_bucket as engine_can_bucket,
                                           objective_loss)
from leaf_tpu_torch.attacks.text import _edit_tokens_fast
from leaf_tpu_torch.data.common import put_batch
from leaf_tpu_torch.models.clip import TextTower, l2_normalize
from leaf_tpu_torch.models.config import CLIPConfig
from leaf_tpu_torch.train.step import TrainState


def _scoring_anchors(anchors: torch.Tensor, objective: str) -> torch.Tensor:
    """Match attack_text_leaf's anchor handling: sim/dissim normalise
    the anchors before scoring."""
    if objective in ("sim", "dissim"):
        return l2_normalize(anchors.float())
    return anchors.float()


def _score(text: TextTower, tokens: torch.Tensor, anchors: torch.Tensor,
           objective: str) -> torch.Tensor:
    """tokens [B, N, C], anchors [B, D] -> argmax-loss index [B] (the
    first of equal losses, as `jnp.argmax`)."""
    B, N, C = tokens.shape
    feats = text.encode_text(tokens.reshape(B * N, C),
                             objective in ("sim", "dissim"))
    loss = objective_loss(feats.reshape(B, N, -1).float(),
                          _scoring_anchors(anchors, objective), objective)
    return loss.argmax(dim=-1)


def _take_rows(tokens: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """tokens [B, N, C], best [B] -> tokens[i, best[i]] as [B, C]."""
    index = best[:, None, None].expand(-1, 1, tokens.shape[-1])
    return tokens.gather(1, index)[:, 0]


def _marker(device: torch.device):
    """An event recorded on the current stream (None on the CPU, where
    the work before this point is already done): the end of the attack's
    device work, for `utils.results.AsyncAttackTimer`."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record()
    return event


def make_fused_phase1(normalize: bool = False, objective: str = "l2"):
    """(frozen_text, train_text, clean_tokens [B,C], probe_tokens
    [B,N,C]) -> (anchors [B,D], best_probe [B])."""

    @torch.no_grad()
    def body(frozen_text: TextTower, train_text: TextTower,
             clean_tokens: torch.Tensor, probe_tokens: torch.Tensor):
        anchors = frozen_text.encode_text(clean_tokens, normalize)
        return anchors, _score(train_text, probe_tokens, anchors, objective)

    return body


def make_fused_phase1_cached(objective: str = "l2"):
    """(train_text, probe_tokens [B,N,C], anchors [B,D]) -> best [B]:
    probe scoring against *precomputed* anchors (the anchor-feature
    cache path: the frozen tower never changes, so after the first epoch
    over a dataset every clean caption's anchor is known)."""

    @torch.no_grad()
    def body(train_text: TextTower, probe_tokens: torch.Tensor,
             anchors: torch.Tensor):
        return _score(train_text, probe_tokens, anchors, objective)

    return body


def _update(state: TrainState, loss: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Backward, one optimizer update, the step count; metrics stay on
    the device (reading one waits for it)."""
    loss.backward()
    grad_norm = state.optimizer.update(state.step)
    state.step += 1
    return {"loss": loss.detach(), "grad_norm": grad_norm}


def make_fused_phase2_step(normalize: bool = False, remat: bool = False,
                           objective: str = "l2", w_fare_text: float = 1.0):
    """(state, cand_tokens [B,N,C], anchors [B,D]) ->
    (state, best_idx [B], metrics, attack marker).  The marker is
    recorded between the winners' selection and the train forward."""

    def step_fn(state: TrainState, cand_tokens: torch.Tensor,
                anchors: torch.Tensor):
        with torch.no_grad():
            best = _score(state.text, cand_tokens, anchors, objective)
            adv_tokens = _take_rows(cand_tokens, best)
        marker = _marker(cand_tokens.device)
        adv_feats = state.text.encode_text(adv_tokens, normalize, remat=remat)
        diff = anchors.float() - adv_feats.float()
        loss = w_fare_text * diff.square().sum(dim=-1).mean()
        return state, best, _update(state, loss), marker

    return step_fn


def make_fused_phase2_score(objective: str = "l2"):
    """(train_text, cand_tokens [b,N,C], anchors [b,D]) ->
    (best [b], adv_tokens [b,C]): the scoring half of phase 2, used by
    the pipelined step (the update is deferred to `make_fused_train_only`
    so the two half-batches can share one optimizer step)."""

    @torch.no_grad()
    def body(train_text: TextTower, cand_tokens: torch.Tensor,
             anchors: torch.Tensor):
        best = _score(train_text, cand_tokens, anchors, objective)
        return best, _take_rows(cand_tokens, best)

    return body


def make_fused_train_only(normalize: bool = False, remat: bool = False,
                          w_fare_text: float = 1.0):
    """(state, adv1 [b,C1], anch1 [b,D], adv2 [b,C2], anch2 [b,D]) ->
    (state, metrics): one TextFARE update over the concatenation of two
    half-batches, computed as two half encodes (so the halves may sit in
    different context buckets: no pad/concat).  The loss is the mean
    over ALL 2b rows, exactly `make_fused_phase2_step`'s
    `sum(-1).mean()`, as two half sums."""

    def step_fn(state: TrainState, adv1, anch1, adv2, anch2):
        total = 0.0
        for adv, anch in ((adv1, anch1), (adv2, anch2)):
            feats = state.text.encode_text(adv, normalize, remat=remat)
            diff = anch.float() - feats.float()
            total = total + diff.square().sum(dim=-1).sum()
        n_rows = adv1.shape[0] + adv2.shape[0]
        return state, _update(state, w_fare_text * total / n_rows)

    return step_fn


def _filter_tokens(tokens: np.ndarray, clean: np.ndarray,
                   valid: np.ndarray) -> np.ndarray:
    """Replace invalid candidates' token rows with the clean sentence's
    tokens: `WordConstraint.filter` semantics on the [B, N, C] buffer."""
    bad_i, bad_j = np.nonzero(~valid)
    if len(bad_i):
        tokens = np.array(tokens)
        tokens[bad_i, bad_j] = clean[bad_i]
    return tokens


class _Readback:
    """A device tensor on its way to the host.

    On one CUDA stream a `.cpu()` waits for everything enqueued before
    it, also for work enqueued after the tensor was computed.  Here an
    event is recorded right behind the tensor's producer, a second
    stream waits for that event only and copies into pinned memory, and
    `wait()` blocks on the copy's own event: work enqueued on the
    compute stream in between does not hold the host back.  On the CPU
    the tensor is its own result."""

    def __init__(self, tensor: torch.Tensor,
                 copy_stream: Optional["torch.cuda.Stream"]):
        self._event = None
        if copy_stream is None:
            self._host = tensor
            return
        produced = torch.cuda.Event()
        produced.record()
        self._host = torch.empty(tensor.shape, dtype=tensor.dtype,
                                 pin_memory=True)
        with torch.cuda.stream(copy_stream):
            copy_stream.wait_event(produced)
            self._host.copy_(tensor, non_blocking=True)
            # the allocator must not hand the tensor's memory to the
            # compute stream before the copy has read it
            tensor.record_stream(copy_stream)
            self._event = torch.cuda.Event()
            self._event.record()

    def wait(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class FusedLeafStep:
    """Orchestrates the fused step (2 phases per edit round): covers
    k >= 1 and the constrained recipe; only the per-sentence charmer
    configuration takes the unfused path.

    `seconds` sums, over the steps so far, the wall seconds the host
    spent preparing tokens ("host": position draws, the probe and
    candidate grids, constraint masks, `prepare_probes` included) and
    blocked on best-probe readbacks ("wait").  `readbacks` counts the
    pipelined step's first readbacks that returned while the second
    half's phase 1 was still running on the device ("early") or after it
    ("late"); on the CPU both stay 0."""

    # anchor cache size guard: 1M captions x 768 bf16 = 1.5 GB
    MAX_CACHED_ANCHORS = 1_000_000

    def __init__(self, cfg: CLIPConfig, tokenizer, rho: int,
                 vocab=edits.DEFAULT_VOCAB, normalize: bool = False,
                 remat: bool = False, cache_anchors: bool = True,
                 constraint=None, objective: str = "l2",
                 w_fare_text: float = 1.0, k: int = 1,
                 pipeline: bool = True, device="cuda"):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.rho = rho
        self.device = torch.device(device)
        # edit rounds: rounds 0..k-2 score candidates and return the
        # winner to the host (the next round's edits retokenise the
        # winning string); only the final round fuses the train update
        self.k = k
        self.vocab = np.asarray(vocab, np.int32)
        self.vocab_list = list(vocab)
        # word-validity constraint (`--constrain`, the released-model
        # recipe): invalid candidates' token rows are replaced by the
        # clean sentence's tokens, exactly `WordConstraint.filter`'s
        # replace-with-original semantics, but computed as a [B, rho]
        # mask (C++ fast path) and applied to the fixed-shape buffer
        self.constraint = constraint
        # frozen-tower anchor features keyed by caption: exact reuse
        # across epochs (the frozen tower never changes).  The rows stay
        # on the tower's device, in its compute dtype, as views of the
        # step's anchor tensor that computed them: a hit stacks them
        # there, with no copy through the host and no sync, and gives
        # bit for bit what the miss computed.
        self.anchor_cache: Optional[Dict[str, torch.Tensor]] = \
            {} if cache_anchors else None
        # context bucketing: only feature-invariant for causal+argmax
        # towers
        self._do_bucket = engine_can_bucket(cfg)
        self.phase1 = make_fused_phase1(normalize, objective)
        self.phase1_cached = make_fused_phase1_cached(objective)
        self.phase2 = make_fused_phase2_step(normalize, remat, objective,
                                             w_fare_text)
        # half-batch pipelining (k=1 only): split the batch in two, keep
        # BOTH halves' phase 1 enqueued, and overlap each half's
        # best-probe readback (the step's only hard host sync) and the
        # host's candidate tokenizing with the other half's device work.
        # Same rng stream, same winners, one combined optimizer step
        # whose loss is the mean over all B rows; but the loss reduces
        # in a different fp order (two half sums / B against mean over
        # B), so gradients match the unpipelined step only to ~1e-7 and
        # Adam trajectories drift at noise level; pass pipeline=False
        # for the unpipelined numerics.  k>1 stays unpipelined ON
        # PURPOSE: round r+1's position draws retokenise round r's
        # winners, so the full-batch rng order cannot survive a half
        # split.
        self._pipeline = pipeline
        self.phase2_score = make_fused_phase2_score(objective)
        self.train_only = make_fused_train_only(normalize, remat, w_fare_text)
        self._copy_stream = None
        self.seconds = {"host": 0.0, "wait": 0.0}
        self.readbacks = {"early": 0, "late": 0}

    # -- host <-> device ----------------------------------------------------

    def _bucket(self, tokens):
        return bucket_tokens(tokens) if self._do_bucket \
            else np.asarray(tokens)

    def _put(self, tokens: np.ndarray) -> torch.Tensor:
        """Host token buffer -> the device, from pinned memory and not
        waited for (`data.common.put_batch`)."""
        return put_batch(tokens, self.device)

    def _readback(self, tensor: torch.Tensor) -> _Readback:
        if self.device.type == "cuda" and self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        return _Readback(tensor, self._copy_stream)

    def _wait(self, readback: _Readback) -> np.ndarray:
        t0 = time.perf_counter()
        out = readback.wait()
        self.seconds["wait"] += time.perf_counter() - t0
        return out

    def _timed_host(self, fn: Callable, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.seconds["host"] += time.perf_counter() - t0
        return out

    # -- host-side token grids ---------------------------------------------

    def _probe_tokens(self, texts, positions):
        space = np.full(positions.shape, ord(" "), np.int32)
        toks = _edit_tokens_fast(self.tokenizer, texts, positions, space)
        if toks is None:
            rows = [[edits.apply_edit(S, int(z), 0, edits.SPACE_VOCAB,
                                      alternative=-1) for z in positions[i]]
                    for i, S in enumerate(texts)]
            toks = self.tokenizer([s for r in rows for s in r]).reshape(
                len(texts), self.rho, -1)
        return toks

    def _cand_tokens(self, texts, best_pos, us):
        zs = np.repeat(np.asarray(best_pos, np.int32)[:, None], self.rho,
                       axis=1)
        toks = _edit_tokens_fast(self.tokenizer, texts, zs, self.vocab[us])
        if toks is None:
            rows = [[edits.apply_edit(S, best_pos[i], int(u), self.vocab_list,
                                      alternative=-1) for u in us[i]]
                    for i, S in enumerate(texts)]
            toks = self.tokenizer([s for r in rows for s in r]).reshape(
                len(texts), self.rho, -1)
        return toks

    def _candidates(self, texts, best_pos, us, clean_raw) -> np.ndarray:
        """The [B, rho, C] candidate buffer of one round (unbucketed),
        with the constraint's replacements."""
        cand_raw = self._cand_tokens(texts, best_pos, us)
        if self.constraint is not None:
            zs = np.repeat(np.asarray(best_pos, np.int32)[:, None], self.rho,
                           axis=1)
            valid = self.constraint.valid_edits_batch(texts, zs,
                                                      self.vocab[us])
            cand_raw = _filter_tokens(cand_raw, clean_raw, valid)
        return cand_raw

    def _draw_chars(self, rng: np.random.Generator, rows: int) -> np.ndarray:
        """Per-row character draws, in row order."""
        n, nv = self.rho, len(self.vocab_list)
        return np.stack([rng.choice(nv, size=n, replace=(n > nv))
                         for _ in range(rows)])

    def _apply_winners(self, texts, best_pos, us, best_idx):
        """Apply each row's winning (position, char) edit on the host;
        constraint-filtered winners resolve to the unchanged sentence
        (their token rows were replaced by the clean tokens)."""
        out = []
        for i, S in enumerate(texts):
            adv = edits.apply_edit(S, best_pos[i],
                                   int(us[i][best_idx[i]]),
                                   self.vocab_list, alternative=-1)
            if self.constraint is not None \
                    and not self.constraint.valid(S, adv)[0]:
                adv = S
            out.append(adv)
        return out

    def _prepare(self, texts: List[str], rng: np.random.Generator) -> dict:
        positions = np.stack([edits.sample_positions(len(S), self.rho,
                                                     rng=rng)
                              for S in texts])
        probe_raw = self._probe_tokens(texts, positions)
        clean_raw = None
        if self.constraint is not None:
            clean_raw = np.asarray(self.tokenizer(texts))
            space = np.full(positions.shape, ord(" "), np.int32)
            valid = self.constraint.valid_edits_batch(texts, positions,
                                                      space)
            probe_raw = _filter_tokens(probe_raw, clean_raw, valid)
        return {"texts": texts, "positions": positions,
                "probe_raw": probe_raw, "clean_raw": clean_raw}

    def prepare_probes(self, texts, rng: np.random.Generator) -> dict:
        """Host-side phase-1 prep for a batch: position sampling, probe
        edit tokenisation, constraint filtering.  Pass the result as
        `prepared=` to `__call__` for the same batch.

        This is the overlap hook: the caller runs it for batch i+1 right
        after batch i's train step is enqueued, so the host's BPE work
        hides behind the device's step.  RNG draws happen at call time,
        so calling it *after* batch i's step preserves the exact
        unoverlapped rng stream."""
        return self._timed_host(self._prepare, list(texts), rng)

    def _prepared_or_new(self, texts, rng, prepared):
        if prepared is None or prepared["texts"] != texts:
            prepared = self.prepare_probes(texts, rng)
        return (prepared["positions"], prepared["probe_raw"],
                prepared["clean_raw"])

    # -- anchors -----------------------------------------------------------

    def _cached_anchors(self, texts) -> Optional[torch.Tensor]:
        cache = self.anchor_cache
        if cache is None or not all(t in cache for t in texts):
            return None
        return torch.stack([cache[t] for t in texts])

    def _fill_cache(self, texts, anchors: torch.Tensor) -> None:
        cache = self.anchor_cache
        if cache is not None and len(cache) < self.MAX_CACHED_ANCHORS:
            for t, a in zip(texts, anchors):
                cache[t] = a

    # -- the step ----------------------------------------------------------

    def _use_pipeline(self, B: int) -> bool:
        """Half-batch pipelining applies to k=1 steps with an evenly
        splittable batch."""
        return bool(self._pipeline and self.k == 1 and B % 2 == 0 and B >= 4)

    def _pipelined(self, state: TrainState, frozen_text: TextTower, texts,
                   rng: np.random.Generator, prepared: Optional[dict]
                   ) -> Tuple[TrainState, dict]:
        """k=1 step over half-batches: P1(H1), P1(H2), score(H1),
        score(H2), train(H1+H2).  While the host waits for H1's
        best-probe readback and tokenizes H1's candidates, the device
        runs H2's phase 1; H2's readback and candidates overlap H1's
        candidate scoring.  The rng stream (positions for the whole
        batch, then per-row char draws in row order) is identical to the
        unpipelined step."""
        B = len(texts)
        h = B // 2
        positions, probe_raw, clean_raw = self._prepared_or_new(
            texts, rng, prepared)
        probe_tokens = self._bucket(probe_raw)  # full-batch bucket: both
        clean_tokens = None                     # halves share the shape
        if clean_raw is None and self._cached_anchors(texts) is None:
            clean_raw = self._timed_host(
                lambda: np.asarray(self.tokenizer(texts)))
        if clean_raw is not None:
            # bucket the clean tokens once, full-batch, so both halves'
            # phase 1 share one shape
            clean_tokens = self._bucket(clean_raw)

        # enqueue BOTH halves' phase 1 before reading either result
        halves = []
        for rows in (slice(0, h), slice(h, B)):
            t_h = texts[rows]
            pt = self._put(probe_tokens[rows])
            anch = self._cached_anchors(t_h)
            if anch is not None:
                bp = self.phase1_cached(state.text, pt, anch)
            else:
                anch, bp = self.phase1(frozen_text, state.text,
                                       self._put(clean_tokens[rows]), pt)
                self._fill_cache(t_h, anch)
            halves.append({"rows": rows, "texts": t_h, "anch": anch,
                           "bp": self._readback(bp)})
        phase1_done = _marker(self.device)

        outs = []
        for hd in halves:
            # hard sync, overlapped by the other half's enqueued work
            bp = self._wait(hd["bp"])
            if phase1_done is not None and not outs:
                early = not phase1_done.query()
                self.readbacks["early" if early else "late"] += 1
            pos_rows = positions[hd["rows"]]
            best_pos = [int(pos_rows[i][bp[i]]) for i in range(h)]
            us = self._draw_chars(rng, h)
            cand_raw = self._timed_host(
                self._candidates, hd["texts"], best_pos, us,
                None if clean_raw is None else clean_raw[hd["rows"]])
            cand_tokens = self._bucket(cand_raw)
            if self._do_bucket \
                    and cand_tokens.shape[-1] < probe_tokens.shape[-1]:
                # pad each half's candidates up to the shared probe
                # bucket: candidates replace the probe's inserted space
                # at the same slot, so both halves almost always share
                # that width.  Zero-pad past EOT is exactly what a wider
                # bucket is (feature-invariant for causal+argmax towers,
                # the only towers _do_bucket enables).
                pad = probe_tokens.shape[-1] - cand_tokens.shape[-1]
                cand_tokens = np.pad(cand_tokens, ((0, 0), (0, 0), (0, pad)))
            best, adv = self.phase2_score(state.text, self._put(cand_tokens),
                                          hd["anch"])
            outs.append({"best_pos": best_pos, "us": us, "best": best,
                         "adv": adv})
        # the attack's device work ends here, BEFORE the train update
        marker = _marker(self.device)

        state, metrics = self.train_only(
            state, outs[0]["adv"], halves[0]["anch"],
            outs[1]["adv"], halves[1]["anch"])
        info = {"best_pos": outs[0]["best_pos"] + outs[1]["best_pos"],
                "best_char_idx": (outs[0]["best"], outs[1]["best"]),
                "us": np.concatenate([outs[0]["us"], outs[1]["us"]]),
                "base_texts": texts, "metrics": metrics,
                "attack_marker": marker}
        return state, info

    def __call__(self, state: TrainState, frozen_text: TextTower, texts,
                 rng: np.random.Generator, prepared: Optional[dict] = None
                 ) -> Tuple[TrainState, dict]:
        """One LEAF step on `texts`: (state, info).  `info` holds
        `best_pos`, `best_char_idx` (on the device; a tuple of the two
        halves' on the pipelined path), `us`, `base_texts`, `metrics`
        (`loss` and `grad_norm`, on the device) and `attack_marker`."""
        texts_cur = list(texts)
        B = len(texts_cur)
        if self._use_pipeline(B):
            return self._pipelined(state, frozen_text, texts_cur, rng,
                                   prepared)
        anchors = None

        for r in range(self.k):
            positions, probe_raw, clean_raw = self._prepared_or_new(
                texts_cur, rng, prepared if r == 0 else None)
            probe_tokens = self._put(self._bucket(probe_raw))
            if anchors is None:
                anchors = self._cached_anchors(texts_cur)
            if anchors is not None:
                best_probe = self.phase1_cached(state.text, probe_tokens,
                                                anchors)
            else:
                if clean_raw is None:
                    clean_raw = self._timed_host(
                        lambda: np.asarray(self.tokenizer(texts_cur)))
                anchors, best_probe = self.phase1(
                    frozen_text, state.text,
                    self._put(self._bucket(clean_raw)), probe_tokens)
                self._fill_cache(texts_cur, anchors)
            best_probe = self._wait(self._readback(best_probe))  # hard sync
            best_pos = [int(positions[i][best_probe[i]]) for i in range(B)]

            us = self._draw_chars(rng, B)
            cand_raw = self._timed_host(self._candidates, texts_cur, best_pos,
                                        us, clean_raw)
            cand_tokens = self._put(self._bucket(cand_raw))
            if r < self.k - 1:
                # intermediate round: pick the winner, edit on the host
                best = self._wait(self._readback(self.phase1_cached(
                    state.text, cand_tokens, anchors)))
                texts_cur = self._apply_winners(texts_cur, best_pos, us, best)
            else:
                state, best, metrics, marker = self.phase2(
                    state, cand_tokens, anchors)

        info = {"best_pos": best_pos, "best_char_idx": best, "us": us,
                "base_texts": texts_cur, "metrics": metrics,
                "attack_marker": marker}
        return state, info

    def adv_sentences(self, texts, info):
        """Reconstruct the winning adversarial strings (logging only;
        reads the winners' indices, so it waits for the device).
        `texts` is the ORIGINAL batch; for k>1 the final round's base
        strings are carried in `info`.  The pipelined step stores the
        two halves' winner indices as a tuple."""
        best = info["best_char_idx"]
        if isinstance(best, tuple):
            best = torch.cat(best)
        return self._apply_winners(info.get("base_texts", texts),
                                   info["best_pos"], info["us"],
                                   best.cpu().numpy())
