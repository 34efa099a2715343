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

On one rank each caption's probe and candidate rows are encoded at that
caption's own context bucket (`FusedLeafStep._score_groups`), so one long
caption no longer pads the whole batch's rows to its width.

The adversarial *strings* never return to the host: the winning tokens
feed the train forward on the device.  Selection semantics are those of
`attack_text_leaf` (same probe and candidate generation, same argmax);
`tests/test_torch_fused.py` pins the equivalence against the unfused
path and against the JAX package's fused step.

Across ranks (`parallel.distributed`), each rank runs the step on its
own rows of the global batch.  As in the JAX package's multi-host step,
one small all-reduce a round agrees on the bucket widths (the global max
of every rank's need) and on the phase-1 branch: the cached phase 1 runs
only where every rank hit its own anchor cache.  The candidates' width is
agreed the same way, the logged loss is the mean over ranks, and the
half-batch pipeline is off, as it is there.

On a tensor-parallel grid (`parallel.sharding`, `grid` given; the towers
sharded with `shard_module`, the optimizer made with the grid) the rows
and the agreement are the data group's: every rank of a model group takes
the same captions and the same rng stream, so it draws the same probes
and characters, and its encodes are one tensor-parallel encode.

Against the JAX module: a phase body is a plain function on the port's
`TextTower` (no jit, no `cfg`/`tx`/`dtype` arguments: the tower knows its
config and compute dtype, the `TrainState` holds the optimizer), scoring
runs under `torch.no_grad()`, and the state is updated in place.  There
is no mesh or `shard_map`: a rank's phases are local, and the ranks meet
only in the agreement above and the optimizer's gradient mean.
Everything is enqueued on the current CUDA stream, so a train step, its
in-place AdamW update and the next step's phase 1 keep a single stream's
order; only the best-probe readback uses a second stream (`_Readback`).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from leaf_tpu_torch.attacks import edits
from leaf_tpu_torch.attacks.engine import (CONTEXT_BUCKETS, bucket_need,
                                           bucket_tokens,
                                           can_bucket as engine_can_bucket,
                                           objective_loss)
from leaf_tpu_torch.attacks.text import _edit_tokens_fast
from leaf_tpu_torch.data.common import put_batch
from leaf_tpu_torch.models.clip import TextTower, l2_normalize
from leaf_tpu_torch.models.config import CLIPConfig
from leaf_tpu_torch.parallel.distributed import (global_max_int32, pmean,
                                                 world_size)
from leaf_tpu_torch.train.step import TrainState, make_anchor_encode
from leaf_tpu_torch.utils.tracing import span

# A single-rank step scores each caption's probe and candidate rows at that
# caption's own context bucket (`FusedLeafStep._score_groups`).  One more
# encode costs its launches, so a narrower group of captions is split off
# only where the token slots it saves (its rows times the next wider
# group's width less its own) exceed this many; else it joins that group.
# On an H100 the host takes 7-10 ms to enqueue one more scoring group of
# the ViT-L text tower, the card 0.57 us a slot at bucket 16 (PERF.md).
SPLIT_MIN_SLOTS = 16_000


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


def _own_tokens(tokens) -> int:
    """Tokens from SOT to EOT summed over the rows of a token grid: EOT is
    a row's largest id, where the tower pools."""
    if isinstance(tokens, torch.Tensor):
        tokens = tokens.cpu().numpy()
    return int(tokens.argmax(-1).sum()) + tokens[..., 0].size


def _count_grid(s, tokens, groups=None) -> None:
    """Add a token grid's slots, own tokens and encodes to span `s`: the
    slots are its rows times the width they were encoded at, `groups`'
    widths where given (`_split_groups`), else the grid's own in one
    encode.  The own tokens are counted when the recording is read, so
    that the step spends no host time on them."""
    if groups is None:
        groups = [(tokens, tokens.shape[-1])]
    per = int(np.prod(tokens.shape[1:-1]))
    s.add("slots", sum(len(idx) * per * w for idx, w in groups))
    s.add("groups", len(groups))
    s.add("own_tokens", lambda: _own_tokens(tokens))


def _caption_widths(grid: np.ndarray) -> np.ndarray:
    """[B, N, C] token grid -> [B]: the width `bucket_tokens` gives each
    caption's N rows alone, the smallest bucket that holds their largest
    EOT+1 (C where none does)."""
    C = grid.shape[-1]
    widths = np.array(sorted({b for b in CONTEXT_BUCKETS if b < C} | {C}))
    return widths[np.searchsorted(widths, grid.argmax(-1).max(-1) + 1)]


def _split_groups(widths: np.ndarray, rows: int
                  ) -> List[Tuple[np.ndarray, int]]:
    """Captions of `widths` [B] (`rows` token rows each) grouped by width,
    narrowest first: [(caption indices in row order, width)].  A group
    that would save no more than `SPLIT_MIN_SLOTS` slots joins the next
    wider one, so a grid of one width is one group."""
    present = np.unique(widths)
    groups, carry = [], np.zeros(0, np.int64)
    for w, wider in zip(present, list(present[1:]) + [None]):
        idx = np.concatenate([carry, np.flatnonzero(widths == w)])
        if wider is not None \
                and len(idx) * rows * (wider - w) <= SPLIT_MIN_SLOTS:
            carry = idx
            continue
        groups.append((np.sort(idx), int(w)))
        carry = np.zeros(0, np.int64)
    return groups


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
    the device (reading one waits for it).  The logged loss is the mean
    over ranks."""
    loss.backward()
    grad_norm = state.optimizer.update(state.step)
    state.step += 1
    grid = getattr(state.optimizer, "grid", None)
    mean = pmean(loss.detach()) if grid is None else \
        grid.data_pmean(loss.detach())
    return {"loss": mean, "grad_norm": grad_norm}


def make_fused_train(normalize: bool = False, remat: bool = False,
                     w_fare_text: float = 1.0):
    """(state, adv_tokens [B,C], anchors [B,D]) -> (state, metrics): one
    TextFARE update of the unpipelined step, on the winners that
    `make_fused_phase2_score` took."""

    def step_fn(state: TrainState, adv_tokens: torch.Tensor,
                anchors: torch.Tensor):
        adv_feats = state.text.encode_text(adv_tokens, normalize,
                                           remat=remat)
        diff = anchors.float() - adv_feats.float()
        loss = w_fare_text * diff.square().sum(dim=-1).mean()
        return state, _update(state, loss)

    return step_fn


def make_fused_phase2_score(objective: str = "l2"):
    """(train_text, cand_tokens [b,N,C], anchors [b,D]) ->
    (best [b], adv_tokens [b,C]): the scoring half of phase 2 (the update
    follows as `make_fused_train`, or on the pipelined step as
    `make_fused_train_only`, so that the two half-batches share one
    optimizer step)."""

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
    over ALL 2b rows, exactly `make_fused_train`'s
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

    `seconds["host"]` sums, over the steps so far, the wall seconds the
    host spent preparing tokens (position draws, the probe and candidate
    grids, constraint masks, `prepare_probes` included): the durations of
    the spans `train.fused.prepare`, `.candidates` and `.clean`.

    Spans (`utils.tracing`, kept while a recording is on):
    `train.fused.step` around a step; the host grids above; each
    best-probe readback's wait, `train.fused.wait`, whose count `early`
    (the pipelined step's first wait, on a card) is 1 where the readback
    returned while the second half's phase 1 still ran on the device; and
    the enqueueing of each encode, `train.fused.enqueue.phase1`, `.score`
    and `.update`, with the `slots` (rows x the width each was encoded
    at), `own_tokens` (SOT to EOT) and `groups` (the encodes made) of the
    token grids it encodes."""

    # anchor cache size guard: 1M captions x 768 bf16 = 1.5 GB
    MAX_CACHED_ANCHORS = 1_000_000

    def __init__(self, cfg: CLIPConfig, tokenizer, rho: int,
                 vocab=edits.DEFAULT_VOCAB, normalize: bool = False,
                 remat: bool = False, cache_anchors: bool = True,
                 constraint=None, objective: str = "l2",
                 w_fare_text: float = 1.0, k: int = 1,
                 pipeline: bool = True, device="cuda", grid=None):
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
        # across ranks, every round agrees on the bucket widths and the
        # phase-1 branch (one all-reduce of [probe need, any miss, clean
        # need], and one of the candidates' need)
        self._multihost = world_size() > 1
        self.grid = grid
        self._agree = (world_size() if grid is None else grid.data) > 1
        # one rank alone scores each caption at its own bucket
        # (`_score_groups`); across ranks and on a grid the widths agreed
        # for the whole grid hold
        self._split = self._do_bucket and not self._agree and grid is None
        self.anchor_encode = make_anchor_encode(normalize)
        self.phase1 = make_fused_phase1(normalize, objective)
        self.phase1_cached = make_fused_phase1_cached(objective)
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
        self.train = make_fused_train(normalize, remat, w_fare_text)
        self.train_only = make_fused_train_only(normalize, remat, w_fare_text)
        self._copy_stream = None
        self.seconds = {"host": 0.0}

    # -- host <-> device ----------------------------------------------------

    def _global_max(self, values) -> np.ndarray:
        """`global_max_int32` over the ranks that split the batch."""
        if self.grid is None:
            return global_max_int32(values)
        return self.grid.data_max_int32(values)

    def _bucket(self, tokens, need: Optional[int] = None):
        return bucket_tokens(tokens, need=need) if self._do_bucket \
            else np.asarray(tokens)

    def _put(self, tokens: np.ndarray) -> torch.Tensor:
        """Host token buffer -> the device, from pinned memory and not
        waited for (`data.common.put_batch`)."""
        return put_batch(tokens, self.device)

    def _readback(self, tensor: torch.Tensor) -> _Readback:
        if self.device.type == "cuda" and self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        return _Readback(tensor, self._copy_stream)

    def _wait(self, readback: _Readback, phase1_done=None) -> np.ndarray:
        """The readback's value; with `phase1_done` (the pipelined step's
        marker behind both halves' phase 1) the span counts whether it
        returned before that marker."""
        with span("train.fused.wait") as s:
            out = readback.wait()
            if s and phase1_done is not None:
                s.add("early", int(not phase1_done.query()))
        return out

    def _timed_host(self, name: str, fn: Callable, *args):
        with span(name):
            t0 = time.perf_counter()
            out = fn(*args)
            self.seconds["host"] += time.perf_counter() - t0
        return out

    def _score_groups(self, text: TextTower, grid: np.ndarray,
                      anchors: torch.Tensor, winners: bool = False):
        """Score a bucketed host grid [b, N, C] against `anchors` [b, D]:
        (best [b], the winners' tokens [b, W] where `winners`, else None,
        the groups encoded).  Where `_split`, each group of captions
        (`_split_groups`) is encoded at its own width and the results are
        put back in row order on the device; W is the widest group's
        width, narrower winners zero-padded past EOT (feature-invariant
        for the towers `_do_bucket` admits).  A grid of one group is one
        encode of the whole grid, as is every grid elsewhere."""
        if self._split:
            groups = _split_groups(_caption_widths(grid), grid.shape[1])
        else:
            groups = [(np.arange(len(grid)), grid.shape[-1])]
        if len(groups) == 1:
            tokens = self._put(grid[..., :groups[0][1]])
            if winners:
                best, adv = self.phase2_score(text, tokens, anchors)
                return best, adv, groups
            return self.phase1_cached(text, tokens, anchors), None, groups
        order = np.concatenate([idx for idx, _ in groups])
        # the groups' anchor rows, then the way back to row order
        perm = self._put(np.concatenate([order, np.argsort(order)]))
        width = groups[-1][1]
        bests, advs, at = [], [], 0
        for idx, w in groups:
            tokens = self._put(grid[idx, :, :w])
            anch = anchors.index_select(0, perm[at:at + len(idx)])
            at += len(idx)
            if winners:
                best, adv = self.phase2_score(text, tokens, anch)
                advs.append(torch.nn.functional.pad(adv, (0, width - w)))
            else:
                best = self.phase1_cached(text, tokens, anch)
            bests.append(best)
        back = perm[len(order):]
        best = torch.cat(bests).index_select(0, back)
        if winners:
            return best, torch.cat(advs).index_select(0, back), groups
        return best, None, groups

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
        return self._timed_host("train.fused.prepare", self._prepare,
                                list(texts), rng)

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
        """Half-batch pipelining applies to one-rank k=1 steps with an
        evenly splittable batch."""
        return bool(self._pipeline and self.k == 1 and B % 2 == 0 and B >= 4
                    and not self._multihost)

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
        probe_tokens = self._bucket(probe_raw)
        clean_tokens = None
        if clean_raw is None and self._cached_anchors(texts) is None:
            clean_raw = self._timed_host(
                "train.fused.clean", lambda: np.asarray(self.tokenizer(texts)))
        if clean_raw is not None:
            # bucket the clean tokens once, full-batch, so both halves'
            # phase 1 share one shape
            clean_tokens = self._bucket(clean_raw)

        # enqueue BOTH halves' phase 1 before reading either result
        halves = []
        for rows in (slice(0, h), slice(h, B)):
            t_h = texts[rows]
            with span("train.fused.enqueue.phase1") as s:
                anch = self._cached_anchors(t_h)
                cached = anch is not None
                if not cached:
                    anch = self.anchor_encode(frozen_text,
                                              self._put(clean_tokens[rows]))
                    self._fill_cache(t_h, anch)
                bp, _, groups = self._score_groups(
                    state.text, probe_tokens[rows], anch)
                halves.append({"rows": rows, "texts": t_h, "anch": anch,
                               "bp": self._readback(bp)})
            if s:
                _count_grid(s, probe_tokens[rows], groups)
                if not cached:
                    _count_grid(s, clean_tokens[rows])
        phase1_done = _marker(self.device)

        outs = []
        for hd in halves:
            # hard sync, overlapped by the other half's enqueued work
            bp = self._wait(hd["bp"], None if outs else phase1_done)
            pos_rows = positions[hd["rows"]]
            best_pos = [int(pos_rows[i][bp[i]]) for i in range(h)]
            us = self._draw_chars(rng, h)
            cand_raw = self._timed_host(
                "train.fused.candidates", self._candidates, hd["texts"],
                best_pos, us,
                None if clean_raw is None else clean_raw[hd["rows"]])
            cand_tokens = self._bucket(cand_raw)
            with span("train.fused.enqueue.score") as s:
                best, adv, groups = self._score_groups(
                    state.text, cand_tokens, hd["anch"], winners=True)
            if s:
                _count_grid(s, cand_tokens, groups)
            outs.append({"best_pos": best_pos, "us": us, "best": best,
                         "adv": adv})
        # the attack's device work ends here, BEFORE the train update;
        # each half's winners are encoded at that half's width
        marker = _marker(self.device)

        with span("train.fused.enqueue.update") as s:
            state, metrics = self.train_only(
                state, outs[0]["adv"], halves[0]["anch"],
                outs[1]["adv"], halves[1]["anch"])
        if s:
            for out in outs:
                _count_grid(s, out["adv"])
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
        with span("train.fused.step"):
            if self._use_pipeline(len(texts_cur)):
                return self._pipelined(state, frozen_text, texts_cur, rng,
                                       prepared)
            return self._rounds(state, frozen_text, texts_cur, rng, prepared)

    def _rounds(self, state: TrainState, frozen_text: TextTower, texts_cur,
                rng: np.random.Generator, prepared: Optional[dict]
                ) -> Tuple[TrainState, dict]:
        """The unpipelined step: k edit rounds over the whole batch, the
        train update behind the last."""
        B = len(texts_cur)
        anchors = None

        for r in range(self.k):
            positions, probe_raw, clean_raw = self._prepared_or_new(
                texts_cur, rng, prepared if r == 0 else None)
            probe_need = clean_need = None
            cached = None if anchors is not None \
                else self._cached_anchors(texts_cur)
            if self._agree:
                if anchors is None and clean_raw is None:
                    # tokenised up front: if any rank misses, every rank
                    # runs phase 1 and needs its clean tokens
                    clean_raw = self._timed_host(
                        "train.fused.clean",
                        lambda: np.asarray(self.tokenizer(texts_cur)))
                g = self._global_max([
                    bucket_need(probe_raw) if self._do_bucket else 0,
                    0 if (cached is not None or anchors is not None) else 1,
                    (bucket_need(clean_raw) if self._do_bucket else 0)
                    if clean_raw is not None else 0])
                probe_need = int(g[0]) or None
                clean_need = int(g[2]) or None
                if int(g[1]):
                    cached = None
            probe_grid = self._bucket(probe_raw, probe_need)
            if anchors is None:
                anchors = cached
            clean_grid = None
            if anchors is None:
                if clean_raw is None:
                    clean_raw = self._timed_host(
                        "train.fused.clean",
                        lambda: np.asarray(self.tokenizer(texts_cur)))
                clean_grid = self._bucket(clean_raw, clean_need)
            with span("train.fused.enqueue.phase1") as s:
                groups = None
                if clean_grid is not None and not self._split:
                    anchors, best_probe = self.phase1(
                        frozen_text, state.text, self._put(clean_grid),
                        self._put(probe_grid))
                else:
                    if clean_grid is not None:
                        anchors = self.anchor_encode(frozen_text,
                                                     self._put(clean_grid))
                    best_probe, _, groups = self._score_groups(
                        state.text, probe_grid, anchors)
                if clean_grid is not None:
                    self._fill_cache(texts_cur, anchors)
                readback = self._readback(best_probe)
            if s:
                _count_grid(s, probe_grid, groups)
                if clean_grid is not None:
                    _count_grid(s, clean_grid)
            best_probe = self._wait(readback)  # hard sync
            best_pos = [int(positions[i][best_probe[i]]) for i in range(B)]

            us = self._draw_chars(rng, B)
            cand_raw = self._timed_host("train.fused.candidates",
                                        self._candidates, texts_cur, best_pos,
                                        us, clean_raw)
            cand_need = None
            if self._agree and self._do_bucket:
                cand_need = int(self._global_max([bucket_need(cand_raw)])[0])
            cand_grid = self._bucket(cand_raw, cand_need)
            with span("train.fused.enqueue.score") as s:
                best, adv, groups = self._score_groups(
                    state.text, cand_grid, anchors, winners=r == self.k - 1)
                if r < self.k - 1:
                    readback = self._readback(best)
            if s:
                _count_grid(s, cand_grid, groups)
            if r < self.k - 1:
                # intermediate round: pick the winner, edit on the host
                best = self._wait(readback)
                texts_cur = self._apply_winners(texts_cur, best_pos, us, best)

        # the attack's device work ends here, BEFORE the train update
        marker = _marker(self.device)
        with span("train.fused.enqueue.update") as s:
            state, metrics = self.train(state, adv, anchors)
        if s:
            _count_grid(s, adv)

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
