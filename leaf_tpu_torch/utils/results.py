"""CSV ledgers: per-epoch results and per-step attack timing (port of
`leaf_tpu/utils/results.py`).

`results.csv` holds the tracked metrics of every epoch, and
`times_{attack}.csv` the wall seconds of every batch's attack: the
trainer's own attack-throughput record.  `AsyncAttackTimer` times the
fused step's attack from a worker thread that waits on a CUDA event.
"""
from __future__ import annotations

import csv
import os
import queue
import threading
import time
from typing import Dict, List, Optional


class ResultsLedger:
    """Append-per-epoch CSV with a stable, inferred column set.

    `fresh=True` ignores any pre-existing file (eval artifacts must not
    mix a previous run's rows in); `stream=True` appends rows
    incrementally instead of rewriting the whole file per append
    (eval ledgers with thousands of rows — training results.csv keeps
    the atomic whole-file rewrite for resume truncation)."""

    def __init__(self, path: str, columns: Optional[List[str]] = None,
                 fresh: bool = False, stream: bool = False):
        self.path = path
        self.columns = columns
        self.rows: List[Dict] = []
        self.stream = stream
        self._written = 0
        if os.path.exists(path) and not fresh:
            self.load()
            self._written = len(self.rows)

    def load(self):
        with open(self.path, newline="") as f:
            reader = csv.DictReader(f)
            self.columns = list(reader.fieldnames or [])
            self.rows = [dict(r) for r in reader]

    def append(self, row: Dict):
        if self.columns is None:
            self.columns = list(row.keys())
        self.rows.append(row)
        if self.stream:
            self._flush_incremental()
        else:
            self.flush()

    def _flush_incremental(self):
        header = self._written == 0 or not os.path.exists(self.path)
        with open(self.path, "w" if header else "a", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self.columns,
                                    extrasaction="ignore")
            if header:
                writer.writeheader()
            writer.writerows(self.rows[self._written:])
        self._written = len(self.rows)

    def flush(self):
        tmp = self.path + ".tmp"
        with open(tmp, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self.columns,
                                    extrasaction="ignore")
            writer.writeheader()
            writer.writerows(self.rows)
        os.replace(tmp, self.path)

    def truncate_to_epoch(self, epoch: int, epoch_key: str = "epoch"):
        """Drop rows past `epoch` on resume."""
        self.rows = [r for r in self.rows
                     if float(r.get(epoch_key, -1)) <= epoch]
        if self.rows:
            self.flush()


class TimingLedger:
    """Streaming one-column CSV of per-batch attack wall times."""

    def __init__(self, path: str):
        self.path = path
        self.times: List[float] = []

    def append(self, seconds: float):
        # incremental append (this runs once per training batch —
        # rewriting the whole file per step is O(n²) I/O).  The FIRST
        # append of this ledger truncates: a stale times_*.csv from a
        # previous run must not have new rows appended to it.
        first = not self.times
        self.times.append(seconds)
        with open(self.path, "w" if first else "a", newline="") as f:
            writer = csv.writer(f)
            if first:
                writer.writerow(["0"])
            writer.writerow([seconds])


class AsyncAttackTimer:
    """Attack-only wall times for the *fused* LEAF step.

    `times_{use_charmer}.csv` times exactly the inner maximisation.  The
    unfused loop times the attack call, which ends in a copy of the
    winners to the host and so waits for the device.  The fused step
    never returns strings: its
    attack ends when the final candidate-scoring work is done on the
    device, *before* the train update.  Blocking the training thread
    there would serialise the loop's host/device overlap, so a single
    worker thread waits on the steps' markers in order and appends
    (t_ready - t_start) to the ledger.  Rows land in step order; the
    value logged inline (`last`) may lag the current step by one.

    A marker is a `torch.cuda.Event` recorded right after the step's last
    scoring call, or None on a CPU device, where that work is done by
    the time the step returns.  `Event.synchronize()` waits inside the
    CUDA runtime with the interpreter lock released, so the worker does
    not hold the training thread back.  On the k=1 pipelined path the
    event sits between the second half's scoring and the train update;
    on the unpipelined path it sits after the candidates' argmax, again
    before the update's forward.
    """

    def __init__(self, ledger: TimingLedger):
        self.ledger = ledger
        self.last = 0.0
        self._q: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, t_start: float, marker) -> None:
        """Enqueue a step: `t_start` from time.perf_counter() at attack
        start, `marker` the event that marks the end of the attack's
        device work (None: already done)."""
        self._q.put((t_start, marker, time.perf_counter()))

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                t_start, marker, t_submitted = item
                if marker is None:
                    t_ready = t_submitted
                else:
                    try:
                        marker.synchronize()
                    except RuntimeError:   # a failed launch surfaces in
                        pass               # the main thread instead
                    t_ready = time.perf_counter()
                self.last = t_ready - t_start
                self.ledger.append(self.last)
            finally:
                self._q.task_done()

    def drain(self) -> None:
        """Block until every submitted step has been timed and written."""
        self._q.join()

    def close(self) -> None:
        self.drain()
        self._q.put(None)
        self._thread.join()
