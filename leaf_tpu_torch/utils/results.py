"""CSV ledgers: per-epoch results and per-step attack timing (port of
`leaf_tpu/utils/results.py`).

`results.csv` holds the tracked metrics of every epoch, and
`times_{attack}.csv` the wall seconds of every batch's attack: the
trainer's own attack-throughput record.  The JAX package's
`AsyncAttackTimer` times the fused step's attack from a worker thread;
it comes with the fused step.
"""
from __future__ import annotations

import csv
import os
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
