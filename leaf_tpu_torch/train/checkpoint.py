"""Checkpoint save/resume (port of `leaf_tpu/train/checkpoint.py`):
atomic writes, latest-discovery, one save in flight.

Where the JAX package writes Orbax directories, a checkpoint here is a
directory `<ckpt_dir>/epoch_<N>/` that holds one `torch.save` file,
`state.pt`: a dict of tensors, numbers and nested dicts/lists of them
(the trainer saves the text tower's fp32 master `state_dict`, the
optimizer's state and the step).  The directory is written under a
temporary name and renamed into place, so a directory named `epoch_<N>`
is always whole.  `save_checkpoint` copies the payload to the host
before it returns (the trainer updates its tensors in place right
after), and writes to disk on a worker thread; the results.csv ledger is
reloaded by the caller.

Across ranks (`parallel.distributed`) the parameters are equal on every
rank, so the master alone writes; the blocking saves and
`wait_for_checkpoints` end in a barrier, and every rank reads the same
file after a barrier, as the JAX package's collective Orbax saves give.
"""
from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import torch

from leaf_tpu_torch.parallel.distributed import barrier, is_master

_EPOCH_RE = re.compile(r"^epoch_(\d+)$")
STATE_FILE = "state.pt"
LATEST_NAME = "epoch_latest"


def _to_host(node: Any) -> Any:
    """A copy of a payload whose tensors are CPU tensors that share no
    memory with the original's."""
    if isinstance(node, torch.Tensor):
        return node.detach().to("cpu", copy=True)
    if isinstance(node, dict):
        return {k: _to_host(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_to_host(v) for v in node)
    return node


def _write(path: str, payload: Dict[str, Any]) -> None:
    """Write `payload` as the checkpoint directory `path`, replacing an
    earlier one of that name."""
    tmp = f"{path}.{os.getpid()}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        torch.save(payload, os.path.join(tmp, STATE_FILE))
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


class _Writer:
    """At most one disk write in flight, on a worker thread; its failure
    is raised by the next wait."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _run(self, path: str, payload: Dict[str, Any]) -> None:
        try:
            _write(path, payload)
        except Exception as e:  # noqa: BLE001 - re-raised by wait()
            self._error = e

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError("writing a checkpoint failed") from error

    def start(self, path: str, payload: Dict[str, Any]) -> None:
        self.wait()   # one save in flight at a time
        self._thread = threading.Thread(target=self._run,
                                        args=(path, payload), daemon=True)
        self._thread.start()


_WRITER = _Writer()


def _save(ckpt_dir: str, name: str, payload: Dict[str, Any],
          wait: bool) -> str:
    """The master's write (the other ranks write nothing); with `wait`,
    every rank leaves once it is on disk."""
    path = os.path.join(os.path.abspath(ckpt_dir), name)
    if is_master():
        os.makedirs(ckpt_dir, exist_ok=True)
        _WRITER.start(path, _to_host(payload))
    if wait:
        wait_for_checkpoints()
    return path


def save_checkpoint(ckpt_dir: str, epoch: int, payload: Dict[str, Any],
                    wait: bool = False) -> None:
    """Write `payload` to <ckpt_dir>/epoch_<N>.

    The copy to the host happens before this returns (safe with tensors
    that the next step updates in place); the disk write overlaps
    training.  `wait=True` blocks until the directory is in place."""
    _save(ckpt_dir, f"epoch_{epoch}", payload, wait)


def save_named(ckpt_dir: str, name: str, payload: Dict[str, Any]) -> None:
    """One-off named sidecar checkpoint (e.g. the frozen anchor tower,
    saved once instead of inside every epoch payload).

    Blocks until written: epoch payloads rely on the sidecar existing
    (they omit the frozen tower), so a crash mid-write must not leave a
    run whose checkpoints can never resume."""
    _save(ckpt_dir, name, payload, wait=True)


def load_named(ckpt_dir: str, name: str) -> Dict[str, Any]:
    return load_checkpoint(os.path.join(os.path.abspath(ckpt_dir), name))


def save_latest(ckpt_dir: str, epoch: int, payload: Dict[str, Any]) -> None:
    """Rolling most-recent checkpoint (`--save-most-recent`): overwrite
    <ckpt_dir>/epoch_latest every epoch, with an `epoch_latest.epoch`
    sidecar for resume discovery."""
    _save(ckpt_dir, LATEST_NAME, payload, wait=True)
    # the sidecar must postdate the payload
    if is_master():
        sidecar = os.path.join(ckpt_dir, LATEST_NAME + ".epoch")
        tmp = f"{sidecar}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            f.write(str(epoch))
        os.replace(tmp, sidecar)
    barrier()


def wait_for_checkpoints() -> None:
    """Block until any save in flight is on disk (across ranks: until the
    master's is)."""
    _WRITER.wait()
    barrier()


def latest_checkpoint(ckpt_dir: str) -> Optional[Tuple[int, str]]:
    """(epoch, path) of the newest checkpoint, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for name in os.listdir(ckpt_dir):
        m = _EPOCH_RE.match(name)
        if m:
            e = int(m.group(1))
            if best is None or e > best[0]:
                best = (e, os.path.join(os.path.abspath(ckpt_dir), name))
    sidecar = os.path.join(ckpt_dir, LATEST_NAME + ".epoch")
    latest_dir = os.path.join(os.path.abspath(ckpt_dir), LATEST_NAME)
    if os.path.exists(sidecar) and os.path.isdir(latest_dir):
        with open(sidecar) as f:
            e = int(f.read().strip())
        if best is None or e > best[0]:
            best = (e, latest_dir)
    return best


def load_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    """Read a checkpoint directory written by this module (across ranks,
    every rank reads it after a barrier)."""
    barrier()
    file = os.path.join(os.path.abspath(path), STATE_FILE)
    if not os.path.exists(file):
        raise FileNotFoundError(
            f"{path!r} is not a checkpoint of this trainer (no {STATE_FILE})")
    return torch.load(file, map_location=map_location, weights_only=True)


def resolve_resume(resume: Optional[str], ckpt_dir: str
                   ) -> Optional[Tuple[int, str]]:
    """Map --resume {latest,<path>} to (epoch, path).

    An explicit path must be named epoch_<N>: a silent epoch-0
    assumption would reset start_epoch and truncate the results ledger
    on what may be a perfectly valid checkpoint."""
    if not resume:
        return None
    if resume == "latest":
        return latest_checkpoint(ckpt_dir)
    base = os.path.basename(os.path.normpath(resume))
    if base == LATEST_NAME:
        sidecar = os.path.join(
            os.path.dirname(os.path.abspath(os.path.normpath(resume))),
            LATEST_NAME + ".epoch")
        try:
            with open(sidecar) as f:
                return int(f.read().strip()), resume
        except (OSError, ValueError) as e:
            raise ValueError(
                f"--resume {resume!r} needs the {LATEST_NAME}.epoch "
                f"sidecar next to it to recover the completed-epoch "
                f"count; reading {sidecar!r} failed ({e!r})") from e
    m = _EPOCH_RE.match(base)
    if m is None:
        raise ValueError(
            f"--resume path {resume!r} is not named epoch_<N>; cannot "
            "infer the completed-epoch count (pass a checkpoint "
            "directory produced by this trainer, or 'latest')")
    return int(m.group(1)), resume
