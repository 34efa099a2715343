"""Run-directory mirroring and codebase snapshots (port of
`leaf_tpu/utils/file_utils.py`).

`--remote-sync <dir or scheme://...>` copies the run directory there:
once before training (a failure is fatal), then every
`--remote-sync-frequency` seconds from a daemon thread, and once more at
the end.  A `scheme://` target goes through `fsspec` (imported only
then); a plain path is mirrored with `shutil`, copying files that are new
or newer.  `--copy-codebase` snapshots the `leaf_tpu_torch` package into
`<run>/code/`.
"""
from __future__ import annotations

import logging
import os
import shutil
import threading
from typing import Optional

LOG = logging.getLogger(__name__)


def remote_sync(local_dir: str, remote_dir: str,
                protocol: str = "fsspec") -> bool:
    """One sync pass of `local_dir` into `remote_dir`; returns success."""
    try:
        if protocol == "fsspec" and "://" in remote_dir:
            import fsspec
            fs, _, _ = fsspec.get_fs_token_paths(remote_dir)
            # a trailing slash copies the contents into remote_dir (fsspec
            # cp semantics); without it the directory nests one level deep
            fs.put(local_dir.rstrip("/") + "/", remote_dir, recursive=True)
        else:
            os.makedirs(remote_dir, exist_ok=True)
            for root, _, files in os.walk(local_dir):
                dst_root = os.path.join(remote_dir,
                                        os.path.relpath(root, local_dir))
                os.makedirs(dst_root, exist_ok=True)
                for f in files:
                    src, dst = os.path.join(root, f), os.path.join(dst_root, f)
                    if (not os.path.exists(dst)
                            or os.path.getmtime(src) > os.path.getmtime(dst)):
                        shutil.copy2(src, dst)
        return True
    except Exception as e:  # noqa: BLE001
        LOG.warning("remote sync failed: %r", e)
        return False


class SyncThread:
    """Periodic background sync of a run directory."""

    def __init__(self, local_dir: str, remote_dir: str,
                 frequency_s: float = 300.0, protocol: str = "fsspec"):
        self.local_dir = local_dir
        self.remote_dir = remote_dir
        self.frequency_s = frequency_s
        self.protocol = protocol
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "SyncThread":
        def loop():
            while not self._stop.wait(self.frequency_s):
                remote_sync(self.local_dir, self.remote_dir, self.protocol)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self, final_sync: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if final_sync:
            remote_sync(self.local_dir, self.remote_dir, self.protocol)


def start_run_mirror(args, out_dir: str, run_name: str
                     ) -> Optional[SyncThread]:
    """With `--remote-sync`: one sync pass of `out_dir` into
    `<remote-sync>/<run_name>` (a failure raises), then the background
    thread, returned for the caller to stop with a final sync.  None
    without the flag."""
    if not getattr(args, "remote_sync", None):
        return None
    remote_run = os.path.join(args.remote_sync, run_name)
    if not remote_sync(out_dir, remote_run, args.remote_sync_protocol):
        raise RuntimeError(
            f"remote sync to {remote_run} failed; fix the target before "
            "training (reference exits likewise)")
    LOG.info("remote sync successful: %s", remote_run)
    return SyncThread(out_dir, remote_run,
                      frequency_s=args.remote_sync_frequency,
                      protocol=args.remote_sync_protocol).start()


def copy_codebase(out_dir: str) -> None:
    """Snapshot the `leaf_tpu_torch` package into `<out_dir>/code`; an
    existing snapshot raises `FileExistsError`."""
    import leaf_tpu_torch
    code_dir = os.path.join(out_dir, "code")
    if os.path.exists(code_dir):
        raise FileExistsError(
            f"experiment code snapshot already exists at {code_dir}; "
            "use --name to start a new experiment")
    src = os.path.dirname(os.path.abspath(leaf_tpu_torch.__file__))
    shutil.copytree(src, os.path.join(code_dir, "leaf_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__", "*.so",
                                                  "build", "logs", "wandb"))
    LOG.info("copied codebase to %s", code_dir)
