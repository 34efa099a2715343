"""Logging setup (copy of `leaf_tpu/utils/logging_utils.py`)."""
from __future__ import annotations

import logging
from typing import Optional


def setup_logging(log_file: Optional[str] = None, level=logging.INFO,
                  include_host: bool = False):
    if include_host:
        import socket
        fmt = f"%(asctime)s | {socket.gethostname()} | %(levelname)s | %(message)s"
    else:
        fmt = "%(asctime)s | %(levelname)s | %(message)s"
    formatter = logging.Formatter(fmt, datefmt="%Y-%m-%d,%H:%M:%S")

    root = logging.getLogger()
    root.setLevel(level)
    for h in list(root.handlers):
        root.removeHandler(h)
    sh = logging.StreamHandler()
    sh.setFormatter(formatter)
    root.addHandler(sh)
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(formatter)
        root.addHandler(fh)
