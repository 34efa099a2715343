"""Reader and writer of the safetensors file format, on the standard
library, numpy and torch.

A file is: 8 bytes, the little-endian length N of the header; N bytes of
JSON, mapping every tensor name to `{"dtype", "shape", "data_offsets":
[begin, end]}` (offsets into the data section that follows the header)
plus an optional `"__metadata__"` map of strings; then the raw
little-endian buffers, back to back, C order.

Dtypes: F64, F32, F16, BF16, I64, I32, I16, I8, U8 and BOOL.  numpy has
no bfloat16, so files are read into and written from torch tensors.
"""
from __future__ import annotations

import json
import os
import struct
import sys
from typing import Dict, Mapping, Optional

import numpy as np
import torch

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {dtype: name for name, dtype in _DTYPES.items()}
# a header larger than this is a corrupt or hostile file (the format's own
# implementations cap it at 100 MB)
_MAX_HEADER = 100 * 1024 * 1024


def _as_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().contiguous()
    return torch.from_numpy(np.ascontiguousarray(value))


def save_file(tensors: Mapping[str, object], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write `tensors` (torch tensors or numpy arrays, made contiguous
    here) to `path`, under a temporary name that is renamed into place."""
    if sys.byteorder != "little":
        raise RuntimeError("safetensors buffers are little-endian; this "
                           "writer does not byte-swap")
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    buffers = []
    offset = 0
    # the format's own writer orders by dtype alignment, then name; any
    # order is valid, and sorting by name keeps files reproducible
    for name in sorted(tensors):
        t = _as_tensor(tensors[name])
        if t.dtype not in _NAMES:
            raise TypeError(f"{name}: dtype {t.dtype} has no safetensors name")
        # reinterpret as bytes (bfloat16 has no numpy dtype)
        raw = (t.reshape(-1).view(torch.uint8).numpy().tobytes()
               if t.numel() else b"")
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        buffers.append(raw)
        offset += len(raw)
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)      # data section aligned to 8 bytes
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(struct.pack("<Q", len(blob)))
            f.write(blob)
            for raw in buffers:
                f.write(raw)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Read every tensor of a safetensors file, in its stored dtype."""
    if sys.byteorder != "little":
        raise RuntimeError("safetensors buffers are little-endian; this "
                           "reader does not byte-swap")
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: too short for a safetensors header")
        (n,) = struct.unpack("<Q", head)
        if n > _MAX_HEADER:
            raise ValueError(f"{path}: header length {n} is not credible")
        blob = f.read(n)
        if len(blob) != n:
            raise ValueError(f"{path}: header cut short")
        header = json.loads(blob.decode("utf-8"))
        data = f.read()
    out: Dict[str, torch.Tensor] = {}
    for name, entry in header.items():
        if name == "__metadata__":
            continue
        dtype = _DTYPES.get(entry["dtype"])
        if dtype is None:
            raise TypeError(f"{path}: {name} has unsupported dtype "
                            f"{entry['dtype']!r}")
        shape = [int(s) for s in entry["shape"]]
        begin, end = (int(o) for o in entry["data_offsets"])
        count = int(np.prod(shape, dtype=np.int64))
        size = torch.empty((), dtype=dtype).element_size()
        if not 0 <= begin <= end <= len(data) or end - begin != count * size:
            raise ValueError(f"{path}: {name} has offsets {begin}:{end} for "
                             f"shape {shape} {entry['dtype']}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        # a copy, so that the tensor owns writable memory
        raw = torch.from_numpy(np.frombuffer(data, np.uint8, end - begin,
                                             begin).copy())
        out[name] = raw.view(dtype).reshape(shape)
    return out
