"""ctypes binding for the native C++ BPE tokenizer (port of
`leaf_tpu/tokenizer/native_binding.py`).

`native/bpe_tokenizer.cpp` (C++17, standard library only) is host code:
the BPE encoder of lower/whitespace-cleaned ASCII text, the fused
(slot, codepoint) edit + tokenize grids of the LEAF attack, and the
word-validity masks of the constrained attack.  It is compiled with the
host compiler at first use into the git-ignored `native/build/`, to a
unique temporary name that is renamed into place, so a concurrent
process never loads a partial file.  The merge table and word lists the
library reads are extracted into the same directory.  Nothing is built
at import, and nothing is written outside `native/build/`.

A missing compiler or a failed build raises `NativeBuildError` with the
compiler's output; there is no silent change of path.  The Python
tokenizer is taken only when `LEAF_TPU_NO_NATIVE_TOKENIZER` is set (by
name) or when the input is outside the native contract (see
`bpe.CLIPTokenizer.__call__`).
"""
from __future__ import annotations

import ctypes
import functools
import gzip
import hashlib
import os
import subprocess
from typing import Optional, Sequence

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")
SOURCE = os.path.join(_NATIVE_DIR, "bpe_tokenizer.cpp")
BUILD_DIR = os.path.join(_NATIVE_DIR, "build")
LIBRARY = os.path.join(BUILD_DIR, "libbpe_tokenizer.so")
# the compiler command; tests point it at a path that does not exist
COMPILER = "g++"
COMPILE_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]
NO_NATIVE_ENV = "LEAF_TPU_NO_NATIVE_TOKENIZER"


class NativeBuildError(RuntimeError):
    """The host compiler is missing, or compiling or loading the native
    tokenizer failed."""


def disabled() -> bool:
    """Whether the Python path was asked for by name."""
    return bool(os.environ.get(NO_NATIVE_ENV))


def _write_atomic(path: str, text: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"   # unique: no race between processes
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(text)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _ensure_merges(bpe_gz_path: str) -> str:
    """Extract the merge table of a vocabulary file into the build
    directory; keyed by the source's path, so a tokenizer built with a
    custom vocabulary never gets another one's table."""
    key = hashlib.sha1(os.path.abspath(bpe_gz_path).encode()).hexdigest()[:12]
    merges = os.path.join(BUILD_DIR, f"merges_{key}.txt")
    if not os.path.exists(merges):
        with gzip.open(bpe_gz_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        os.makedirs(BUILD_DIR, exist_ok=True)
        _write_atomic(merges, "\n".join(lines[1:48894 + 1]))
    return merges


def compile_library() -> str:
    """Compile `SOURCE` into `LIBRARY` if it is missing or older than the
    source; returns the library's path."""
    if os.path.exists(LIBRARY) \
            and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE):
        return LIBRARY
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    cmd = [COMPILER, *COMPILE_FLAGS, SOURCE, "-o", tmp]
    try:
        try:
            done = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise NativeBuildError(
                f"cannot run the host compiler ({' '.join(cmd)}): {e!r}; the "
                "native tokenizer of leaf_tpu_torch is built from source at "
                f"first use (set {NO_NATIVE_ENV}=1 for the Python tokenizer)"
            ) from e
        if done.returncode != 0:
            raise NativeBuildError(
                f"{COMPILER} failed (exit {done.returncode}): "
                f"{' '.join(cmd)}\n{done.stdout}{done.stderr}")
        os.replace(tmp, LIBRARY)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return LIBRARY


def _declare(lib: ctypes.CDLL) -> None:
    i32p = ctypes.POINTER(ctypes.c_int32)
    strs = ctypes.POINTER(ctypes.c_char_p)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bpe_create.restype = p
    lib.bpe_create.argtypes = [ctypes.c_char_p]
    lib.bpe_destroy.restype = None
    lib.bpe_destroy.argtypes = [p]
    lib.bpe_encode_batch.restype = None
    lib.bpe_encode_batch.argtypes = [p, strs, i, i, i32p]
    lib.bpe_encode_one.restype = i
    lib.bpe_encode_one.argtypes = [p, ctypes.c_char_p, i32p, i]
    lib.bpe_encode_edits.restype = None
    lib.bpe_encode_edits.argtypes = [p, strs, i, i32p, i32p, i, i, i, i32p]
    lib.wc_create.restype = p
    lib.wc_create.argtypes = [ctypes.c_char_p]
    lib.wc_destroy.restype = None
    lib.wc_destroy.argtypes = [p]
    lib.wc_valid_edits.restype = None
    lib.wc_valid_edits.argtypes = [p, strs, i, i32p, i32p, i, i,
                                   ctypes.POINTER(ctypes.c_uint8)]


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded native library, built first if missing or stale."""
    path = compile_library()
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        raise NativeBuildError(f"cannot load {path}: {e!r}") from e
    _declare(lib)
    return lib


def _c_strings(texts: Sequence[str]):
    return (ctypes.c_char_p * len(texts))(*[t.encode("utf-8") for t in texts])


def _i32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _edit_grids(sentences, zs, cps):
    """Validated C-contiguous int32 [B, rho] grids of slots and codepoints."""
    zs32 = np.ascontiguousarray(zs, dtype=np.int32)
    cps32 = np.ascontiguousarray(cps, dtype=np.int32)
    if zs32.ndim != 2 or zs32.shape != cps32.shape \
            or zs32.shape[0] != len(sentences):
        raise ValueError(f"edit grids {zs32.shape} and {cps32.shape} for "
                         f"{len(sentences)} sentences")
    return zs32, cps32


class NativeBPE:
    """The native tokenizer for one vocabulary file."""

    def __init__(self, lib: ctypes.CDLL, handle: int):
        self._lib = lib
        self._h = handle

    @classmethod
    def create(cls, bpe_gz_path: str) -> "NativeBPE":
        lib = library()
        merges = _ensure_merges(bpe_gz_path)
        h = lib.bpe_create(merges.encode())
        if not h:
            raise NativeBuildError(f"bpe_create could not read {merges}")
        return cls(lib, h)

    def encode_batch(self, texts: Sequence[str], context_length: int
                     ) -> np.ndarray:
        n = len(texts)
        out = np.zeros((n, context_length), dtype=np.int32)
        arr = _c_strings(texts)
        self._lib.bpe_encode_batch(self._h, arr, n, context_length, _i32(out))
        return out

    def encode_edits(self, sentences: Sequence[str], zs: np.ndarray,
                     cps: np.ndarray, context_length: int,
                     alternative: int = -1) -> np.ndarray:
        """Fused k=1 edit + tokenize: sentences [B], zs/cps [B, rho] ->
        tokens [B*rho, ctx] (see bpe_tokenizer.cpp::bpe_encode_edits)."""
        zs32, cps32 = _edit_grids(sentences, zs, cps)
        B, rho = zs32.shape
        out = np.zeros((B * rho, context_length), dtype=np.int32)
        arr = _c_strings(sentences)
        self._lib.bpe_encode_edits(self._h, arr, B, _i32(zs32), _i32(cps32),
                                   rho, alternative, context_length, _i32(out))
        return out

    def encode(self, text: str) -> list:
        cap = 1024
        buf = (ctypes.c_int32 * cap)()
        n = self._lib.bpe_encode_one(self._h, text.encode("utf-8"), buf, cap)
        return list(buf[:min(n, cap)])

    def __del__(self):  # pragma: no cover
        try:
            self._lib.bpe_destroy(self._h)
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass


_create_cached = functools.lru_cache(maxsize=None)(NativeBPE.create)


def get_native(bpe_gz_path: str) -> Optional[NativeBPE]:
    """The native tokenizer of a vocabulary file (one per file and
    process), or None when `LEAF_TPU_NO_NATIVE_TOKENIZER` asks for the
    Python path."""
    if disabled():
        return None
    return _create_cached(bpe_gz_path)


class NativeWordDict:
    """Native distinct-dictionary-word validity checker for the
    constrained attack (see bpe_tokenizer.cpp::wc_valid_edits)."""

    def __init__(self, lib: ctypes.CDLL, handle: int):
        self._lib = lib
        self._h = handle

    @classmethod
    def create(cls, words) -> Optional["NativeWordDict"]:
        if disabled():
            return None
        lib = library()
        ascii_words = sorted(w for w in words if w.isascii())
        digest = hashlib.sha256(
            "\n".join(ascii_words).encode()).hexdigest()[:16]
        path = os.path.join(BUILD_DIR, f"words_{digest}.txt")
        if not os.path.exists(path):
            _write_atomic(path, "\n".join(ascii_words))
        h = lib.wc_create(path.encode())
        if not h:
            raise NativeBuildError(f"wc_create could not read {path}")
        return cls(lib, h)

    def valid_edits(self, sentences: Sequence[str], zs: np.ndarray,
                    cps: np.ndarray, alternative: int = -1) -> np.ndarray:
        """sentences [B], zs/cps [B, rho] -> bool mask [B, rho]: True iff
        the edit strictly decreases the distinct-dictionary-word count."""
        zs32, cps32 = _edit_grids(sentences, zs, cps)
        B, rho = zs32.shape
        out = np.zeros((B * rho,), dtype=np.uint8)
        arr = _c_strings(sentences)
        self._lib.wc_valid_edits(
            self._h, arr, B, _i32(zs32), _i32(cps32), rho, alternative,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return out.reshape(B, rho).astype(bool)

    def __del__(self):  # pragma: no cover
        try:
            self._lib.wc_destroy(self._h)
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass
