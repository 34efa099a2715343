"""Build and load the port's CUDA kernels.

`library()` compiles every `csrc/*.cu` with nvcc (one compiler process
per source, all started together) and links the objects into one shared
library with a plain C interface, under the git-ignored `build/`
directory next to this file, and loads it with `ctypes`.  It builds at
first use, and again when a source is newer than the library; the
compiler writes to unique temporary names and the library is renamed
into place, so a concurrent process never loads a partial file.  Nothing
is built at import.

The library links the CUDA runtime only (nvcc's default), not libcuda:
the one CUDA driver-API call the kernels need, `cuTensorMapEncodeTiled`
for the GEMM's TMA maps, is looked up at run time with
`cudaGetDriverEntryPoint` (`csrc/fused_block.cu`), so the link line has no
`-lcuda`.

There is no fallback: a missing nvcc or a failed build raises, with the
compiler's output in the message.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import os
import shutil
import subprocess

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
LIBRARY = os.path.join(BUILD_DIR, "libleaf_kernels.so")
# where the CUDA toolkit installs by default, tried after $CUDA_HOME and PATH
DEFAULT_CUDA_HOME = "/usr/local/cuda"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-c"]
LINK_FLAGS = [*ARCH_FLAGS, "-shared"]


class KernelBuildError(RuntimeError):
    """nvcc is missing, or compiling the kernels failed."""


def find_nvcc() -> str:
    """Path of nvcc: `$CUDA_HOME/bin`, then PATH, then the default
    toolkit location."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append(os.path.join(DEFAULT_CUDA_HOME, "bin", "nvcc"))
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        f"{DEFAULT_CUDA_HOME}/bin): the CUDA kernels of leaf_tpu_torch are "
        "built from source at first use and need the CUDA toolkit")


def sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _stale() -> bool:
    if not os.path.exists(LIBRARY):
        return True
    inputs = sources() + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    return max(os.path.getmtime(p) for p in inputs) > os.path.getmtime(LIBRARY)


def compile_library() -> str:
    """Compile `csrc/*.cu` into `LIBRARY`; returns nvcc's report
    (registers, shared memory and spills of every kernel)."""
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objects = [os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
               for src in sources()]
    tmp = f"{LIBRARY}.{tag}"
    commands = [[nvcc, *COMPILE_FLAGS, "-o", obj, src]
                for src, obj in zip(sources(), objects)]
    report = []
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in commands]
        outputs = [proc.communicate()[0] for proc in procs]
        for cmd, proc, output in zip(commands, procs, outputs):
            if proc.returncode != 0:
                raise KernelBuildError(
                    f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
                    f"{output}")
            report.append(output)
        link = [nvcc, *LINK_FLAGS, "-o", tmp, *objects]
        linked = subprocess.run(link, capture_output=True, text=True)
        if linked.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed (exit {linked.returncode}): {' '.join(link)}\n"
                f"{linked.stdout}{linked.stderr}")
        os.replace(tmp, LIBRARY)
    finally:
        for path in (*objects, tmp):
            if os.path.exists(path):
                os.remove(path)
    return "".join(report)


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # every launcher ends in (device index, cudaStream_t) and returns a
    # cudaError_t
    lib.leaf_packed_attention.argtypes = [p, p, i, i, i, i, i, i, i, f, i, p]
    lib.leaf_packed_attention.restype = i
    lib.leaf_layer_norm.argtypes = [p, p, p, p, i, i, i, f, i, p]
    lib.leaf_layer_norm.restype = i
    lib.leaf_gemm_bias.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.leaf_gemm_bias.restype = i
    # the same with the bf16 tile width (256, 192, 128; 0: picked) before
    # the device index
    lib.leaf_gemm_bias_tile.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.leaf_gemm_bias_tile.restype = i
    # x, LN scale and bias, qkv_w, qkv_b, out_w, out_b, then the scratch h,
    # qkv, attn and the output; dtype, R, L, D, heads, group_len, causal,
    # LN eps, attention scale
    lib.leaf_fused_block.argtypes = [p] * 11 + [i] * 7 + [f, f, i, p]
    lib.leaf_fused_block.restype = i
    lib.leaf_flash_attention.argtypes = [
        p, p, p, p, ctypes.POINTER(ctypes.c_longlong), i, i, i, i, i, i, f, i, p]
    lib.leaf_flash_attention.restype = i
    ints = ctypes.POINTER(ctypes.c_int)
    lib.leaf_attention_schedule.argtypes = [i, i, i, i, ints, ints, i]
    lib.leaf_attention_schedule.restype = i
    lib.leaf_error_string.argtypes = [i]
    lib.leaf_error_string.restype = ctypes.c_char_p


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale."""
    if _stale():
        compile_library()
    lib = ctypes.CDLL(LIBRARY)
    _declare(lib)
    return lib


def check(code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = library().leaf_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
