"""Build the package's CUDA sources with nvcc and load them with ctypes.

Every `csrc/*.cu` file is compiled into one shared library with a plain C
interface, for `sm_90a` (Hopper). The library goes into `_build/<hash>/`
beside the package (listed in `.gitignore`), keyed by a hash of the sources
and the flags, so an edited source rebuilds and an unchanged one loads at
once. The build runs at first use, never at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
LIB_NAME = "libe2eft_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources; the message carries its output."""


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError(f"nvcc not found (looked in {cuda_home}/bin and on PATH)")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def build() -> tuple[Path, float, str]:
    """Compile the sources if their hash has no library yet.

    Returns (library path, build seconds, nvcc output); 0 seconds and an
    empty log when the library was already there."""
    out_dir = BUILD_DIR / _source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, 0.0, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees a partial file
    return lib, seconds, log


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C functions' signatures."""
    lib = ctypes.CDLL(str(build()[0]))
    fn = lib.e2eft_flash_attention_fwd
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k, v, o
        ctypes.c_int,  # dtype
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B N Lq Lk D
        ctypes.c_float,  # scale
        ctypes.POINTER(ctypes.c_int64),  # 12 strides
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return lib
