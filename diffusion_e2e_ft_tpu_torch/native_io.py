"""ctypes binding of the native IO library, `native/e2eft_io.cc` (libpng and
libjpeg decode, a fused 16-bit-PNG -> float32 depth decode).

The port's own copy of `diffusion_e2e_ft_tpu/native_io.py`'s binding, over
the same C entry points. The library is built at first use, never at
import: `g++ -O3 -shared ... -lpng -ljpeg -lz` into
`diffusion_e2e_ft_tpu_torch/_build/native/<hash>/`, keyed by a hash of the
source and the flags (as `kernels/_build.py` does for the CUDA sources).
`native/` itself is only read. Where g++ or the libpng / libjpeg headers are
missing, `available()` is False and `build_error()` holds g++'s last line;
`data/image_io.py` then decodes PNG in numpy and raises for JPEG.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent
SOURCE = PACKAGE_DIR.parent / "native" / "e2eft_io.cc"
BUILD_DIR = PACKAGE_DIR / "_build" / "native"
LIB_NAME = "libe2eft_io.so"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
LIBS = ("-lpng", "-ljpeg", "-lz")


class NativeBuildError(RuntimeError):
    """g++ is missing or refused the source; the message carries its output."""


def _build() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    out_dir = BUILD_DIR / h.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=300)
    except (FileNotFoundError, subprocess.TimeoutExpired) as e:
        raise NativeBuildError(f"{cmd[0]}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(proc.stdout)
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees a partial file
    return lib


@functools.lru_cache(maxsize=None)
def _load() -> tuple[Optional[ctypes.CDLL], Optional[str]]:
    """(library, None) once built and loaded, else (None, g++'s last line)."""
    try:
        lib = ctypes.CDLL(str(_build()))
    except (NativeBuildError, OSError) as e:
        lines = [line for line in str(e).splitlines() if line.strip()]
        return None, lines[-1] if lines else type(e).__name__
    u8p, i32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32)
    signatures = {
        "png_probe": [u8p, ctypes.c_size_t, i32p, i32p, i32p, i32p],
        "png_decode": [u8p, ctypes.c_size_t, u8p, ctypes.c_size_t],
        "png16_to_depth_f32": [u8p, ctypes.c_size_t, ctypes.c_float, ctypes.POINTER(ctypes.c_float), ctypes.c_size_t],
        "jpeg_probe": [u8p, ctypes.c_size_t, i32p, i32p, i32p],
        "jpeg_decode_rgb": [u8p, ctypes.c_size_t, u8p, ctypes.c_size_t],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, None


def available() -> bool:
    """Build (first call) and load the library; False where that failed."""
    return _load()[0] is not None


def build_error() -> Optional[str]:
    """The last line of the failed build's output, or None."""
    return _load()[1]


def _lib() -> ctypes.CDLL:
    lib, err = _load()
    if lib is None:
        raise NativeBuildError(f"native IO library did not build: {err}")
    return lib


def _u8p(buf: bytes):
    return ctypes.cast(ctypes.c_char_p(buf), ctypes.POINTER(ctypes.c_uint8))


def _probe_png(lib, buf: bytes) -> tuple:
    h, w, c, depth = (ctypes.c_int32() for _ in range(4))
    rc = lib.png_probe(_u8p(buf), len(buf), h, w, c, depth)
    if rc != 0:
        raise ValueError(f"png_probe failed: {rc}")
    return h.value, w.value, c.value, depth.value


def decode_png(buf: bytes) -> np.ndarray:
    """PNG bytes -> numpy array [H, W] or [H, W, C], uint8 or uint16."""
    lib = _lib()
    h, w, c, depth = _probe_png(lib, buf)
    out = np.empty((h, w) if c == 1 else (h, w, c), np.uint16 if depth == 16 else np.uint8)
    rc = lib.png_decode(_u8p(buf), len(buf), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.nbytes)
    if rc != 0:
        raise ValueError(f"png_decode failed: {rc}")
    return out


def decode_png16_depth(buf: bytes, scale: float) -> np.ndarray:
    """16-bit grayscale PNG -> float32 depth / scale (fused native path)."""
    lib = _lib()
    h, w, _, _ = _probe_png(lib, buf)
    out = np.empty((h, w), np.float32)
    rc = lib.png16_to_depth_f32(
        _u8p(buf), len(buf), ctypes.c_float(scale), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size
    )
    if rc != 0:
        raise ValueError(f"png16_to_depth_f32 failed: {rc}")
    return out


def decode_jpeg(buf: bytes) -> np.ndarray:
    """JPEG bytes -> uint8 RGB [H, W, 3]."""
    lib = _lib()
    h, w, c = (ctypes.c_int32() for _ in range(3))
    rc = lib.jpeg_probe(_u8p(buf), len(buf), h, w, c)
    if rc != 0:
        raise ValueError(f"jpeg_probe failed: {rc}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.jpeg_decode_rgb(_u8p(buf), len(buf), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.nbytes)
    if rc != 0:
        raise ValueError(f"jpeg_decode_rgb failed: {rc}")
    return out
