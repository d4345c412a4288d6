"""Build the package's CUDA sources with nvcc and load them with ctypes.

Every `csrc/*.cu` file is compiled for `sm_90a` (Hopper: `wgmma` needs the
`a`), one `nvcc` per
source, all started together, and the objects are linked into one shared
library with a plain C interface. The library goes into `_build/<hash>/`
beside the package (listed in `.gitignore`), keyed by a hash of the sources,
the headers and the flags, so an edited source rebuilds and an unchanged one
loads at once. The build runs at first use, never at import time. `launch`
calls an entry point on a tensor's device and stream and counts the launch:
every kernel of the port launches through it, so it keeps its host path
short (the entry point looked up once, no device guard on the current
device, the raw stream handle).
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
from typing import Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
LIB_NAME = "libe2eft_kernels.so"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # the `dtype` argument of the C entry points
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xptxas", "-v",
    "-Xcompiler", "-fPIC",
)


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources; the message carries its output."""


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _headers() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError(f"nvcc not found (looked in {cuda_home}/bin and on PATH)")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + _headers():
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
    nvcc, pid = _nvcc(), os.getpid()
    t0 = time.perf_counter()
    objs = [out_dir / f"{src.stem}.{pid}.o" for src in sources()]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(sources(), objs)]
    tmp = out_dir / f"{LIB_NAME}.{pid}.tmp"
    cmds.append([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)])
    try:
        # every compile at once, each waited for before any failure is raised
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for c in cmds[:-1]]
        results = [(c, p.communicate()[0], p.returncode) for c, p in zip(cmds, procs)]
        if all(rc == 0 for _, _, rc in results):
            link = subprocess.run(cmds[-1], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            results.append((cmds[-1], link.stdout, link.returncode))
        for cmd, log, rc in results:
            if rc != 0:
                tmp.unlink(missing_ok=True)
                raise KernelBuildError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{log}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees a partial file
    return lib, time.perf_counter() - t0, "".join(log for _, log, _ in results)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C functions' signatures (each
    ends with the stream)."""
    lib = ctypes.CDLL(str(build()[0]))
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    flash = [i32] * 6 + [f32, ctypes.POINTER(ctypes.c_int64), ptr]  # dtype B N Lq Lk D, scale, strides, stream
    signatures = {
        "e2eft_flash_attention_fwd": [ptr] * 5 + flash,  # q, k, v, o, lse (null: no lse)
        # q, k, v, o, dtype B N Lq Lk D hp, scale, strides, stream
        "e2eft_flash_attention_fwd_mh": [ptr] * 4 + [i32] * 7 + flash[6:],
        "e2eft_flash_attention_bwd_dq": [ptr] * 7 + flash,  # q, k, v, dO, lse, delta, dq
        "e2eft_flash_attention_bwd_dkv": [ptr] * 8 + flash,  # q, k, v, dO, lse, delta, dk, dv
        "e2eft_gn_channel_stats": [ptr, ptr, i32, i32, i32, i64, ptr],  # x, out, dtype, B, C, n
        # x, stats, w, b, out, dtype, affine dtype, B, C, n, groups, eps, silu
        "e2eft_gn_apply": [ptr] * 5 + [i32, i32, i32, i32, i64, i32, f32, i32, ptr],
        # x, w, b, out, stats (null where one launch takes the GroupNorm), dtype, affine dtype, B, C, n, groups,
        # eps, silu
        "e2eft_group_norm": [ptr] * 5 + [i32, i32, i32, i32, i64, i32, f32, i32, ptr],
        # x, stats, gn weight, gn bias, w, bias, out, dtype, silu, B, C, Cout, H, W, groups, eps
        "e2eft_gn_silu_conv3x3": [ptr] * 7 + [i32] * 8 + [f32, ptr],
        # x, gn weight, gn bias, w, bias, out, stats, parts, dtype, silu, B, C, Cout, H, W, groups, eps
        "e2eft_gn_silu_conv3x3_v2": [ptr] * 7 + [i32] * 9 + [f32, ptr],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def entry_point(name: str):
    """The library's C function `e2eft_<name>`, looked up once."""
    return getattr(load_library(), "e2eft_" + name)


def launch(counts: dict, name, t: torch.Tensor, *args, entry: Optional[str] = None) -> None:
    """Call the C entry point `e2eft_<entry or name>` on t's device and current
    stream; raise if the launch failed, add one to `counts[n]` for each kernel
    name n in `name` (a name, or a tuple of the names of the kernels that the
    one call launched) if not. The device guard is taken only when t is not on
    the current device, and the stream goes to C as its raw handle."""
    fn = entry_point(entry or name)
    index = t.get_device()
    if index == torch._C._cuda_getDevice():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (code {err}) at {tuple(t.shape)} {t.dtype}")
    if isinstance(name, str):
        counts[name] += 1
    else:
        for n in name:
            counts[n] += 1
