"""Code-shape sweep of the bf16 one-launch GroupNorm kernel on one GPU.

    python3 perf/torch_gn_group_variants.py [--out output/torch_gn_group_variants.json]

`csrc/groupnorm.cu::gn_group_kernel` holds a (b, g) slab's share in shared
memory, then sums it, folds the group and applies the affine and the SiLU
to it from there. At the VAE's 96x96 to 384x384 GroupNorms a block's share
is up to 147 KB, one block an SM, so how many warps a block has and how many
independent vectors each thread keeps in flight decide how far the card
hides the latency of its shared-memory reads and of the SiLU's arithmetic.
This script builds the sources as they are, then once for each variant below
with the lines it names rewritten (in a copy of `csrc/` under
`output/gn_group_variants/`), and times `groupnorm.group_norm_kernel` in
bf16 (bf16 affine, the SiLU on, as serving runs it) at every shape where a
Marigold 768x768 request takes the one-launch kernel: CUDA events around 20
calls back to back (`chip_smoke.batch_ms`, which the host's time a call
bounds from below at the small shapes) and the kernel's own device time
(torch.profiler, 20 calls; its sums have been seen to move between runs more
than the events do); with their sums over the request's visits, the
registers `ptxas` reports, and max |d| / max |source| against the sources'
own output (a variant with another thread count adds the sums in another
order). The rows go to `--out` as JSON. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

import chip_smoke
from diffusion_e2e_ft_tpu_torch.kernels import _build
from diffusion_e2e_ft_tpu_torch.kernels import groupnorm as gn

THREADS = "constexpr int kGroupThreads = 1024;"
LOOP = "  for (int i = threadIdx.x; i < share; i += kGroupThreads) {"
# variant -> edits (old, new, occurrences) of the source
VARIANTS = {
    "threads-512": [(THREADS, THREADS.replace("1024", "512"), 1)],
    "unroll-4": [(LOOP, "#pragma unroll 4\n" + LOOP, 2)],
}


def rewrite(src: str, edits: list) -> str:
    for old, new, count in edits:
        if src.count(old) != count:
            raise ValueError(f"the source has not {count} of {old[:60]!r}")
        src = src.replace(old, new)
    return src


def ptxas_registers(log: str) -> dict:
    """silu -> registers of the bf16 x, bf16 affine one-launch kernels."""
    usage, lines = {}, log.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"gn_group_kernelI13__nv_bfloat16S1_Lb(\d)E", line)
        if "Compiling entry function" in line and m:
            regs = re.search(r"Used (\d+) registers", " ".join(lines[i + 1:i + 4]))
            usage[bool(int(m.group(1)))] = int(regs.group(1))
    return usage


def use_sources(csrc, build_dir) -> str:
    """Point the build at `csrc` (built into `build_dir`), build and load; the nvcc log."""
    _build.CSRC_DIR, _build.BUILD_DIR = csrc, build_dir
    _build.build.cache_clear()
    _build.load_library.cache_clear()
    _build.entry_point.cache_clear()
    log = _build.build()[2]
    _build.load_library()
    return log


def device_ms(fn, reps: int = 20) -> float:
    """The kernels' device time a call (torch.profiler over `reps` calls)."""
    return sum(e.device_time for e in chip_smoke.device_kernels(fn, reps)) / reps / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="output/torch_gn_group_variants.json", help="the rows, as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_gn_group_variants: needs a CUDA device")
    print(chip_smoke.card_line(), flush=True)
    path = next(p for p in chip_smoke.route_paths() if p[0] == chip_smoke.ROUTE_TIMED)
    shapes = {s: n for s, n in chip_smoke.route_visits(path).items() if gn.group_fits(s, torch.bfloat16, 32)}
    original, src = _build.CSRC_DIR, (_build.CSRC_DIR / "groupnorm.cu").read_text()
    root = _build.PACKAGE_DIR.parent / "output" / "gn_group_variants"
    shutil.rmtree(root, ignore_errors=True)
    gen = torch.Generator(device="cuda").manual_seed(17)
    inputs = {}
    for shape in shapes:
        x = (torch.randn(shape, device="cuda", generator=gen) + 0.5).bfloat16()
        w = (torch.randn(shape[1], device="cuda", generator=gen) * 0.2 + 1.0).bfloat16()
        inputs[shape] = (x, w, (torch.randn(shape[1], device="cuda", generator=gen) * 0.5).bfloat16(), 32, 1e-6)
    rows, want = [], {}
    for name, edits in {"source": [], **VARIANTS}.items():
        csrc = root / name / "csrc"
        shutil.copytree(original, csrc)
        (csrc / "groupnorm.cu").write_text(rewrite(src, edits))
        registers = ptxas_registers(use_sources(csrc, root / name / "_build"))
        total = {"ms": 0.0, "device_ms": 0.0}
        for shape, visits in sorted(shapes.items(), key=lambda kv: -kv[0][1] * kv[0][2] * kv[0][3]):
            a = inputs[shape]
            out = gn.group_norm_kernel(*a)
            want.setdefault(shape, out.float())
            diff = chip_smoke.rel_err(out, want[shape])[1]
            row = {"variant": name, "shape": list(shape), "visits": visits,
                   "ms": chip_smoke.batch_ms(lambda: gn.group_norm_kernel(*a)),
                   "device_ms": device_ms(lambda: gn.group_norm_kernel(*a)), "vs_source": diff,
                   "registers": {str(k): v for k, v in registers.items()}}
            for k in total:
                total[k] += visits * row[k]
            rows.append(row)
            print(f"[{name}] {list(shape)} x{visits}: back to back {row['ms']:.4f} ms, device {row['device_ms']:.4f} "
                  f"ms, max|d|/max|source| {diff:.1e}", flush=True)
        print(f"[{name}] registers by SiLU {registers}; the request's {sum(shapes.values())} one-launch GroupNorms: "
              f"back to back {total['ms']:.3f} ms, device {total['device_ms']:.3f} ms", flush=True)
    use_sources(original, _build.PACKAGE_DIR / "_build")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"rows: {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
