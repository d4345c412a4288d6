"""Code-shape sweep of the bf16 v2 GroupNorm+SiLU -> conv3x3 kernel on one GPU.

    python3 perf/torch_gn_v2_variants.py [--out output/torch_gn_v2_variants.json]

`csrc/gn_conv.cu`'s v2 kernel runs its statistics phase (`v2_stats`), a
fold at each image (`fold_parts`) and v1's wgmma body over a walk of tiles,
in one kernel held at 255 registers a thread; how `ptxas` allocates them,
and whether the body then spills, depends on the shape of the code around
it. The variants: the statistics phase without its closing block barrier,
as a call of its own (not inlined), or one block an item instead of one
warp; the fold straight from L2 without the shared scratch. This script
builds the sources as they are, then once for each variant below with the
lines it names rewritten (in a copy of `csrc/` under
`output/gn_v2_variants/`), and times the v2 kernel alone
(`chip_smoke.batch_ms`: CUDA events around 20 launches back to back) at the
8 GroupNorm -> conv shapes of the 480x640 bs-2 train step, and v1's conv
kernel alone the same way as the yardstick. For each it prints the time, the
registers and spill bytes `ptxas` reports for the bf16 v2 kernels (with and
without SiLU) and max |d| / max |source| against the sources' own output
(the statistics' summation order may differ). The rows go to `--out` as
JSON. Imports no JAX.
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
from diffusion_e2e_ft_tpu_torch.kernels import gn_conv as gc
from diffusion_e2e_ft_tpu_torch.kernels import groupnorm as gn

SHAPES = {(2, 128, 480, 640, 128): 9, (2, 256, 480, 640, 128): 1, (2, 128, 240, 320, 256): 1,
          (2, 256, 240, 320, 256): 8, (2, 512, 240, 320, 256): 1, (2, 256, 120, 160, 512): 1,
          (2, 512, 120, 160, 512): 9, (2, 512, 60, 80, 512): 18}  # -> launches a train step
STATS = "__device__ __forceinline__ void v2_stats("
SYNC = """    }
  }
  __syncthreads();
}"""
WARP_BODY = """  const int lane = threadIdx.x % 32;
  for (int r = blockIdx.x * kV2Warps + threadIdx.x / 32; r < rows * parts; r += gridDim.x * kV2Warps) {
    const int row = r / parts, part = r % parts;  // row = b * C + c
    float s = 0.f, ss = 0.f;
    segment_partial<T, 32, kV2StatsUnroll>(x + static_cast<int64_t>(row) * HW, HW, part, parts, lane, s, ss);
    warp_sums(s, ss);
    if (lane == 0) {"""
# the same items, each reduced by the whole block (`segment_stats`: two block barriers an item)
BLOCK_BODY = """  __shared__ float red[2 * kV2Warps];
  for (int r = blockIdx.x; r < rows * parts; r += gridDim.x) {
    const int row = r / parts, part = r % parts;  // row = b * C + c
    float s, ss;
    segment_stats<T, THREADS, kV2StatsUnroll>(x + static_cast<int64_t>(row) * HW, HW, part, parts, red, &s, &ss);
    if (threadIdx.x == 0) {"""
# the fold straight from L2, each channel's group summed part by part (no shared scratch)
FOLD_DIRECT = """template <int THREADS>
__device__ void fold_direct(const float* st, const float* __restrict__ gn_w, const float* __restrict__ gn_b, int C,
                            int groups, int64_t hw, float eps, float* sa, float* sb, float scale, int parts, float*) {
  const int gs = C / groups;
  const float count = static_cast<float>(hw * gs);
  const float* sq = st + static_cast<int64_t>(C) * parts;
  for (int c = threadIdx.x; c < C; c += THREADS) {
    const int g0 = c / gs * gs;
    float gsum = 0.f, gsq = 0.f;
    for (int j = 0; j < gs; ++j) {
      float cs = 0.f, csq = 0.f;
      for (int q = 0; q < parts; ++q) {
        cs += __ldcg(st + (g0 + j) * parts + q);
        csq += __ldcg(sq + (g0 + j) * parts + q);
      }
      gsum += cs;
      gsq += csq;
    }
    fold_channel(gsum, gsq, count, eps, gn_w[c], gn_b[c], scale, sa + c, sb + c);
  }
  __syncthreads();
}

"""
# variant -> edits (old, new, occurrences) of the source
VARIANTS = {
    "no-sync": [(SYNC, SYNC.replace("\n  __syncthreads();", ""), 1)],
    "noinline": [(STATS, STATS.replace("__forceinline__", "__noinline__"), 1)],
    "block": [(WARP_BODY, BLOCK_BODY, 1)],
    "fold-direct": [("// v2's phase 1:", FOLD_DIRECT + "// v2's phase 1:", 1),
                    ("fold_parts<THREADS>(", "fold_direct<THREADS>(", 2)],
}


def rewrite(src: str, edits: list) -> str:
    for old, new, count in edits:
        if src.count(old) != count:
            raise ValueError(f"the source has not {count} of {old[:60]!r}")
        src = src.replace(old, new)
    return src


def ptxas_usage(log: str) -> dict:
    """silu -> (registers, spill store bytes) of the bf16 v2 kernels."""
    usage, lines = {}, log.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"gn_conv_v2_kernelI13__nv_bfloat16Lb(\d)E", line)
        if "Compiling entry function" in line and m:
            rest = " ".join(lines[i + 1:i + 4])
            regs, spill = re.search(r"Used (\d+) registers", rest), re.search(r"(\d+) bytes spill stores", rest)
            usage[bool(int(m.group(1)))] = (int(regs.group(1)), int(spill.group(1)))
    return usage


def use_sources(csrc, build_dir) -> str:
    """Point the build at `csrc` (built into `build_dir`), build and load; the nvcc log."""
    _build.CSRC_DIR, _build.BUILD_DIR = csrc, build_dir
    _build.build.cache_clear()
    _build.load_library.cache_clear()
    log = _build.build()[2]
    _build.load_library()
    return log


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="output/torch_gn_v2_variants.json", help="the rows, as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_gn_v2_variants: needs a CUDA device")
    print(chip_smoke.card_line(), flush=True)
    os.environ["E2EFT_GNCONV_IMPL"] = "v2"

    original, src = _build.CSRC_DIR, (_build.CSRC_DIR / "gn_conv.cu").read_text()
    root = _build.PACKAGE_DIR.parent / "output" / "gn_v2_variants"
    shutil.rmtree(root, ignore_errors=True)
    gen = torch.Generator(device="cuda").manual_seed(4)
    inputs = {}
    for b, c, h, w, co in SHAPES:
        x = (torch.randn((b, c, h, w), device="cuda", generator=gen) + 0.5).bfloat16()
        gw = torch.randn(c, device="cuda", generator=gen) * 0.2 + 1.0
        gb = torch.randn(c, device="cuda", generator=gen) * 0.5
        weight = (torch.randn((co, c, 3, 3), device="cuda", generator=gen) * (9 * c) ** -0.5).bfloat16()
        inputs[(b, c, h, w, co)] = (x, gw, gb, 32, 1e-6, weight, torch.randn(co, device="cuda", generator=gen) * 0.1)

    v1 = 0.0
    for shape, launches in SHAPES.items():
        ms = chip_smoke.batch_ms(chip_smoke.gn_conv_only(gc, gn, *inputs[shape], True))
        v1 += launches * ms
        print(f"[v1 conv] {shape}: {ms:.4f} ms", flush=True)
    print(f"[v1 conv] the 48 launches of a step {v1:.3f} ms", flush=True)
    rows, want = [], {}
    for name, edits in {"source": [], **VARIANTS}.items():
        csrc = root / name / "csrc"
        shutil.copytree(original, csrc)
        (csrc / "gn_conv.cu").write_text(rewrite(src, edits))
        usage = ptxas_usage(use_sources(csrc, root / name / "_build"))
        step_ms = 0.0
        for shape, launches in SHAPES.items():
            a = inputs[shape]
            out = gc.gn_conv_kernel(*a)
            want.setdefault(shape, out.float())
            diff = chip_smoke.rel_err(out, want[shape])[1]
            ms = chip_smoke.batch_ms(chip_smoke.gn_conv_v2_only(gc, *a, True))
            step_ms += launches * ms
            rows.append({"variant": name, "shape": list(shape), "ms": ms, "vs_source": diff,
                         "registers_spill": {str(k): v for k, v in usage.items()}})
            print(f"[{name}] {shape}: {ms:.4f} ms, max|d|/max|source| {diff:.1e}", flush=True)
        print(f"[{name}] (registers, spill bytes) by SiLU {usage}; the 48 launches of a step {step_ms:.3f} ms",
              flush=True)
    use_sources(original, _build.PACKAGE_DIR / "_build")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"rows: {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
