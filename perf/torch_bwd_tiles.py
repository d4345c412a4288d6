"""Tile sweep of the bf16 flash-attention backward kernels (dq, dk/dv) on one GPU.

    python3 perf/torch_bwd_tiles.py [--out output/torch_bwd_tiles.json]

`csrc/flash_attention_bwd.cu` picks its tiles per (head dim, kernel) in
`BwdTile<D, kDkv>`: BM rows a block owns, BN rows a streamed tile, DS warps
splitting d, STAGES `cp.async` stages, MIN_BLOCKS resident blocks an SM for
`__launch_bounds__`. This script builds the sources as they are, then once
for each candidate set below with those lines rewritten (in a copy of
`csrc/` under `output/bwd_tiles/`), and times dq and dk/dv (CUDA events,
median of 20) at the 480x640 bs-2 training shapes of SD2 and GeoWizard. For
each it prints the time, the registers and spill bytes `ptxas` reports, and
max |d| / max |source| against the sources' own tiles (a tile changes only
the summation order); then the fastest tiles per (head dim, kernel). The
rows go to `--out` as JSON. Imports no JAX.
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
from diffusion_e2e_ft_tpu_torch.kernels import flash_attention as fa

SHAPES = [(2, 4800, 5, 64), (2, 9600, 8, 40), (2, 2400, 8, 80), (2, 600, 8, 160), (2, 4800, 1, 512)]
# candidate sets: (head dim, kernel) -> (BM, BN, DS, STAGES, MIN_BLOCKS); "source" is the file as it is
CANDIDATES = {
    "v1": {(40, "dq"): (64, 64, 1, 2, 2), (64, "dq"): (64, 64, 1, 2, 2), (80, "dq"): (64, 32, 1, 2, 3),
           (160, "dq"): (64, 32, 1, 3, 2), (512, "dq"): (32, 16, 4, 2, 1), (40, "dkv"): (64, 32, 1, 2, 3),
           (64, "dkv"): (64, 32, 1, 2, 3), (80, "dkv"): (64, 32, 1, 3, 2), (160, "dkv"): (32, 32, 2, 3, 2),
           (512, "dkv"): (32, 16, 4, 2, 1)},
    "v2": {(40, "dq"): (128, 64, 1, 2, 1), (64, "dq"): (128, 64, 1, 2, 1), (80, "dq"): (128, 64, 1, 2, 1),
           (160, "dq"): (64, 64, 1, 2, 1), (512, "dq"): (32, 16, 4, 4, 1), (40, "dkv"): (128, 64, 1, 2, 1),
           (64, "dkv"): (128, 64, 1, 2, 1), (80, "dkv"): (64, 64, 1, 2, 2), (160, "dkv"): (64, 32, 2, 2, 1),
           (512, "dkv"): (32, 16, 4, 4, 1)},
    "v3": {(40, "dq"): (64, 64, 1, 3, 3), (64, "dq"): (64, 64, 1, 3, 2), (80, "dq"): (64, 64, 1, 3, 2),
           (160, "dq"): (32, 32, 2, 2, 2), (512, "dq"): (64, 16, 2, 2, 1), (40, "dkv"): (64, 64, 1, 3, 2),
           (64, "dkv"): (64, 64, 1, 3, 2), (80, "dkv"): (32, 32, 1, 2, 4), (160, "dkv"): (32, 16, 2, 3, 3),
           (512, "dkv"): (16, 16, 8, 3, 1)},
    "v4": {(40, "dq"): (128, 32, 1, 3, 1), (64, "dq"): (128, 32, 1, 3, 1), (80, "dq"): (128, 32, 1, 2, 1),
           (160, "dq"): (64, 16, 1, 3, 2), (512, "dq"): (16, 32, 4, 2, 1), (40, "dkv"): (128, 32, 1, 3, 1),
           (64, "dkv"): (128, 32, 1, 3, 1), (80, "dkv"): (128, 32, 1, 2, 1), (160, "dkv"): (64, 16, 2, 3, 1),
           (512, "dkv"): (16, 32, 4, 2, 1)},
}
TILE_LINE = (r"(struct BwdTile<{d}, {dkv}> \{{\s*static constexpr int) "
             r"BM = \d+, BN = \d+, DS = \d+, STAGES = \d+, MIN_BLOCKS = \d+;")
FIELDS = r"BM = (\d+), BN = (\d+), DS = (\d+), STAGES = (\d+), MIN_BLOCKS = (\d+);"


def source_tiles(src: str) -> dict:
    return {(int(d), "dkv" if kind == "true" else "dq"): tuple(map(int, vals))
            for d, kind, *vals in re.findall(r"struct BwdTile<(\d+), (false|true)> \{\s*static constexpr int "
                                              + FIELDS, src)}


def rewrite(src: str, tiles: dict) -> str:
    for (d, kernel), (bm, bn, ds, stages, blocks) in tiles.items():
        src, n = re.subn(TILE_LINE.format(d=d, dkv="true" if kernel == "dkv" else "false"),
                         rf"\1 BM = {bm}, BN = {bn}, DS = {ds}, STAGES = {stages}, MIN_BLOCKS = {blocks};", src)
        if n != 1:
            raise ValueError(f"no BwdTile<{d}, {kernel}> line in the source")
    return src


def ptxas_usage(log: str) -> dict:
    """(head dim, kernel) -> (registers, spill store bytes) of the bf16 backward kernels."""
    usage, lines = {}, log.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"flash_bwd_(dq|dkv)_kernelILi(\d+)EE", line)
        if "Compiling entry function" in line and m:
            rest = " ".join(lines[i + 1:i + 4])
            regs, spill = re.search(r"Used (\d+) registers", rest), re.search(r"(\d+) bytes spill stores", rest)
            usage[(int(m.group(2)), m.group(1))] = (int(regs.group(1)), int(spill.group(1)))
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
    ap.add_argument("--out", default="output/torch_bwd_tiles.json", help="the rows, as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_bwd_tiles: needs a CUDA device")
    print(chip_smoke.card_line(), flush=True)

    original, src = _build.CSRC_DIR, (_build.CSRC_DIR / "flash_attention_bwd.cu").read_text()
    root = _build.PACKAGE_DIR.parent / "output" / "bwd_tiles"
    shutil.rmtree(root, ignore_errors=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {}
    for shape in SHAPES:
        q, k, v, do = (torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(4))
        out, lse = fa.flash_attention_fwd_lse(q, k, v)
        inputs[shape] = (q, k, v, do, lse, (do.float() * out.float()).sum(-1))

    rows, want = [], {}
    for name, tiles in {"source": {}, **CANDIDATES}.items():
        csrc = root / name / "csrc"
        shutil.copytree(original, csrc)
        (csrc / "flash_attention_bwd.cu").write_text(rewrite(src, tiles))
        usage = ptxas_usage(use_sources(csrc, root / name / "_build"))
        chosen = {**source_tiles(src), **tiles}
        for shape, (q, k, v, do, lse, delta) in inputs.items():
            grads = (fa.flash_attention_bwd_dq(q, k, v, do, lse, delta),
                     *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta))
            want.setdefault(shape, [g.float() for g in grads])
            diff = max(chip_smoke.rel_err(g, w)[1] for g, w in zip(grads, want[shape]))
            d = shape[-1]
            for kernel, fn in (("dq", fa.flash_attention_bwd_dq), ("dkv", fa.flash_attention_bwd_dkv)):
                ms = chip_smoke.time_ms(lambda: fn(q, k, v, do, lse, delta), reps=20)
                regs, spill = usage[(d, kernel)]
                rows.append({"set": name, "shape": list(shape), "kernel": kernel, "tile": chosen[(d, kernel)],
                             "ms": ms, "registers": regs, "spill_bytes": spill, "vs_source": diff})
                print(f"[{name}] {shape} {kernel}: {ms:.4f} ms, tile (BM, BN, DS, STAGES, MIN_BLOCKS) "
                      f"{chosen[(d, kernel)]}, {regs} registers, {spill} bytes spilled, max|d|/max|source| "
                      f"{diff:.1e}", flush=True)
    use_sources(original, _build.PACKAGE_DIR / "_build")

    for shape in SHAPES:
        for kernel in ("dq", "dkv"):
            best = min((r for r in rows if r["shape"] == list(shape) and r["kernel"] == kernel),
                       key=lambda r: r["ms"])
            print(f"[fastest] {shape} {kernel}: {best['set']} {best['tile']} {best['ms']:.4f} ms", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"rows: {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
