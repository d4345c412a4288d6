"""Readings that the limits of `correct` are set from, for one cell, on the
card, in one process (the benchmark's own runs never run this):

    python3 benchmark/calibrate.py --workload <cell> --seeds <n> ... \
        [--control-seeds <n> ...] [--fault-seeds <n> ...] [--affine-fault-seeds <n> ...] \
        [--seconds 3] [--out FILE]

- for each of `--seeds`: the program, as a run drives it (a short window),
  against the float32 reference: the lower readings;
- for each of `--control-seeds`: the control, the reference computed with
  float8 e4m3 operands (`reference/precision.py`), in the program's place,
  against the float32 reference, on the inputs a run checks: the upper
  readings;
- for each of `--fault-seeds` (training cells): the fault "half of the batch
  left out, the mean taken over the rest", planted in the reference, against
  the whole batch's reference. (A state left unchanged reads 1 by the
  measure and needs no run.)
- for each of `--affine-fault-seeds` (serving cells): the fault "every
  GroupNorm's affine ignored" (scale one, shift zero), planted in the float32
  reference in the program's place.

Every reading goes to `--out` as JSON, and a summary to standard output.
"""

import contextlib
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
for _p in (str(BENCH_DIR.parent), str(BENCH_DIR)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


@contextlib.contextmanager
def affine_ignored():
    """The reference's GroupNorms without their scale and shift, while the block runs."""
    import torch.nn.functional as F

    from reference import models as ref

    forward = ref.GroupNorm.forward

    def plain(self, x):
        y = F.group_norm(x.float(), self.groups, None, None, self.eps)
        return F.silu(y) if self.silu else y

    ref.GroupNorm.forward = plain
    try:
        yield
    finally:
        ref.GroupNorm.forward = forward


def serve_control(ctx, prec, fault=contextlib.nullcontext) -> dict:
    from kinds.serve import images
    from lib import checks
    from reference.precision import FP32, strict_fp32

    strict_fp32()
    cell, fam = ctx.cell, ctx.family
    pool = images(cell.params, ctx.seed)
    sample = [pool[tuple(size)][i % len(pool[tuple(size)])] for size, k in cell.params["check"] for i in range(k)]
    ref32 = fam.reference_serving(cell, ctx.seed, ctx.device, FP32)
    want = [ref32(img) for img in sample]
    del ref32
    low = fam.reference_serving(cell, ctx.seed, ctx.device, prec)
    with fault():
        return checks.worst([checks.serve_numbers(low(img), w) for img, w in zip(sample, want)])


def train_control(ctx, prec, half: bool = False) -> dict:
    from kinds.train import reference_steps
    from lib import checks
    from reference.precision import FP32

    cell, fam = ctx.cell, ctx.family
    ring = fam.train_ring(cell, ctx.seed)[:cell.params["accumulation"]]
    want = reference_steps(ctx, ring, FP32)
    if half:  # the first half of each batch's rows, the mean over them alone
        ring = [{k: v[: v.shape[0] // 2] for k, v in b.items()} for b in ring]
    got = reference_steps(ctx, ring, prec)
    return checks.train_numbers({"losses": got["losses"], "g1": got["g1"], "dp": got["dp"]}, want)


def main(argv=None) -> int:
    import argparse

    import torch

    import run
    from lib import spec
    from reference.precision import FP8, FP32

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--affine-fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=int, default=3)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.load_cell(args.workload)
    fam = spec.family_module(cell.config["family"])
    kind = spec.kind_module(cell.kind)
    out = {"workload": args.workload, "card": run.card_line(), "program": {}, "control": {}, "fault_half_batch": {},
           "fault_affine": {}}

    def ctx_for(seed):
        return run.Context(cell, fam, seed, args.seconds, False, device, time.perf_counter())

    def save():
        if args.out:
            Path(args.out).write_text(json.dumps(out, indent=1))

    for seed in args.seeds:
        t0 = time.perf_counter()
        rec = kind.run(ctx_for(seed))
        out["program"][seed] = rec["numbers"]
        print(f"program seed {seed}: {rec['numbers']} ({time.perf_counter() - t0:.1f} s)", flush=True)
        if "worst_leaves" in rec:
            print(f"  worst leaves {rec['worst_leaves']}", flush=True)
        save()
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        ctx = ctx_for(seed)
        nums = serve_control(ctx, FP8) if cell.kind == "serve" else train_control(ctx, FP8)
        out["control"][seed] = nums
        print(f"control seed {seed}: {nums} ({time.perf_counter() - t0:.1f} s)", flush=True)
        torch.cuda.empty_cache()
        save()
    for seed in args.fault_seeds:
        t0 = time.perf_counter()
        nums = train_control(ctx_for(seed), FP32, half=True)
        out["fault_half_batch"][seed] = nums
        print(f"half-batch fault seed {seed}: {nums} ({time.perf_counter() - t0:.1f} s)", flush=True)
        torch.cuda.empty_cache()
        save()
    for seed in args.affine_fault_seeds:
        t0 = time.perf_counter()
        nums = serve_control(ctx_for(seed), FP32, fault=affine_ignored)
        out["fault_affine"][seed] = nums
        print(f"affine fault seed {seed}: {nums} ({time.perf_counter() - t0:.1f} s)", flush=True)
        torch.cuda.empty_cache()
        save()
    for part in ("program", "control", "fault_half_batch", "fault_affine"):
        readings = list(out[part].values())
        for k in sorted({k for r in readings for k in r}):
            vals = [r[k] for r in readings]
            print(f"{part} {k}: min {min(vals):.6g} max {max(vals):.6g} over {len(vals)} seeds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
