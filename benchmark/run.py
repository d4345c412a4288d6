"""Runs one cell of the benchmark once, on the machine it is started on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It finds the cell by name in `BENCHMARK.json` and its files under
`benchmark/` (see `lib/spec.py`), builds the program's objects with weights
made on the card from the seed, warms up the cell's shapes, measures for
`--seconds`, checks what the window produced against the plain reference
(`reference/`), and prints one JSON line last on standard output. With
`--trace 1` the window runs under a device-only profiler with the harness's
own spans, and the line holds the per-layer metrics in place of the
end-to-end ones. Without a card it prints no result and exits with 2; with
JAX or the JAX package loaded once the window has closed, with 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
for _p in (str(ROOT), str(BENCH_DIR)):
    if _p not in sys.path:
        sys.path.insert(0, _p)
# every build or kernel cache the program might use, at fixed paths inside the checkout
for _var, _dir in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(_var, str(BENCH_DIR / ".cache" / _dir))

FORBIDDEN = ("jax", "jaxlib", "flax", "diffusion_e2e_ft_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the JAX package's."""
    modules = sys.modules if modules is None else modules
    return sorted({name for name in modules if name.split(".")[0] in FORBIDDEN})


class Context:
    """What a traffic driver needs of the run."""

    def __init__(self, cell, family, seed: int, seconds: int, trace: bool, device, t_start: float):
        self.cell, self.family, self.seed, self.seconds, self.trace = cell, family, seed, seconds, trace
        self.device, self._t_start = device, t_start

    def since_start(self) -> float:
        return time.perf_counter() - self._t_start

    def synchronize(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def reset_peak(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak(self) -> int:
        import torch

        return int(torch.cuda.max_memory_allocated(self.device)) if self.device.type == "cuda" else 0

    def empty_cache(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @staticmethod
    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e!r}"


def _number(x):
    """A finite float as it is; None for a missing or non-finite reading (JSON has no inf)."""
    return x if isinstance(x, float) and x == x and abs(x) != float("inf") else None


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=int, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, *, root: Path = ROOT, device=None) -> int:
    """`device` None: the first card, or exit 2 without one (the tests pass the CPU)."""
    args = parse(argv)
    import torch

    Context.log(f"set-up: torch imported at {time.perf_counter() - T_START:.2f} s")
    from lib import checks, spec
    from lib.trace import breakdown, busy_ns

    cell = spec.load_cell(args.workload, root)
    chips = cell.workload["chips"]
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            Context.log(f"no result: the cell needs {chips} CUDA device(s), torch sees "
                        f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    ctx = Context(cell, spec.family_module(cell.config["family"]), args.seed, args.seconds, bool(args.trace),
                  device, T_START)
    kind = spec.kind_module(cell.kind)
    rec = kind.run(ctx)

    found = forbidden_modules()
    if found:
        Context.log(f"no result: JAX or the JAX package is loaded: {', '.join(found)}")
        return 3
    t_read = time.perf_counter()
    if args.trace:
        kind.work_of(ctx, rec)
    metrics = {}
    for m in cell.per_layer if args.trace else cell.end_to_end:
        value = spec.metric_reader(m["name"], root).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if args.trace:
        Context.log(f"trace: work counted and metrics read in {time.perf_counter() - t_read:.2f} s")
    numbers = rec["numbers"]
    correct = rec["failed"] == 0 and checks.judge(numbers, cell.limits)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": chips, "memory_peak_bytes": rec["peak_bytes"]}
    result = {"correct": correct, "attempted": rec["attempted"], "failed": rec["failed"], "metrics": metrics,
              "device": dev}
    if args.trace:
        dev["busy_s"] = busy_ns(rec) / 1e9
        dev["window_s"] = (rec["w1"] - rec["w0"]) / 1e9
        result["breakdown"] = breakdown(rec)
    result["checks"] = {k: {"value": _number(numbers.get(k)), "limit": v} for k, v in cell.limits.items()}
    if device.type == "cuda":
        Context.log(f"card: {card_line()}")
    for k in sorted(set(numbers) - set(cell.limits)):
        Context.log(f"reading {k} {numbers[k]!r} (not compared)")
    for k, c in result["checks"].items():
        Context.log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
