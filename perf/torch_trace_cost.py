"""The port's span recorder (`utils/trace.py`) on the card: what it costs when
on, and its `syncs` counter held to a second count.

    python3 perf/torch_trace_cost.py [--requests 40] [--out <file>]

The served Marigold program is built as `benchmark/`'s
`marigold_serve_saturated` cell builds it (seeded full-width weights in
bf16 on the card, `PipelineService` at processing resolution 768), and one
480x640 image is sent warm:

1. on-cost without a profiler: `--requests` requests in each of three
   arms taken in turns (the profiler's Python flag lowered; raised, so the
   port records its spans and counters though no profiler runs; raised
   without the request span's counters), each request's host clock (it
   ends in a copy to the host) and each arm's quartiles; then, in loops, a
   span, a request span with its counters, the no-op path, and a `.item()`
   alone and counted;
2. on-cost under a profiler session (CUDA activity only) with `infer`
   synchronised, as in the benchmark's traced window: each request's host
   time outside `infer` and its garbage collections in the five arms of
   `_arms`, and the loops again;
3. `syncs`: under a profiler session, each request's count against the
   stream synchronisations that PyTorch's GPU trace callbacks see during
   it, and one more for a request whose UNet call adds one `.item()`;
4. `allocs`: a request after `torch.cuda.empty_cache()` against a warm one.

Prints one JSON line (`--out`: the whole result, each request's time too);
exits 1 if a check fails.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "benchmark")]

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.autograd.profiler as autograd_profiler  # noqa: E402

from diffusion_e2e_ft_tpu_torch.utils import trace  # noqa: E402

SEED = 2_718_281_828


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30)
    return out.stdout.strip()


def build(device):
    from families import marigold
    from lib import spec

    served = marigold.build_serving(spec.load_cell("marigold_serve_saturated"), SEED, device)
    pipe = next(owner for owner, attr, *_ in served.trace_points if attr == "unet")
    return served.call, pipe


def timed(call, img, flag: bool) -> float:
    autograd_profiler._set_is_profiler_enabled(flag)
    try:
        t0 = time.perf_counter()
        call(img)
        return time.perf_counter() - t0
    finally:
        autograd_profiler._set_is_profiler_enabled(False)


def spans_only(device=None):
    """`trace.request` without its counters: a plain `request` span."""
    return trace._NO_SPAN if trace._stack() else trace.span("request")


def loop_us(body, n: int, flag: bool) -> float:
    autograd_profiler._set_is_profiler_enabled(flag)
    try:
        t0 = time.perf_counter()
        for _ in range(n):
            body()
        return (time.perf_counter() - t0) / n * 1e6
    finally:
        autograd_profiler._set_is_profiler_enabled(False)


def on_cost(call, img, device, n: int) -> dict:
    arms = {"off": [], "on": [], "spans_only": []}
    request = trace.request
    trace.clear()
    for i in range(n):
        for k in range(3):
            arm = list(arms)[(i + k) % 3]  # each arm first, second and third in turns
            trace.request = spans_only if arm == "spans_only" else request
            try:
                arms[arm].append(timed(call, img, arm != "off"))
            finally:
                trace.request = request
    n *= 2  # the spans of both arms that record
    spans_a_request = len(trace.spans()) / n
    trace.clear()

    def one_span():
        with trace.span("x"):
            pass

    def one_request():
        with trace.request(device):
            pass

    x = torch.ones((), device=device)

    def items_in_a_request():
        with trace.request(device):
            for _ in range(1_000):
                x.item()

    out = {
        "item_us": loop_us(x.item, 10_000, False), "item_us_counted": loop_us(items_in_a_request, 1, True) / 1_000,
        "requests_each": n // 2, "spans_a_request": spans_a_request,
        "span_us": loop_us(one_span, 100_000, True), "request_span_us": loop_us(one_request, 2_000, True),
        "noop_span_us": loop_us(one_span, 100_000, False),
    }
    trace.clear()
    for arm, times in arms.items():
        out[f"{arm}_ms"] = [1e3 * t for t in times]
        out[f"{arm}_ms_quartiles"] = [1e3 * q for q in statistics.quantiles(times, n=4)]
    out["on_minus_off_us_a_request"] = 1e3 * (out["on_ms_quartiles"][1] - out["off_ms_quartiles"][1])
    out["spans_only_minus_off_us_a_request"] = 1e3 * (out["spans_only_ms_quartiles"][1] - out["off_ms_quartiles"][1])
    return out


class _Lowered:
    _is_profiler_enabled = False


def _arms() -> dict:
    """Each arm of `profiled_cost`: the (object, attribute, value) it sets for a request."""
    return {
        "off": [(trace, "_profiler", _Lowered)],  # the recorder's gate lowered by hand
        "on": [],
        "spans_only": [(trace, "request", spans_only)],
        "no_sync_mode": [(torch.cuda, "set_sync_debug_mode", lambda mode: None)],
        "no_alloc_counter": [(trace, "_alloc_calls", lambda device: 0)],
    }


def profiled_cost(call, pipe, img, device, n: int) -> dict:
    """Under a profiler session (CUDA activity only, as in the benchmark's
    traced window), with `pipe.infer` synchronised before and after as the
    benchmark's traced runs do: each request's host ms outside `infer`, and
    the garbage collections it ran, in the arms of `_arms` taken in turns;
    then a request span with its counters and a counted `.item()` in a loop."""
    arms = _arms()
    times, collections = {arm: [] for arm in arms}, {arm: [0, 0, 0] for arm in arms}
    infer, inside = pipe.infer, []
    x = torch.ones((), device=device)

    def synced_infer(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = infer(*args, **kwargs)
        torch.cuda.synchronize()
        inside.append(time.perf_counter() - t0)
        return out

    def one_request(items: int):
        with trace.request(device):
            for _ in range(items):
                x.item()

    def loop(body, reps: int) -> float:
        t0 = time.perf_counter()
        for _ in range(reps):
            body()
        return (time.perf_counter() - t0) / reps * 1e6

    pipe.infer = synced_infer
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
            for i in range(n):
                for k in range(len(arms)):
                    arm = list(arms)[(i + k) % len(arms)]  # each arm in each place in turns
                    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in arms[arm]]
                    for obj, attr, value in arms[arm]:
                        setattr(obj, attr, value)
                    try:
                        inside.clear()
                        gc0 = [g["collections"] for g in gc.get_stats()]
                        t0 = time.perf_counter()
                        call(img)
                        times[arm].append(time.perf_counter() - t0 - sum(inside))
                        for g, (before, after) in enumerate(zip(gc0, (g["collections"] for g in gc.get_stats()))):
                            collections[arm][g] += after - before
                    finally:
                        for obj, attr, value in saved:
                            setattr(obj, attr, value)
            out = {"request_span_us": loop(lambda: one_request(0), 500),
                   "item_us_counted": loop(lambda: one_request(1_000), 1) / 1_000}
    finally:
        del pipe.infer
    trace.clear()
    for arm, ts in times.items():
        out[f"{arm}_outside_infer_ms_quartiles"] = [1e3 * q for q in statistics.quantiles(ts, n=4)]
        out[f"{arm}_gc_collections"] = collections[arm]
    return out


def traced_requests(call, img, k: int, stream_syncs: list) -> list:
    """k requests under a profiler session: (the request span's attrs, the
    stream synchronisations appended to `stream_syncs` meanwhile) each."""
    seen = []
    trace.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        for _ in range(k):
            before = len(stream_syncs)
            call(img)
            seen.append(len(stream_syncs) - before)
    roots = [s for s in trace.spans() if s.name == "request"]
    trace.clear()
    return [(r.attrs, n) for r, n in zip(roots, seen)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--requests", type=int, default=40)
    p.add_argument("--out", help="also write the whole result, every request's time included, here")
    args = p.parse_args(argv)
    device = torch.device("cuda", 0)
    call, pipe = build(device)
    img = np.random.default_rng(SEED).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    for _ in range(3):
        call(img)
    torch.cuda.synchronize()

    result = {"card": card_line(), "torch": torch.__version__, "cuda": torch.version.cuda}
    result["on_cost"] = on_cost(call, img, device, args.requests)
    result["on_cost_profiled"] = profiled_cost(call, pipe, img, device, args.requests)

    from torch.cuda import _gpu_trace

    stream_syncs = []
    torch._C._activate_gpu_trace()  # for the rest of the process: after the on-cost
    _gpu_trace.register_callback_for_stream_synchronization(stream_syncs.append)
    plain = traced_requests(call, img, 3, stream_syncs)
    unet = pipe.unet

    def unet_with_item(*a, **kw):
        out = unet(*a, **kw)
        out.flatten()[0].item()
        return out

    pipe.unet = unet_with_item
    try:
        extra = traced_requests(call, img, 2, stream_syncs)
    finally:
        pipe.unet = unet
    torch.cuda.empty_cache()
    cold = traced_requests(call, img, 2, stream_syncs)
    result["syncs"] = {"plain": plain, "with_item": extra, "after_empty_cache": cold}
    base = plain[0][0]["syncs"]
    checks = {
        "syncs_equal_gpu_trace": all(a["syncs"] == n for a, n in plain + extra + cold),
        "syncs_repeat": all(a["syncs"] == base for a, _ in plain),
        "item_adds_one": all(a["syncs"] == base + 1 for a, _ in extra),
        "cold_request_allocates": cold[0][0]["allocs"] > 0,
    }
    result["checks"] = checks
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f)
    print(json.dumps({k: v for k, v in result.items() if k != "on_cost"} | {
        "on_cost": {k: v for k, v in result["on_cost"].items() if not (isinstance(v, list) and len(v) > 3)}}), flush=True)
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
