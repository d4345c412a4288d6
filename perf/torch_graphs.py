"""The CUDA graphs of the UNet and the CLIP image tower (`utils/graphs.py`)
on the card: each graphed call against the eager one, and whole requests.

    python3 perf/torch_graphs.py [--calls 20] [--requests 8] [--out <file>]

The served programs are built as `benchmark/`'s saturated cells build them
(seeded full-width weights in bf16 on the card): Marigold (the SD2 UNet) and
GeoWizard (its joint UNet at batch 2 and the CLIP ViT-L/14 tower). One
request a mix size (480x640, run at 576x768; 768x768) records each graphed
module's arguments; then, for each module and size:

1. eager (a cache of bound 0, so every call runs eagerly) and graphed
   (first sight, capture, then replays), `--calls` calls each: host ms of
   the call (no synchronise: the enqueue), device ms (CUDA events around
   it), the capture's host ms, bitwise equality with the eager output;
2. the graph's private pool: bytes of the memory segments in it, and the
   allocator's reserved bytes before and after the capture;
3. the host-device synchronisations of a replayed call (PyTorch's CUDA sync
   debug mode);
4. host ms of a replayed call and of its `cudaGraphLaunch` alone (the
   graph's `replay()`), and of an eager call, with and without the
   benchmark's device-only profiler running (its traced windows);

then `--requests` whole requests a size through each program, eager and
graphed in turns (host clock, each ending in the copy to the host).

Prints one JSON line (`--out`: the whole result); exits 1 if a replay
differs from the eager call by a bit or a replay synchronises.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "benchmark")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from diffusion_e2e_ft_tpu_torch.utils import graphs  # noqa: E402

SEED = 3_141_592_653
SIZES = ((480, 640), (768, 768))


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30)
    return out.stdout.strip()


def build(family: str, device):
    from families import geowizard, marigold
    from lib import spec

    cell = f"{family}_serve_saturated"
    served = {"marigold": marigold, "geowizard": geowizard}[family].build_serving(spec.load_cell(cell), SEED, device)
    pipe = next(owner for owner, attr, *_ in served.trace_points if attr == "unet")
    modules = {"unet": pipe.unet}
    if getattr(pipe, "image_encoder", None) is not None:
        modules["image_encoder"] = pipe.image_encoder
    return served.call, modules


def arguments(call, modules: dict, img) -> dict:
    """Each module's positional arguments in one request."""
    seen, hooks = {}, []
    for name, m in modules.items():
        hooks.append(m.register_forward_pre_hook(lambda mod, args, name=name: seen.setdefault(name, args)))
    try:
        call(img)
    finally:
        for h in hooks:
            h.remove()
    return seen


def timed_calls(module, args, n: int):
    host, device, outs = [], [], []
    with torch.inference_mode():
        for _ in range(n):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            e0.record()
            t0 = time.perf_counter()
            out = module(*args)
            host.append((time.perf_counter() - t0) * 1e3)
            e1.record()
            torch.cuda.synchronize()
            device.append(e0.elapsed_time(e1))
            outs.append(out)
    return host, device, outs


def pool_bytes(cache: graphs.GraphCache) -> int:
    pools = {g.graph.pool() for g in cache._entries.values() if g is not None}
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot() if tuple(s.get("segment_pool_id", ())) in pools)


def syncs_of(fn) -> int:
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with torch.inference_mode():
                fn()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    return sum("synchronizing CUDA operation" in str(w.message) for w in caught)


def profiled_host(module, args, n: int, profiled: bool) -> dict:
    """Host ms of a call and of the graph's launch alone, with or without the
    benchmark's device-only profiler (`benchmark/lib/trace.py::DeviceTrace`)."""
    graph = next((g for g in module._graphs._entries.values() if g is not None), None)
    prof = (torch.autograd.profiler.profile(use_device="cuda", use_cpu=False, use_kineto=True) if profiled
            else contextlib.nullcontext())
    call, launch = [], []
    with prof, torch.inference_mode():
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            module(*args)
            call.append((time.perf_counter() - t0) * 1e3)
            if graph is not None:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                graph.graph.replay()
                launch.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return {"call_ms": median(call), "launch_ms": median(launch)}


def median(xs):
    return statistics.median(xs) if xs else None


def module_ab(module, args, n: int) -> dict:
    module._graphs = graphs.GraphCache(limit=0)
    e_host, e_dev, e_outs = timed_calls(module, args, n)
    module._graphs = graphs.GraphCache()
    timed_calls(module, args, 1)  # first sight
    reserved0 = torch.cuda.memory_reserved()
    _, _, (capture_out,) = cap = timed_calls(module, args, 1)
    reserved1 = torch.cuda.memory_reserved()
    g_host, g_dev, g_outs = timed_calls(module, args, n)
    arms = (("plain", False), ("profiled", True))
    host = {f"graphed.{k}": profiled_host(module, args, n, on) for k, on in arms}
    module._graphs = graphs.GraphCache(limit=0)
    host.update({f"eager.{k}": profiled_host(module, args, n, on)["call_ms"] for k, on in arms})
    module._graphs = graphs.GraphCache()
    timed_calls(module, args, 2)  # captured again, for the requests below
    ref = e_outs[0]
    return {
        "shapes": [None if not torch.is_tensor(a) else list(a.shape) for a in args],
        "eager_host_ms": median(e_host), "eager_device_ms": median(e_dev),
        "replay_host_ms": median(g_host), "replay_device_ms": median(g_dev),
        "capture_host_ms": cap[0][0], "capture_device_ms": cap[1][0],
        "eager_deterministic": all(torch.equal(o, ref) for o in e_outs),
        "capture_bitwise": torch.equal(capture_out, ref),
        "replay_bitwise": all(torch.equal(o, ref) for o in g_outs),
        "pool_bytes": pool_bytes(module._graphs), "reserved_delta_bytes": reserved1 - reserved0,
        "replay_syncs": syncs_of(lambda: module(*args)), "host_under_profiler": host,
        "eager_host_ms_all": e_host, "replay_host_ms_all": g_host,
    }


def requests_ab(call, modules: dict, images: dict, n: int) -> dict:
    caches = {"eager": {k: graphs.GraphCache(limit=0) for k in modules},
              "graphed": {k: graphs.GraphCache() for k in modules}}
    out = {}
    for hw, img in images.items():
        times = {"eager": [], "graphed": []}
        for arm in times:  # warm each arm: the graphed one captures here
            for k, m in modules.items():
                m._graphs = caches[arm][k]
            for _ in range(2):
                call(img)
        for i in range(2 * n):
            arm = ("eager", "graphed")[(i + i // 2) % 2]  # e, g, g, e, e, g, ...
            for k, m in modules.items():
                m._graphs = caches[arm][k]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call(img)
            times[arm].append((time.perf_counter() - t0) * 1e3)
        out["x".join(map(str, hw))] = {arm: {"median_ms": median(t), "ms": t} for arm, t in times.items()}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    rng = np.random.default_rng(SEED)
    images = {hw: rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for hw in SIZES}
    result = {"card": card_line(), "torch": torch.__version__, "cuda": torch.version.cuda, "modules": {},
              "requests": {}}
    ok = True
    for family in ("marigold", "geowizard"):
        call, modules = build(family, device)
        for hw, img in images.items():
            for name, args in arguments(call, modules, img).items():
                r = module_ab(modules[name], args, a.calls)
                result["modules"][f"{family}.{name}.{hw[0]}x{hw[1]}"] = r
                ok &= r["capture_bitwise"] and r["replay_bitwise"] and r["replay_syncs"] == 0
                print(f"[graphs] {family} {name} {hw}: eager host {r['eager_host_ms']:.3f} device "
                      f"{r['eager_device_ms']:.3f} ms; replay host {r['replay_host_ms']:.3f} device "
                      f"{r['replay_device_ms']:.3f} ms; capture {r['capture_host_ms']:.1f} ms; pool "
                      f"{r['pool_bytes']} B (reserved +{r['reserved_delta_bytes']}); bitwise "
                      f"{r['capture_bitwise']}/{r['replay_bitwise']}; replay syncs {r['replay_syncs']}; host ms "
                      f"{json.dumps(r['host_under_profiler'])}",
                      file=sys.stderr, flush=True)
        result["requests"][family] = requests_ab(call, modules, images, a.requests)
        for hw, r in result["requests"][family].items():
            print(f"[graphs] {family} request {hw}: eager {r['eager']['median_ms']:.2f} ms, graphed "
                  f"{r['graphed']['median_ms']:.2f} ms", file=sys.stderr, flush=True)
        del call, modules
        torch.cuda.empty_cache()
    result["ok"] = bool(ok)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(result, f, indent=1)
    brief = {k: v for k, v in result.items() if k not in ("modules", "requests")}
    brief["modules"] = {k: {f: v[f] for f in ("replay_host_ms", "eager_host_ms", "pool_bytes")}
                        for k, v in result["modules"].items()}
    print(json.dumps(brief), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
