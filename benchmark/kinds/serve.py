"""Serving traffic: uint8 RGB images sent to a server that takes one at a
time (`PipelineService` holds a lock), in one of two loops:

- open (`rate` given): requests due at a fixed rate, evenly spaced, as a
  camera or many independent users send them; a request waits while the one
  before it runs, and its latency runs from when it was due to when its
  answer is back, so a stall counts against every request queued behind it.
  Below the system's capacity the tail of the latency is the cell's
  end-to-end metric;
- closed (no `rate`): one client that sends the next request when the
  answer to the one before is back, so the server never waits for work and
  nothing queues; the requests completed a second are the cell's end-to-end
  metric, and a request's latency runs from its call.

Parameters (the traffic file's `params`):
- `rate` (open loop only): requests due a second;
- `shapes`: the input sizes [H, W] of one block of requests; the seed
  shuffles the order inside each block, so every seed sends the same mix;
- `pool`: distinct images made from the seed for each size;
- `warmup`: calls of each size before the window;
- `check`: requests of each size, drawn from the seed among those completed,
  that the reference works out again after the window.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np

from lib import checks, weights as W
from lib.trace import DeviceTrace, Recorder
from reference.pipeline import processing_hw
from reference.precision import FP32, strict_fp32


def images(params: dict, seed: int) -> Dict[tuple, List[np.ndarray]]:
    rng = np.random.default_rng([int(seed) % (1 << 64), W.MODULE_STREAMS["inputs"]])
    sizes = sorted({tuple(s) for s in params["shapes"]})
    return {s: [rng.integers(0, 256, (*s, 3), dtype=np.uint8) for _ in range(params["pool"])] for s in sizes}


def order(params: dict, seed: int, n: int) -> List[tuple]:
    """The sizes of the first n requests: each block of `shapes` in an order drawn from the seed."""
    rng = np.random.default_rng([int(seed) % (1 << 64), W.MODULE_STREAMS["inputs"], 1])
    block = [tuple(s) for s in params["shapes"]]
    out = []
    while len(out) < n:
        out += [block[i] for i in rng.permutation(len(block))]
    return out[:n]


def run(ctx) -> dict:
    cell, fam, seed = ctx.cell, ctx.family, ctx.seed
    p = cell.params
    served = fam.build_serving(cell, seed, ctx.device)
    pool = images(p, seed)
    ctx.synchronize()
    ctx.log(f"set-up: program built at {ctx.since_start():.2f} s")
    for size, imgs in pool.items():
        for k in range(p["warmup"]):
            served.call(imgs[k % len(imgs)])
    ctx.synchronize()

    rec = {"kind": "serve", "setup_s": ctx.since_start()}
    recorder, trace = Recorder(ctx.device.type == "cuda"), DeviceTrace(ctx.device)
    if ctx.trace:
        for owner, attr, name, events, sync in served.trace_points:
            recorder.wrap(owner, attr, name, events, sync)
    sizes = order(p, seed, 1 << 20)
    used = {s: 0 for s in pool}
    outputs, latencies, sent = [], [], []
    failed = 0
    ctx.reset_peak()
    if ctx.trace:
        trace.start()
    interval = 1.0 / p["rate"] if p.get("rate") else 0.0
    w0 = time.time_ns()
    t0 = time.perf_counter()
    # requests due in the window, each started once the one before is done, none started after the window
    while len(sent) * interval < ctx.seconds and time.perf_counter() - t0 < ctx.seconds:
        due = t0 + len(sent) * interval if interval else time.perf_counter()
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        size = sizes[len(sent)]
        img = pool[size][used[size] % len(pool[size])]
        used[size] += 1
        a_ns = time.time_ns()
        try:
            out = served.call(img)
        except Exception as e:  # a failed request counts and the loop goes on, as a server would
            ctx.log(f"request {len(sent)} failed: {e!r}")
            out, failed = None, failed + 1
        latencies.append(time.perf_counter() - due)
        recorder.span("request", a_ns, time.time_ns())
        sent.append((size, img))
        outputs.append(out)
    window_s = time.perf_counter() - t0
    w1 = time.time_ns()
    if ctx.trace:
        t_read = time.perf_counter()
        trace.stop()
        ctx.log(f"trace: {len(trace.ops)} device operations read in {time.perf_counter() - t_read:.2f} s")
    rec.update(window_s=window_s, latencies_s=latencies, attempted=len(sent), failed=failed, peak_bytes=ctx.peak())
    if ctx.trace:
        rec.update(spans=dict(recorder.spans), event_ms=recorder.event_ms(), ops=trace.ops, w0=w0, w1=w1,
                   processing=[processing_hw_of(cell, s) for s, _ in sent])
        recorder.unwrap()
    del served
    gc.collect()
    ctx.empty_cache()

    # correct: a sample of the completed requests, worked out again by the reference
    rng = np.random.default_rng([int(seed) % (1 << 64), W.MODULE_STREAMS["inputs"], 2])
    sample = []
    for size, k in p["check"]:
        done = [i for i, (s, _) in enumerate(sent) if s == tuple(size) and outputs[i] is not None]
        sample += list(rng.choice(done, size=min(k, len(done)), replace=False)) if done else []
    strict_fp32()
    reference = fam.reference_serving(cell, seed, ctx.device, FP32)
    t_ref = time.perf_counter()
    readings = [checks.serve_numbers(outputs[i], reference(sent[i][1])) for i in sorted(sample)]
    ctx.log(f"reference: {len(readings)} requests in {time.perf_counter() - t_ref:.2f} s")
    rec["numbers"] = checks.worst(readings) if readings else {k: checks.INF for k in cell.limits}
    return rec


def processing_hw_of(cell, size) -> tuple:
    """The size a request of input `size` is processed at."""
    return processing_hw(size[0], size[1], cell.config["serve"]["processing_res"])


def work_of(ctx, rec) -> None:
    """The reference's work of each processing size in the traced window."""
    rec["work"] = {hw: ctx.family.serve_work(ctx.cell, hw) for hw in sorted(set(rec["processing"]))}
