"""Training traffic: the trainer's `train_step` on micro-batches from a ring
of host batches, as a loader hands them over.

Parameters (the traffic file's `params`): `micro_batch`, `accumulation`
(micro-steps an optimizer step), `height`, `width`, `ring` (host batches,
at least `accumulation`, so that the checked steps see rows that all
differ), `invalid_share` (of each target's pixels), `reference_rows` (rows
the reference takes at a time).

Set-up builds the trainer and its state, then drives them through the first
optimizer step (`accumulation` micro-steps): the steps that the reference
follows, and the warm-up of every shape. The window then runs whole
optimizer steps until `--seconds` have passed, on the same object.
"""

from __future__ import annotations

import gc
import time

import torch

from lib import checks
from lib.trace import DeviceTrace, Recorder
from reference.precision import FP32, strict_fp32


def _norms(tensors: dict) -> dict:
    names = list(tensors)
    values = torch.stack(torch._foreach_norm([tensors[n].float() for n in names])).tolist()
    return dict(zip(names, values))


def run(ctx) -> dict:
    cell, fam, seed = ctx.cell, ctx.family, ctx.seed
    p = cell.params
    k_acc = p["accumulation"]
    if k_acc < 2 or p["ring"] < k_acc:
        raise ValueError("the checked steps need accumulation >= 2 (the first gradient is read from the "
                         "accumulator) and a ring of at least one optimizer step of distinct batches")
    trainer = fam.build_training(cell, seed, ctx.device)
    state = trainer.init_state()
    ring = fam.train_ring(cell, seed)
    ctx.synchronize()
    ctx.log(f"set-up: trainer built at {ctx.since_start():.2f} s")

    # the checked steps: the first optimizer step, from the seeded state
    start = {n: t.detach().clone() for n, t in state.params.items()}
    losses, g1 = [], None
    for k in range(k_acc):
        state, metrics = trainer.train_step(state, ring[k % len(ring)])
        losses.append(metrics["loss"])
        if k == 0:
            g1 = _norms(state.opt_state["acc"])
    prog = {"losses": [float(x) for x in losses], "g1": g1,
            "dp": _norms({n: state.params[n].detach() - start[n] for n in start})}
    del start
    gc.collect()
    ctx.synchronize()
    ctx.log(f"set-up: checked steps done at {ctx.since_start():.2f} s")

    rec = {"kind": "train", "setup_s": ctx.since_start()}
    recorder, trace = Recorder(ctx.device.type == "cuda"), DeviceTrace(ctx.device)
    if ctx.trace:
        recorder.wrap(trainer, "value_and_grad", "value_and_grad", True, False)
        recorder.wrap(trainer.optimizer, "update", "optimizer", True, False)
    ctx.empty_cache()
    ctx.reset_peak()
    if ctx.trace:
        trace.start()
    micro = 0
    w0 = time.time_ns()
    t0 = time.perf_counter()
    while True:
        for _ in range(k_acc):
            a_ns = time.time_ns()
            state, _ = trainer.train_step(state, ring[(k_acc + micro) % len(ring)])
            recorder.span("train_step", a_ns, time.time_ns())
            micro += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    ctx.synchronize()
    window_s = time.perf_counter() - t0
    w1 = time.time_ns()
    if ctx.trace:
        trace.stop()
    rec.update(window_s=window_s, micro_steps=micro, images=micro * p["micro_batch"], attempted=micro, failed=0,
               peak_bytes=ctx.peak())
    if ctx.trace:
        rec.update(spans=dict(recorder.spans), event_ms=recorder.event_ms(), ops=trace.ops, w0=w0, w1=w1)
        recorder.unwrap()
    del trainer, state
    gc.collect()
    ctx.empty_cache()

    t_ref = time.perf_counter()
    ref = reference_steps(ctx, ring[:k_acc], FP32)
    ctx.log(f"reference: {k_acc} micro-steps in {time.perf_counter() - t_ref:.2f} s")
    rec["numbers"] = checks.train_numbers(prog, ref)
    rec["worst_leaves"] = {k: checks.worst_leaves(prog[k], ref[k]) for k in ("g1", "dp")}
    return rec


def reference_steps(ctx, batches, prec) -> dict:
    """The reference's losses, first gradient, accumulated gradient and first
    optimizer update over `batches` (one optimizer step), rows at a time."""
    from reference.pipeline import adamw_first_update

    cell, fam = ctx.cell, ctx.family
    rows = cell.params["reference_rows"]
    strict_fp32()
    m, loss_sums, weights, groups = fam.reference_training(cell, ctx.seed, ctx.device, prec)
    params = dict(m.unet.named_parameters())
    acc = {n: torch.zeros_like(t) for n, t in params.items()}
    losses, g1 = [], None
    for k, batch in enumerate(batches):
        count = float(batch["val_mask"].sum())
        for t in params.values():
            t.grad = None
        total = 0.0
        for r in range(0, batch["val_mask"].shape[0], rows):
            sums = loss_sums(batch, slice(r, r + rows))
            loss = sum(w * s for w, s in zip(weights, sums)) / max(count, 1.0)
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        grads = {n: torch.zeros_like(t) if t.grad is None else t.grad for n, t in params.items()}
        if k == 0:
            g1 = _norms(grads)
        for n in params:
            acc[n] += grads[n]
    for n in acc:
        acc[n] /= len(batches)
    with torch.no_grad():
        dp = adamw_first_update(acc, params, cell.config["train"], groups)
    out = {"losses": losses, "g1": g1, "acc_norm": _norms(acc), "dp": _norms(dp)}
    del m, params, acc, dp
    gc.collect()
    ctx.empty_cache()
    return out


def work_of(ctx, rec) -> None:
    rec["work"] = ctx.family.train_work(ctx.cell)
