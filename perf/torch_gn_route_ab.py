"""Host-clock A/B of the standalone GroupNorms' kernels: the one C call against the two-call route and the
plain version, on one GPU.

    python3 perf/torch_gn_route_ab.py [--pairs 10] [--baseline-pairs 3] [--train-steps 3]
        [--out chiprun_out/torch_gn_route_ab.json]

Every `GroupNormAct` calls `models.layers.group_norm_silu`, which on the card
is `kernels.groupnorm.group_norm_silu`: one C call a GroupNorm, one launch of
the one-launch kernel where a (b, g) slab fits a cluster's shared memory,
else the statistics kernel and the apply ("one call"). The other arms rebind
that name, in this process only: "two calls" to the two-kernel route as the
port ran it before the one C call, rebuilt here (`channel_stats`, then
`group_norm_apply`: two Python wrappers with their checks, two C calls, each
through a launch path that enters a `torch.cuda.device` guard, builds a
`Stream` object and looks the entry point up at every launch), on the same
library's statistics and apply kernels; "plain" to
`kernels.groupnorm.group_norm_reference`, the plain PyTorch version (about
twenty eager launches a GroupNorm). Nothing in the package reads a switch.
The arms run in turns, their order reversed every round (one call, two
calls, plain, then plain, two calls, one call, ...), so that drift on the
card or the host falls on all:

- Marigold serving, bf16, full-width SD2 (`UNetConfig.sd2()`, `VAEConfig()`,
  seeded random weights): a single-step request (`pipe(image,
  processing_res=...)`) at 768x768 and at 576x768, `--pairs` rounds each
  after a warm-up request of each arm;
- the multi-step baseline: 480x640 at processing_res 0, 50 trailing-DDIM
  steps, ensemble 10, pyramid noise, seed 1234, `find_batch_size`'s batch,
  `--baseline-pairs` rounds;
- the E2E train step, 480x640 bs 2, bf16 compute with fp32 masters, UNet
  checkpointing, the default fused VAE: `--train-steps` steps an arm's turn
  after a warm-up step, two turns an arm (one call, two calls, plain, plain,
  two calls, one call), with the peak device memory of each arm's steps.

Each request or step is timed on the host clock with the card synchronised
before and after. Printed: each arm's times, medians and ranges, the median
of the per-round differences against the one call and the rounds it won, the
GroupNorm kernels' launches a request or step; the numbers also go to
`--out` as JSON. Then three 768x768 requests of each arm under
torch.profiler (`torch_profile_serve.py`'s table: wall, kernel time, idle
share, kernels a request, kernel time by kind; per-op tables beside `--out`).
Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from diffusion_e2e_ft_tpu_torch.kernels import _build, groupnorm
from diffusion_e2e_ft_tpu_torch.models import UNetConfig, VAEConfig
from diffusion_e2e_ft_tpu_torch.models import layers
from diffusion_e2e_ft_tpu_torch.pipelines import MarigoldPipeline
from diffusion_e2e_ft_tpu_torch.training import E2ETrainer, TrainConfig
from torch_profile_serve import profile_requests  # beside this file

def two_call_launch(name: str, t: torch.Tensor, *args) -> None:
    """The former `_build.launch`: the entry point looked up, a `torch.cuda.device` guard entered and a `Stream`
    object built at every launch."""
    fn = getattr(_build.load_library(), "e2eft_" + name)
    with torch.cuda.device(t.device):
        err = fn(*args, torch.cuda.current_stream(t.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (code {err}) at {tuple(t.shape)} {t.dtype}")
    groupnorm.launches[name] += 1


def two_call_stats(x: torch.Tensor) -> torch.Tensor:
    """The former `channel_stats` wrapper, its checks and its launch path."""
    groupnorm.check_kernel_operand("channel_stats", "x", x)
    if x.ndim not in (3, 4) or x.numel() == 0:
        raise ValueError(f"channel_stats: x must be a non-empty [B, C, H, W] or [B, C, N], got {tuple(x.shape)}")
    b, c = x.shape[:2]
    out = torch.empty((b, 2, c), dtype=torch.float32, device=x.device)
    two_call_launch("gn_channel_stats", x, x.data_ptr(), out.data_ptr(), _build.DTYPE_CODES[x.dtype], b, c,
                x[0, 0].numel())
    return out


def two_call_apply(x, stats, weight, bias, groups: int, eps: float, silu: bool) -> torch.Tensor:
    """The former `group_norm_apply` wrapper, its checks and its launch path."""
    groupnorm.check_kernel_operand("gn_apply", "x", x)
    if x.ndim not in (3, 4) or x.numel() == 0:
        raise ValueError(f"gn_apply: x must be a non-empty [B, C, H, W] or [B, C, N], got {tuple(x.shape)}")
    b, c = x.shape[:2]
    if groups <= 0 or c % groups:
        raise ValueError(f"gn_apply: {c} channels do not split into {groups} groups")
    if (stats.device != x.device or stats.dtype != torch.float32 or stats.shape != (b, 2, c)
            or not stats.is_contiguous()):
        raise ValueError(f"gn_apply: stats must be contiguous fp32 [{b}, 2, {c}] on {x.device}")
    for name, t in (("weight", weight), ("bias", bias)):
        groupnorm.check_kernel_operand("gn_apply", name, t)
        if t.device != x.device or t.shape != (c,):
            raise ValueError(f"gn_apply: {name} {tuple(t.shape)} on {t.device}, expected [{c}] on {x.device}")
    if weight.dtype != bias.dtype:
        raise TypeError(f"gn_apply: weight {weight.dtype} and bias {bias.dtype} differ")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    two_call_launch("gn_apply", x, x.data_ptr(), stats.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
                _build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[weight.dtype], b, c, x[0, 0].numel(), groups,
                float(eps), int(silu))
    return out


def two_call_kernel(x, weight, bias, groups: int, eps: float, silu: bool = True) -> torch.Tensor:
    """The former `group_norm_kernel`: the statistics, then the apply, two wrappers and two C calls."""
    return two_call_apply(x, two_call_stats(x), weight, bias, groups, eps, silu)


def two_call_group_norm_silu(x, weight, bias, groups: int, eps: float, silu: bool = True) -> torch.Tensor:
    """The former dispatcher on the card: x made contiguous, `GroupNormFunction` over the route under grad."""
    x = x.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad or bias.requires_grad):
        return groupnorm.GroupNormFunction.apply(x, weight, bias, groups, eps, silu, two_call_kernel)
    return two_call_kernel(x, weight, bias, groups, eps, silu)


ARMS = {"one call": groupnorm.group_norm_silu, "two calls": two_call_group_norm_silu,
        "plain": groupnorm.group_norm_reference}
RESOLUTIONS = ((768, 768), (576, 768))
BASELINE_HW = (480, 640)
BASELINE = dict(denoising_steps=50, ensemble_size=10, noise="pyramid", processing_res=0, batch_size=0, seed=1234)


def use(arm: str) -> None:
    layers.group_norm_silu = ARMS[arm]


def synced_ms(fn) -> tuple:
    """(host ms of one call with the card synchronised before and after, the GroupNorm kernels it launched)."""
    groupnorm.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, dict(groupnorm.launches)


def summary(times: dict) -> dict:
    """Each arm's median and range, and against the one call: the median of the per-round differences (the arm
    minus the one call, ms), their range and the rounds the one call won."""
    out = {"median_ms": {arm: statistics.median(t) for arm, t in times.items()},
           "range_ms": {arm: [min(t), max(t)] for arm, t in times.items()}, "against_one_call": {}}
    for arm in list(times)[1:]:
        diffs = [a - o for a, o in zip(times[arm], times["one call"])]
        out["against_one_call"][arm] = {"median_diff_ms": statistics.median(diffs),
                                        "range_ms": [min(diffs), max(diffs)],
                                        "one_call_won": sum(d > 0 for d in diffs), "rounds": len(diffs)}
    return out


def summary_text(row: dict, digits: int = 2) -> str:
    med, rng = row["median_ms"], row["range_ms"]
    arms = ", ".join(f"{arm} median {med[arm]:.{digits}f} ({rng[arm][0]:.{digits}f} .. {rng[arm][1]:.{digits}f})"
                     for arm in med)
    vs = "; ".join(f"{arm} - one call: median {d['median_diff_ms']:.{digits}f} ms ({d['range_ms'][0]:.{digits}f} .. "
                   f"{d['range_ms'][1]:.{digits}f}), one call ahead in {d['one_call_won']} of {d['rounds']}"
                   for arm, d in row["against_one_call"].items())
    return f"host ms: {arms}; {vs}"


def in_turns(label: str, fn, pairs: int) -> dict:
    """`pairs` rounds of calls, the arms in turns (one call, two calls, plain, then plain, two calls, one call,
    ...), after one warm-up call of each arm."""
    for arm in ARMS:
        use(arm)
        fn()
    times: dict = {arm: [] for arm in ARMS}
    launches: dict = {}
    for i in range(pairs):
        for arm in (list(ARMS) if i % 2 == 0 else list(ARMS)[::-1]):
            use(arm)
            ms, n = synced_ms(fn)
            times[arm].append(ms)
            launches[arm] = n
    use("one call")
    row = {"ms": times, **summary(times), "launches": launches}
    print(f"[{label}] {pairs} rounds in turns, " + summary_text(row) + f"; GroupNorm kernel launches a call: "
          f"{launches}", flush=True)
    return row


def train_ab(steps: int) -> dict:
    """The E2E train step, each arm's steps in turns (one call, two calls, plain, plain, two calls, one call), with each
    arm's peak."""
    models = MarigoldPipeline.from_random(UNetConfig.sd2(), VAEConfig(), seed=1, device="cuda")
    empty = np.random.default_rng(1).normal(size=(1, 77, 1024)).astype(np.float32)
    config = TrainConfig(gradient_checkpointing=True, gradient_accumulation_steps=1, lr_warmup_steps=0)
    trainer = E2ETrainer(config, models.unet, models.vae, empty, compute_dtype=torch.bfloat16)
    del models
    rng = np.random.default_rng(3)
    batch = {"rgb": rng.uniform(-1, 1, (2, 480, 640, 3)).astype(np.float32),
             "val_mask": np.ones((2, 480, 640), bool), "target": rng.uniform(-1, 1, (2, 480, 640)).astype(np.float32)}
    state = trainer.init_state()
    times: dict = {arm: [] for arm in ARMS}
    peaks: dict = {arm: 0.0 for arm in ARMS}
    launches: dict = {}
    for arm in [*ARMS, *reversed(ARMS)]:
        use(arm)
        state, _ = trainer.train_step(state, batch)  # the arm's warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(steps):
            def step():
                nonlocal state
                state, _ = trainer.train_step(state, batch)
            ms, launches[arm] = synced_ms(step)
            times[arm].append(ms)
        peaks[arm] = max(peaks[arm], torch.cuda.max_memory_allocated() / 2**30)
    use("one call")
    row = {"ms": times, **summary(times), "peak_gib": peaks, "launches": launches}
    print(f"[train 480x640 bs 2] {steps} steps an arm's turn, two turns an arm (one call, two calls, plain, plain, "
          f"two calls, one call), " + summary_text(row, 1) + "; peak device memory GiB: "
          + ", ".join(f"{arm} {p:.3f}" for arm, p in peaks.items()) + f"; GroupNorm kernel launches a step: {launches}",
          flush=True)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=10, help="serving rounds at each resolution")
    ap.add_argument("--baseline-pairs", type=int, default=3)
    ap.add_argument("--train-steps", type=int, default=3, help="timed steps of each arm's two turns")
    ap.add_argument("--out", default="chiprun_out/torch_gn_route_ab.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_gn_route_ab: needs a CUDA device")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, f"; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    out = {"card": card}
    pipe = MarigoldPipeline.from_random(UNetConfig.sd2(), VAEConfig(), seed=0, device="cuda", dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    for hw in RESOLUTIONS:
        img = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
        out[f"serve_{hw[0]}x{hw[1]}"] = in_turns(f"serve {hw[0]}x{hw[1]}", lambda: pipe(img, processing_res=max(hw),
                                                                                         color_map=None), args.pairs)
    img = rng.integers(0, 256, (*RESOLUTIONS[0], 3), dtype=np.uint8)
    with open(os.path.splitext(args.out)[0] + "_profile.txt", "w") as tables:
        for arm in ARMS:
            use(arm)
            profile_requests(lambda: pipe(img, processing_res=max(RESOLUTIONS[0]), color_map=None),
                             f"{arm} {RESOLUTIONS[0][0]}x{RESOLUTIONS[0][1]}", 3, tables)
    use("one call")
    img = rng.integers(0, 256, (*BASELINE_HW, 3), dtype=np.uint8)
    out["baseline_480x640"] = in_turns("baseline 480x640 50 steps ensemble 10",
                                       lambda: pipe(img, color_map=None, **BASELINE), args.baseline_pairs)
    del pipe
    torch.cuda.empty_cache()
    out["train_480x640_bs2"] = train_ab(args.train_steps)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"numbers: {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
