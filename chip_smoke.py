"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. the card: `nvidia-smi` name and power limit, torch and CUDA versions;
2. build: the CUDA sources under `diffusion_e2e_ft_tpu_torch/csrc/` with nvcc;
3. the flash-attention forward kernel against its plain PyTorch version on
   the card, fp32 and bf16, at the serving path's attention shapes (768x768
   and 576x768, whose 432-token level is ragged for the kernel's tiles) and
   ragged ones (257 keys: one valid column in the last KV tile; 256: whole
   tiles; Lq ragged against the 128-row Q tile): max |delta| / max |plain|
   against the plain version in fp32, and, in bf16, the kernel's time beside
   the plain version's and `scaled_dot_product_attention`'s (CUDA events);
   then q, k, v as strided views of one projection and Lq != Lk;
4. the backward kernels (forward+LSE, dq, dk/dv) through the autograd
   Function, against plain fp32 autograd on `flash_attention_reference` (head
   by head), at the 480x640 bs-2 training shapes of SD2 and of GeoWizard's
   joint attention (d = 40, 80, 160) and ragged ones, fp32 and bf16, bounded
   by max |delta| / max |plain|; at every bf16 training shape each kernel's
   time beside its plain version's, the library's (SDPA's backward computes
   dq, dk and dv in one call) and its bound; then `kernels.joint_attention`
   under grad at GeoWizard's joint shape (one forward+LSE, one dq, one dk/dv
   launch) against plain fp32 autograd;
4b. the GroupNorm kernels: the statistics kernel and the fused
   GroupNorm+SiLU -> conv3x3 kernels, v1 (statistics, fold, conv) and v2 (one
   cooperative launch), against their plain versions at every GN -> conv
   shape of the 480x640 bs-2 frozen VAE, ragged ones and one at C = 64 (where
   v2 cuts each row into 8 parts), fp32 and bf16, with a non-zero GroupNorm
   bias, bounded as the backward kernels; the statistics and v2 each twice
   for identical bits; and their times (events around one call and around
   calls back to back) beside the plain versions' and the bound;
4c. the standalone GroupNorms: `groupnorm.group_norm_kernel` (one C call:
   one launch of the one-launch kernel where a (b, g) slab fits a cluster's
   shared memory, else the statistics kernel then the apply kernel; the
   kernels launched checked against the rule) against
   `group_norm_reference`, and the apply alone against
   `group_norm_apply_reference`, at every shape that the serving, ensemble,
   eval, parity and train paths below send a standalone GroupNorm (derived
   from the modules at each path's batches: `route_paths`, `route_shapes`;
   the in-process paths' launches are recorded and must fall at these
   shapes) and at ragged ones (`GROUP_CASES`), fp32 and bf16 (the affine
   fp32 or bf16, the SiLU on or off, the mean 0.5 or 3, in turns; x one value
   off its output's alignment at every fourth shape), bounded as 4b, two
   calls bit-identical; and at the Marigold 768x768 request's shapes the
   port's GroupNorm's, the two-kernel route's, the statistics', the apply's,
   the plain version's, `F.group_norm` (+ `F.silu`)'s and, for the apply,
   `torch.addcmul`'s times beside the bounds, the host microseconds a call,
   and their sums over one request;
5. end-to-end parity, fp32 with TF32 off: a full-width SD2 Marigold pipeline
   with seeded random weights runs one 256x256 image, depth and normals, on
   the CPU (plain path) and on the GPU (kernel path: 12 attention kernel
   launches each, and the GroupNorm kernels at each of the 113 standalone
   GroupNorms of the encoder, the UNet and the decoder: one launch at 112,
   statistics + apply at the decoder's [1, 256, 256, 256]);
6. serving, slice A's main path: the same weights written as an HF pipeline
   directory (bf16 `.bin` files), loaded with `MarigoldPipeline.from_hf_dir`
   on the GPU in bf16, and a `PipelineService` answering 768x768 depth,
   768x768 normals and 576x768 depth requests (17 attention kernel launches
   each; every GroupNorm is standalone, as serving keeps
   `fused_gn_conv=False`: a 768x768 request 93 one-launch GroupNorms and 20
   of statistics + apply, a 576x768 one 101 and 12), with latency and peak
   device memory;
7. training parity, fp32 with TF32 off, with the default
   `fused_vae_kernels=True`: one E2E train step's loss and gradients
   (full-width SD2 UNet and VAE, seeded random weights, 256x256, depth and
   normals, a mask with invalid pixels, UNet checkpointing) on the CPU (plain
   path) and on the GPU (kernels), the launches of each kernel (48 GN -> conv
   pairs in the VAE), and a non-zero gradient at every UNet kernel site's
   q/k/v projections;
8. training, the main path of slices D1 and D2: `E2ETrainer` with the default
   `TrainConfig` + `run_training` at 480x640, batch 2, bf16 compute with fp32
   master weights, on synthetic batches, with the launches of each kernel per
   step, ms/step, img/s and peak device memory; then two micro-steps with
   gradient accumulation 2, where only the second moves the weights; then the
   unfused VAE (`fused_vae_kernels=False`) and the fused one, a few steps
   each, in turns (unfused, fused, fused, unfused), for the A/B; then a few
   steps with the single-launch v2 kernel (`E2EFT_GNCONV_IMPL=v2`), whose
   first loss matches v1's, with their ms beside v1's;
9. GeoWizard's attention kernels: the forward at d = 40, 80 and 160 and the
   heads-per-block forward (hp 2, 4, 8 at d = 40) against the plain version
   (head by head in fp32) at the joint-attention shapes of 768x768 and
   576x768 and ragged ones, fp32 and bf16, bounded as phase 3, with bf16
   times beside the plain version's and PyTorch's
   `scaled_dot_product_attention` (a yardstick only);
10. GeoWizard end-to-end parity, fp32 with TF32 off: a full-width GeoWizard
   (SD1.5 UNet with the class embedding and joint attention, the SD VAE, the
   CLIP ViT-L/14 image tower) with seeded random weights runs one 256x256
   and one 512x512 image on the CPU (plain path) and on the GPU (12 and 17
   kernel launches; at 512x512 every head dim, 40, 80 and 160, runs inside
   the model);
11. GeoWizard serving, slice B's main path: the same weights written as an HF
   pipeline directory with `image_encoder/`, loaded with
   `GeoWizardPipeline.from_hf_dir` in bf16 on the default device, answering
   768x768 and 576x768 requests for two domains (18 and 17 forward launches),
   with latency and peak device memory; then one 768x768 request with
   `E2EFT_FA_HP=2` (5 heads-per-block launches + 13 forward), which matches
   the hp = 1 outputs;
12. GeoWizard training parity, fp32 with TF32 off, the default fused VAE and
   UNet checkpointing: one joint step of the full-width GeoWizard (seeded
   random weights, 256x256, batch 1, a mask with invalid pixels) on the CPU
   (plain path) and on the GPU (kernels), in E2E mode (loss, per-loss
   metrics, gradient norm, leaves) and in diffusion-loss mode (the same
   explicit t and noise on both sides), bounded as phase 7, with each
   kernel's launches and a non-zero gradient at every joint kernel site's
   q/k/v projections and at the class embedding;
13. GeoWizard training, slice B2's main path: `GeoWizardTrainer` with the
   default `TrainConfig` (E2E, zeros noise, fused VAE, UNet checkpointing) +
   `run_training` at 480x640, batch 2, bf16 compute with fp32 master
   weights, on synthetic joint batches, with the launches of each kernel per
   step (those of phase 8: the decode is one call at 2B), ms/step, img/s and
   peak device memory; then a few diffusion-loss steps (two encodes, no
   decode) and a few pyramid-noise steps, each with its launches;
14. slice C's parity, fp32 with TF32 off: a full-width SD2 Marigold with
   seeded random weights at 256x256 on the CPU (plain path) and the GPU
   (kernels), given the same explicit draws: DDIM, ancestral DDPM and LCM at
   3 steps, then a 3-member pyramid-noise ensemble, its members bounded as
   phase 5; `combine_depths` on the CPU's BFGS (s, t), on the card, held to
   the CPU's at 1e-5 on the same members and within the bound that the
   members' error implies on the card's own; and the whole
   `ensemble_depths` within the BFGS drift bound;
15. slice C's main path, bf16, on phase 6's HF directory loaded again with
   `from_hf_dir`: (a) Marigold's multi-step baseline (480x640 at
   processing_res 0, 50-step trailing DDIM, ensemble 10, pyramid noise,
   seed 1234, `find_batch_size`'s batch), a first request and six warm
   ones (the last with another seed) with their latency (median, min, max),
   kernel 1's launches a request against the count from the sites, peak
   memory, the BFGS host time, the same bits for the same seed and other
   bits for another; (b) the same weights with an `LCMScheduler` config, 4
   steps, ensemble 4, gaussian noise, 768x768; (c) after phase 11, on its
   pipeline, a GeoWizard ensemble (576x768, 10 steps, ensemble 10, pyramid
   noise, 5 members a call). The shapes kernel 1 ran at in (a)-(c) must be
   those phases 3 and 3c held against the plain version. Phases 14 and 15
   run scipy's BFGS under `warnings.catch_warnings`: each RuntimeWarning is
   printed with its file and line, and the first members that warned are
   written to `chiprun_out/bfgs_warned_members.npz`
   (`perf/torch_ensemble_warning.py` runs them through the JAX package);
16. slice E1's main path, the evaluation CLIs, bf16, on phase 6's HF
   directory: (a) the host's image IO (g++, png.h, jpeglib.h, whether
   `native_io` built, whether PIL, cv2 and PyYAML import: the path needs
   none of them); (b) a synthetic NYU-layout tar of four 480x640 frames (RGB,
   16-bit depth and filled depth PNGs; one RGB frame's rows all Paeth) with
   a dataset config of `config/dataset/data_nyu_test.yaml`'s keys; (c) a
   KITTI-layout tree (one 375x1242 frame and a `None` line); (d)
   `cli.infer` on each at native resolution, one step, zeros noise: a finite
   [0, 1] `.npy` a frame (480x640, 352x1216; KITTI twice, the first call
   at its shape cold), 17 kernel-1 launches a frame, `arguments.txt`, each
   frame's host ms split into read+decode, pipeline and save, peak memory;
   after phase 15 (c), two NYU frames with `--model_type geowizard` on
   slice B's weights; (e) `cli.eval_depth` on the dumps with
   both alignments on the card: ten finite metrics, the same files on the
   CPU within 1e-5 relative, and predictions made an exact affine map of the
   GT (of 1/GT for disparity) give abs_rel <= 1e-5 and delta1 = 1; (f)
   `cli.eval_normals` on a two-frame DSINE nyuv2 tree: eight finite values;
   (g) `cli.run_marigold` over two 576x768 PNGs, then again under
   `--profile_dir` (kernel 1 in the trace): `depth_bw` read back by the
   port's decoder equals `to_uint16(depth_np)`. The shapes kernel 1 ran at
   must be those phase 3c held against the plain version;
17. slice E2's main path, the training data, on phase 6's HF directory: (a)
   which of PIL, cv2, pandas and h5py import (the readers need PIL; without
   h5py, 17b feeds the frames' arrays to `preprocess_scene_frames`); (b) a
   synthetic raw Hypersim tree (18 frames of 768x1024 linear HDR colour,
   distance with NaN pixels, render-entity ids with -1, the
   `geometry_preview` normal PNGs) through `cli.preprocess_hypersim --device
   cuda`, one scene's PNGs and CSV rows held against `--device cpu` (rgb 1
   level, depth 1 mm, rows equal), ms a frame; (c) a synthetic VKITTI2 tree
   (two 375x1242 frames, JPEG rgb, 16-bit cm depth with a ground plane, a
   slanted wall, a box and the sky) through `cli.gen_vkitti_normals --device
   cuda`, the normals held against `depth_to_normal(..., device="cpu")` in
   float64 (1e-12), the MRF choice equal on every pixel, the written PNGs
   within 1 LSB, ms a frame on the card and the CPU; (d) the real
   `cli.train` on the two trees, bf16, UNet checkpointing, bs 2, two 9:1
   epochs, for normals and for depth: both shapes (480x640 and the VKITTI2
   crop's 352x1216) ran, finite losses, `step_launches(15)` a step at each,
   every kernel launched only at a shape phases 3, 3c, 4, 4b and 4c hold against
   the plain version, ms/step at each shape, peak memory, each reader's host
   ms a sample, the step loop's waits on `Prefetcher`, and the export loading
   with `MarigoldPipeline.from_hf_dir`;
18. slices F and D3, in three parts placed where their weights are at hand:
   (b) after phase 15 (a), on its HF directory, and after phase 16's
   GeoWizard frames, on phase 11's pipeline: `with_mesh` on [cuda:0,
   cuda:0], a seeded 10-member pyramid ensemble at 480x640 in bf16 (4 DDIM
   steps, two members a call, the second position given a replica of its
   own, as a second card would hold) against no mesh (one a call): the
   members to the bit, then the outputs; (c) after phase 8, on its
   weights: the remat policies' gradients ("dots", "dots_all") against the
   no-checkpoint gradients, then one SD2 step at 480x640 bs 2 in bf16 for each
   D3 option (save nothing, "dots", "dots_all", `vae_decode_checkpoint`, a
   bf16 Adam moment), each from the same weights, with ms/step, peak memory,
   launches and losses against the default's; the sub-pixel decoder against
   the resize one in fp32 at 768x768, and each bf16 decode's ms and peak;
   (a) last, slice F's main path, in processes of its own after this one
   has freed its models (phases 8 and 13 leave their weights in a temporary
   directory): a reference process runs the fp32 SD2 step (pyramid noise,
   rows with unequal valid counts) on the whole 480x640 global batch of 2,
   then a 1-rank NCCL group's bf16 steps; two ranks on cuda:0 over gloo
   (NCCL refuses two ranks on one card) run the same fp32 step on a row each,
   whose loss, grad norm and every parameter after the step must equal the
   reference's within `DP_BOUNDS`, then bf16 SD2 and GeoWizard joint steps on
   their rows, with ms/step, peak memory a rank, `step_launches(15)` a step
   and every kernel shape one that phases 3, 3c, 4, 4b and 4c hold (phases 4 and
   4b include the shapes of one row a rank);
19. slices F2 and G, after phase 18a in processes of its own: (a) two gloo
   ranks on cuda:0 as mesh (data 1, fsdp 2), each holding both rows of the
   480x640 global batch and half of every state leaf of at least 2^18
   elements (`shard_state`): the bf16 SD2 and GeoWizard joint steps, with
   ms/step and the parameters' all-gather's ms of it, the state's bytes a
   rank against the rule's count (5.23 GB of SD2's fp32 masters and
   moments), what the UNet holds between steps (no sharded tensor), the
   peak a rank against phase 18a's one-process run on the same rows,
   `step_launches(15)` a step and every kernel shape one that phases 3, 3c,
   4, 4b and 4c hold; (b) the fp32 step from sharded state against 18a's
   reference process, within `DP_BOUNDS`; (c) that state's checkpoint,
   saved by the group, restored into zeroed shards (equal to the bit) and
   one more step; then (d) `tools/export_roundtrip` at full width on the
   card, fp32 and bf16, at a 480x640 probe (kernel 1 at the NYU frames'
   shapes): every row zero;
20. slice E3, the card against the JAX package's own numbers: the committed
   goldens (`tests/golden/*.npz`, written by `tests/golden/make_goldens.py`
   with JAX on a CPU), whose weights the numpy rule of
   `tests/_torch_golden.py` draws again here (digest checked) and
   `tests/_torch_golden_port.py` runs through the port on cuda:0 in fp32,
   kernels on: Marigold depth and normals and the SD2 depth train step
   (fused VAE; again under `E2EFT_GNCONV_IMPL=v2`) at SD2 width, GeoWizard
   at SD1.5 / CLIP ViT-L width (again under `E2EFT_FA_HP=2`), all at
   256x256 with the UNets one block a level, and the tiny Marigold single
   step and SD2 train steps of the CPU tests; each output within the port's
   CPU-vs-JAX bound plus the card-vs-CPU bound of phases 5 and 7
   (`card_bounds`), every one of kernels 1-8, the GroupNorm apply and the
   one-launch GroupNorm launched (counts printed); then
   the card goldens' Marigold and GeoWizard in bf16, max |delta| against the
   fp32 goldens printed, unbounded.

Phase 3c runs the forward kernel at every shape phase 15's requests send
it, worked out from their sizes: the baseline's chunk of 10 at 480x640
([10, 4800, 5, 64], [10, 1200, 10, 64], [10, 300, 20, 64], the decoder's
[10, 4800, 1, 512], the encoder's [1, 4800, 1, 512]), the LCM request's 4
at 768x768 and the GeoWizard ensemble's 5 at 576x768 (joint [5, 13824, 8,
40], [5, 3456, 8, 80], [5, 864, 8, 160], the decoder's [10, 6912, 1, 512]),
and at the table's batch for 10 members at 768x768 ([10, 9216, 5, 64],
[10, 9216, 1, 512], on no phase 15 request), against the plain version row
by row; and at every shape phase 16's frames send it: NYU's 480x640
([1, 4800, 5, 64], [1, 1200, 10, 64], [1, 300, 20, 64], [1, 4800, 1,
512]), KITTI's 352x1216 crop ([1, 6688, 5, 64], [1, 1672, 10, 64], [1, 418,
20, 64], [1, 6688, 1, 512]) and GeoWizard's 480x640 ([1, 9600, 8, 40], [1,
2400, 8, 80], [1, 600, 8, 160]; its decode at [2, 4800, 1, 512] is phase
3's).
Phases 3, 4 and 4b include the VKITTI2 step's shapes (352x1216 bs 2, a
44x152 latent): kernel 1 at the frozen encoder's [2, 6688, 1, 512], kernels
3-5 at [2, 6688, 5, 64], [2, 1672, 10, 64], [2, 418, 20, 64] and the
decoder's [2, 6688, 1, 512], and the VAE's GN -> conv pairs at 352x1216,
176x608, 88x304 and 44x152 (widths ragged against the conv's 64-pixel
tiles), with the GroupNorm kernels' sums per VKITTI2 step. They include the
joint step's new shapes: the VAE mid
attention at [2, 4800, 1, 512] and [4, 4800, 1, 512] (the decoder at 2B
under grad) and every GN -> conv shape of the encoder at B = 2 and 4 and the
decoder at B = 4, with the GroupNorm kernels' sums per joint step.

Every kernel's row in the JSON line carries its bound: the larger of the
bytes it must move over 3.35 TB/s and its operations over 989 TFLOP/s (bf16,
the H100 SXM's dense peaks), from this run's shapes, and the time of one
PyTorch call that computes the same function (`library_ms`), timed here and
used nowhere in the port. The line before the last is that JSON object; the
last line is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from typing import Optional

# One card: every phase runs on cuda:0, and the result line counts what the
# process can see. Set before torch touches CUDA.
os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]

import numpy as np
import torch
import torch.nn.functional as F

# Kernel vs plain in fp32 on the same inputs, as max|d| / max|plain|: an
# attention output is a softmax-weighted mean of V, so at 18432 keys its values
# are ~0.01 and an absolute bound of 2e-2 would pass a wrong kernel.
FP32_BOUND = 1e-4  # fp32: summation order only
BF16_BOUND = 2e-2  # bf16 in, bf16 P, bf16 out; read 8.5e-3 at most (H100)
E2E_BOUNDS = {  # fp32 pipeline output, GPU vs CPU (cuDNN vs CPU conv summation order)
    "depth": 1e-3,
    "normals": 5e-3,  # unit-normalizing amplifies differences where |decoded| is small
}
# (B, L, N, D). The bf16 kernel's tiles (Q rows x KV rows): 128 x 64 at d = 64, 64 x 32 at d = 512;
# fp32 64 x 64 and 16 x 16
ATTN_CASES = [
    (1, 9216, 5, 64),  # 768x768: UNet levels 0-2, VAE mid
    (1, 2304, 10, 64),
    (1, 576, 20, 64),
    (1, 9216, 1, 512),
    (1, 6912, 5, 64),  # 576x768: UNet levels 0-2, VAE mid
    (1, 1728, 10, 64),
    (1, 432, 20, 64),  # ragged: 3 * 128 + 48 Q rows, 6 * 64 + 48 KV rows
    (1, 6912, 1, 512),
    (2, 4800, 1, 64),  # 480x640 level 0
    (2, 4800, 1, 512),  # the 480x640 bs-2 frozen encoder's mid block (every train step)
    (4, 4800, 1, 512),  # ... of GeoWizard's GT geometry at 2B (its diffusion-loss step)
    (2, 6688, 1, 512),  # ... at 352x1216 bs 2, the VKITTI2 step of the 9:1 mix (phase 17)
    (2, 300, 3, 64),  # ragged: 2 * 128 + 44, 4 * 64 + 44
    (3, 300, 1, 512),  # ragged: 4 * 64 + 44, 9 * 32 + 12 (fp32 18 * 16 + 12)
    (2, 257, 3, 64),  # one valid column in the last KV tile
    (1, 256, 4, 64),  # exactly two Q tiles and four KV tiles
    (1, 257, 2, 512),
    (1, 256, 1, 512),
]
# q, k, v as views of one [B, L, 3 N D] projection (row stride 3 N D), and Lq != Lk: (B, Lq, Lk, N, D)
LAYOUT_CASES = [(2, 1000, 1000, 8, 40), (2, 1000, 1000, 5, 64), (1, 300, 257, 2, 64), (1, 200, 513, 8, 40),
                (1, 129, 300, 1, 512)]
SITES_256 = 12  # kernel launches for one 256x256 image
SITES_768 = 17  # kernel launches for one 768x768 or 576x768 image
# (B, L, N, D): the 480x640 bs-2 training sites of SD2 and of GeoWizard's joint attention (2 L tokens), then
# ragged ones, ragged against the bf16 tiles (`BWD_TILES`: 64, 32 or 16 rows) and the fp32 ones (64, 32, 16)
BWD_TRAIN_CASES = [
    (2, 4800, 5, 64),  # SD2 UNet level 0
    (2, 1200, 10, 64),  # level 1
    (2, 300, 20, 64),  # level 2, ragged: 4 * 64 + 44
    (2, 4800, 1, 512),  # VAE decoder mid (differentiated)
    (2, 9600, 8, 40),  # GeoWizard joint level 0
    (2, 2400, 8, 80),  # level 1
    (2, 600, 8, 160),  # level 2: 9 * 64 + 24, 18 * 32 + 24
    (4, 4800, 1, 512),  # GeoWizard's VAE decoder mid block at 2B (differentiated)
    (2, 6688, 5, 64),  # SD2's VKITTI2 step at 352x1216 bs 2 (a 44x152 latent): UNet level 0
    (2, 1672, 10, 64),  # level 1
    (2, 418, 20, 64),  # level 2, ragged: 6 * 64 + 34, 13 * 32 + 2
    (2, 6688, 1, 512),  # VAE decoder mid (differentiated)
]
# the same sites at one row a rank: phase 18's two data-parallel ranks of a 480x640 global batch of 2
BWD_DP_CASES = [(1, 4800, 5, 64), (1, 1200, 10, 64), (1, 300, 20, 64), (1, 4800, 1, 512),  # SD2
                (1, 9600, 8, 40), (1, 2400, 8, 80), (1, 600, 8, 160)]  # GeoWizard's joint attention (its decode: 2B)
BWD_CASES = BWD_TRAIN_CASES + BWD_DP_CASES + [
    (2, 300, 3, 64),
    (3, 300, 1, 512),  # ragged: 4 * 64 + 44, 9 * 32 + 12, 18 * 16 + 12
    (2, 300, 8, 40),  # ragged: 4 * 64 + 44, 9 * 32 + 12
    (3, 333, 2, 80),  # 5 * 64 + 13, 10 * 32 + 13
    (1, 257, 4, 160),  # one valid row in the last tile, either side
]
GRAD_ROUTE_SHAPE = (4, 4800, 8, 40)  # GeoWizard's joint [2B, L, N, D] at 480x640 bs 2, under grad


def vae_pairs(h: int, w: int) -> tuple:
    """The SD VAE's GN -> conv pairs at an h x w image, (C, H, W, Cout): how many. The encoder's 20 (5
    ResnetBlocks of its 4 levels and mid block, two pairs each) and the decoder's 28 (14 ResnetBlocks)."""
    def at(level):
        return h >> level, w >> level

    encoder = {(128, *at(0), 128): 4, (128, *at(1), 256): 1, (256, *at(1), 256): 3,
               (256, *at(2), 512): 1, (512, *at(2), 512): 3, (512, *at(3), 512): 8}
    decoder = {(512, *at(3), 512): 10, (512, *at(2), 512): 6, (512, *at(1), 256): 1,
               (256, *at(1), 256): 5, (256, *at(0), 128): 1, (128, *at(0), 128): 5}
    return encoder, decoder


ENCODER_PAIRS, DECODER_PAIRS = vae_pairs(480, 640)
VKITTI_HW = (352, 1216)  # the VKITTI2 reader's KITTI-benchmark crop: one batch in ten of the 9:1 mix
VKITTI_ENCODER_PAIRS, VKITTI_DECODER_PAIRS = vae_pairs(*VKITTI_HW)
VAE_PAIRS = sum(ENCODER_PAIRS.values()) + sum(DECODER_PAIRS.values())  # 48
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 tensor cores
PEAK_FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
GEO_ATTN_CASES = [  # (B, L, N, D): GeoWizard's joint self-attention (2L tokens), then ragged ones
    (1, 18432, 8, 40),  # 768x768: level 0 (the tiles: 64 rows), level 1, level 2, mid block
    (1, 4608, 8, 80),
    (1, 1152, 8, 160),
    (1, 288, 8, 160),
    (1, 13824, 8, 40),  # 576x768 (its 216-token mid block is plain)
    (1, 3456, 8, 80),
    (1, 864, 8, 160),
    (2, 300, 8, 40),  # ragged: 2 * 128 + 44 Q rows, 4 * 64 + 44 KV rows
    (1, 437, 8, 160),  # ragged: 6 * 64 + 53 (fp32 13 * 32 + 21)
    (3, 333, 2, 80),
    (1, 257, 8, 40),  # one valid column in the last KV tile
    (1, 256, 8, 80),
    (1, 257, 4, 160),
]
MH_HEADS = (2, 4, 8)
# forward launches per GeoWizard parity image: 10 UNet + 2 VAE at 256x256 (level 2's 128 joint
# tokens and the mid block are plain), 15 + 2 at 512x512 (only the 128-token mid block is plain)
GEO_PARITY_SITES = {256: 12, 512: 17}
GEO_SITES = {(768, 768): 18, (576, 768): 17}  # ... per 768x768 / 576x768 request
GEO_MH_SITES = 5  # the d=40 sites of a 768x768 request, under E2EFT_FA_HP=2


@functools.lru_cache(maxsize=None)
def norm_records(part: str, b: int, hw: tuple, fused: bool = False, config=None) -> tuple:
    """(the (B, C, H, W) input, the groups) of each standalone GroupNorm, in
    order, that one forward of `part` ("unet", "encoder" or "decoder") visits
    at batch b and an hw image: the GroupNormAct modules of the module tree
    record their input, on the meta device (no memory, no kernel). `fused`:
    the fused VAE, whose ResnetBlocks run their two GroupNorms inside the
    GN -> conv pairs, outside this route. `config`: a UNetConfig or VAEConfig
    (default SD2's / the SD VAE's)."""
    from diffusion_e2e_ft_tpu_torch.models import AutoencoderKL, UNet2DCondition, UNetConfig, VAEConfig
    from diffusion_e2e_ft_tpu_torch.models.layers import GroupNormAct, ResnetBlock

    h, w = hw[0] // 8, hw[1] // 8
    with torch.device("meta"):
        if part == "unet":
            c = config or UNetConfig.sd2()
            model = UNet2DCondition(c)
            labels = (torch.empty(b, c.class_embed_proj_dim),) if c.class_embed_proj_dim else ()
            run = lambda: model(torch.empty(b, c.in_channels, h, w), torch.full((b,), 999),  # noqa: E731
                                torch.empty(b, 77, c.cross_attention_dim), *labels)
        else:
            c = dataclasses.replace(config or VAEConfig(), fused_gn_conv=False)
            model = AutoencoderKL(c)
            run = ((lambda: model.encode_mean(torch.empty(b, c.in_channels, *hw))) if part == "encoder"
                   else (lambda: model.decode(torch.empty(b, c.latent_channels, h, w))))
    paired = {id(n) for m in model.modules() if isinstance(m, ResnetBlock) for n in (m.norm1, m.norm2)} if fused \
        else set()
    seen: list = []

    def visit(module, x):  # a GroupNorm keeps its input's shape: record it and skip the math on meta tensors
        if id(module) not in paired:
            seen.append((tuple(x.shape), module.groups))
        return x

    forward, GroupNormAct.forward = GroupNormAct.forward, visit
    try:
        with torch.no_grad(), torch.device("meta"):
            run()
    finally:
        GroupNormAct.forward = forward
    return tuple(seen)


def norm_visits(part: str, b: int, hw: tuple, fused: bool = False, config=None) -> tuple:
    """The (B, C, H, W) input of each standalone GroupNorm of `norm_records`, in order."""
    return tuple(shape for shape, _ in norm_records(part, b, hw, fused, config))


def norm_count(part: str, fused: bool = False, config=None) -> int:
    """Standalone GroupNorms of one forward of `part`."""
    return len(norm_visits(part, 2, (256, 256), fused, config))  # batch 2: a joint-attention pair


def request_norms(chunks: int, steps: int, unet_config=None, vae_config=None) -> int:
    """Standalone GroupNorms of one serving request (Marigold or GeoWizard):
    each chunk of members encodes once, runs the UNet `steps` times and
    decodes once, with the unfused VAE."""
    return chunks * (steps * norm_count("unet", config=unet_config) + norm_count("encoder", config=vae_config)
                     + norm_count("decoder", config=vae_config))


GN_ROUTE_KERNELS = ("gn_group", "gn_channel_stats", "gn_apply")


def gn_launches(part: str, hw: tuple, dtype, fused: bool = False, config=None) -> dict:
    """The GroupNorm kernels' launches of one forward of `part` at an hw image
    in `dtype`, at any batch (a slab is one image's group): `gn_group` at each
    standalone GroupNorm whose slab fits (`groupnorm.group_fits`), the
    statistics and the apply at each other one."""
    from diffusion_e2e_ft_tpu_torch.kernels.groupnorm import group_fits

    records = norm_records(part, 2, tuple(hw), fused, config)  # batch 2: a joint-attention pair
    one = sum(group_fits(shape, dtype, groups) for shape, groups in records)
    return {"gn_group": one, "gn_channel_stats": len(records) - one, "gn_apply": len(records) - one}


def gn_sum(*terms) -> dict:
    """The GroupNorm kernels' launches of (count, launches) terms, added kernel by kernel."""
    return {name: sum(k * launches[name] for k, launches in terms) for name in GN_ROUTE_KERNELS}


def request_gn(hw: tuple, dtype, chunks: int = 1, steps: int = 1, unet_config=None, vae_config=None) -> dict:
    """The GroupNorm kernels' launches of one serving request (Marigold or
    GeoWizard) at an hw image in `dtype`: each chunk of members encodes once,
    runs the UNet `steps` times and decodes once, with the unfused VAE."""
    return gn_sum((chunks * steps, gn_launches("unet", hw, dtype, config=unet_config)),
                  (chunks, gn_launches("encoder", hw, dtype, config=vae_config)),
                  (chunks, gn_launches("decoder", hw, dtype, config=vae_config)))


def geo_request_gn(hw: tuple, dtype, chunks: int = 1, steps: int = 1) -> dict:
    """`request_gn` of GeoWizard's UNet (SD1.5 widths, the class embedding, joint attention)."""
    from diffusion_e2e_ft_tpu_torch.models import UNetConfig

    return request_gn(hw, dtype, chunks, steps, UNetConfig.geowizard())


# Kernel launches of one train step with UNet checkpointing: the frozen
# encoder's mid attention takes the plain forward; each UNet kernel site runs
# forward+LSE twice (the checkpoint recomputes it) and the backward once; the
# decoder's mid attention runs forward+LSE and the backward once. With the
# fused VAE (`gn`: "v1" or "v2", None for unfused) every GN -> conv pair of
# the encoder and the decoder launches once; the backward recomputes the
# plain composite. Every standalone GroupNorm launches the GroupNorm kernels
# once a forward (`gn_launches`: one launch or statistics + apply, by its
# slab in the compute dtype; its backward recomputes the plain version): the
# UNet's twice (the checkpoint's recompute), the encoder's and the decoder's
# once; `decode_checkpoint` runs the decode twice. GeoWizard's E2E step
# launches the same (its decode is one call at 2B); its diffusion-loss step
# (`e2e=False`) decodes nothing and encodes twice (the image, then the GT
# geometry at 2B). `unet_config`: the UNet's config, when it is not SD2's;
# `hw` and `dtype`: the batch's images and the compute dtype.
def step_launches(unet_sites: int, gn: Optional[str] = "v1", e2e: bool = True, unet_config=None,
                  decode_checkpoint: bool = False, hw: tuple = (480, 640), dtype=torch.bfloat16) -> dict:
    decodes = e2e * (1 + decode_checkpoint)
    pairs = decodes * sum(DECODER_PAIRS.values()) + (1 if e2e else 2) * sum(ENCODER_PAIRS.values())
    fused = gn is not None
    route = gn_sum((2, gn_launches("unet", hw, dtype, config=unet_config)),
                   (1 if e2e else 2, gn_launches("encoder", hw, dtype, fused)),
                   (decodes, gn_launches("decoder", hw, dtype, fused)))
    return {"flash_attention_fwd": 1 if e2e else 2, "flash_attention_fwd_mh": 0,
            "flash_attention_fwd_lse": 2 * unet_sites + decodes, "flash_attention_bwd_dq": unet_sites + e2e,
            "flash_attention_bwd_dkv": unet_sites + e2e,
            "gn_channel_stats": pairs * (gn == "v1") + route["gn_channel_stats"], "gn_apply": route["gn_apply"],
            "gn_group": route["gn_group"], "gn_silu_conv3x3": pairs * (gn == "v1"),
            "gn_silu_conv3x3_v2": pairs * (gn == "v2")}


UNET_SITES_256 = 10  # UNet self-attention sites in the kernels' envelope at 256x256 (1024 and 256 tokens)
UNET_SITES_480x640 = 15  # ... at 480x640 (4800, 1200 and 300 tokens)
# GPU vs CPU, fp32, relative; read 1.2e-7, 1.9e-4 and 1.9e-4 at most on the H100 (cuDNN vs CPU conv order)
TRAIN_PARITY_BOUNDS = {"loss": 1e-5, "grad_norm": 1e-3, "leaf": 2e-3}
PARITY_LEAVES = ["conv_in.weight"] + [
    f"down_blocks.0.attentions.0.transformer_blocks.0.attn1.{p}.weight" for p in ("to_q", "to_k", "to_v", "to_out.0")
]
TRAIN_STEPS = 5  # optimizer steps on the training main paths (the first is the warm-up)
GEO_EXTRA_STEPS = 3  # GeoWizard diffusion-loss steps, then pyramid-noise steps, after its main path
GEO_TRAIN_SITES_256 = 10  # GeoWizard joint kernel sites at 256x256 (2048 and 512 joint tokens; 128 stay plain)
GEO_PARITY_LEAVES = ["conv_in.weight", "class_embedding.linear_1.weight"] + [
    f"down_blocks.0.attentions.0.transformer_blocks.0.attn1.{p}.weight" for p in ("to_q", "to_k", "to_v", "to_out.0")
]
AB_STEPS = 4  # steps of each arm of the fused / unfused A/B (the first is the warm-up)
V2_LOSS_BOUND = 1e-2  # bf16 step loss, v2 vs v1 relative: a, b folded in another order, through bf16 networks


# Slice C. Marigold's multi-step baseline as the repo's paper runs it
# (experiments/depth/eval_args/marigold_diffusion_baseline/11_infer_nyu.sh: trailing DDIM, 50 steps,
# ensemble 10, pyramid noise, --processing_res 0 on NYU's native 480x640, seed 1234), with the members a
# call from `find_batch_size`; an LCM request; and a GeoWizard ensemble
BASELINE_HW = (480, 640)
BASELINE = dict(denoising_steps=50, ensemble_size=10, noise="pyramid", processing_res=0, batch_size=0)
BASELINE_SEED = 1234
LCM_HW = (768, 768)
LCM_REQUEST = dict(denoising_steps=4, ensemble_size=4, noise="gaussian", processing_res=768, batch_size=0)
GEO_ENSEMBLE_HW = (576, 768)
GEO_ENSEMBLE = dict(denoising_steps=10, ensemble_size=10, noise="pyramid", processing_res=768, batch_size=5)
BASELINE_WARM = 5  # warm baseline requests with the same seed, after a first one; then one with another seed
SLICE_C_STEPS = 3  # phase 14's denoising steps a run
UNET_SITES_768 = SITES_768 - 2  # UNet self-attention sites in the envelope at 768x768 (9216, 2304, 576 tokens)
# Slice E1, the evaluation path (phase 16): the repo's eval scripts run at native resolution
# (--processing_res 0), single step, zeros noise, one frame a call; NYU frames are 480x640, KITTI's are
# 375x1242 cut to the 352x1216 benchmark crop; run_marigold's folder holds 576x768 frames
NYU_HW, KITTI_RAW_HW, KITTI_HW, RUN_HW = (480, 640), (375, 1242), (352, 1216), (576, 768)
NYU_FRAMES = 4
EVAL_SITES = 17  # kernel 1 a frame at each of these sizes: VAE encoder, 15 UNet sites, decoder (GeoWizard too)
EVAL_CPU_RTOL = 1e-5  # the ten depth metrics, --device cuda vs cpu on the same files (float32 sums' order)
KNOWN_ANSWER_ABS_REL = 1e-5  # an exact affine map of the GT, aligned back: float32 rounding only
SD2_ATTN = ((5, 10, 20, 20), (64, 64, 64, 64))  # UNet heads and head dim, levels 0-3
GEO_ATTN = ((8, 8, 8, 8), (40, 80, 160, 160))
# the first ensemble_depths call that raised a RuntimeWarning in phases 14 and 15: its members, for
# perf/torch_ensemble_warning.py (which runs them through the JAX package's ensemble on the CPU)
REPO_DIR = os.path.dirname(os.path.abspath(__file__))
WARNED_MEMBERS = os.path.join(REPO_DIR, "chiprun_out", "bfgs_warned_members.npz")
# ensemble_depths, GPU vs CPU: scipy's BFGS takes numerical gradients of a float32 objective with steps of
# 1.5e-8, below its rounding, so two summation orders of the same objective walk to other (s, t); the
# same bound as tests/test_torch_ensemble.py (JAX vs the port), from the spread measured there
ENSEMBLE_DRIFT = 0.1
# combine_depths (median / MAD or mean / std, min-max) on the same members and (s, t), GPU vs CPU: float32
# reductions in another order; the tests hold the port's to the JAX package's at the same bound
COMBINE_BOUND = 1e-5


def pair_launches(*parts) -> dict:
    """{(B, C, H, W, Cout): launches} of (batch, pairs) parts of a step."""
    out: dict = {}
    for b, pairs in parts:
        for shape, n in pairs.items():
            out[(b, *shape)] = out.get((b, *shape), 0) + n
    return out


# GN -> conv launches of each shape a step: SD2's (encoder and decoder at B = 2) and GeoWizard's joint
# steps at bs 2 (E2E: the decoder at 2B = 4; diffusion loss: the encoder again at 4)
GN_TRAIN_LAUNCHES = pair_launches((2, ENCODER_PAIRS), (2, DECODER_PAIRS))
GN_JOINT_LAUNCHES = pair_launches((2, ENCODER_PAIRS), (4, DECODER_PAIRS))
GN_JOINT_DIFFUSION_LAUNCHES = pair_launches((2, ENCODER_PAIRS), (4, ENCODER_PAIRS))
GN_VKITTI_LAUNCHES = pair_launches((2, VKITTI_ENCODER_PAIRS), (2, VKITTI_DECODER_PAIRS))  # SD2's VKITTI2 step
# (B, C, H, W, Cout): every GN -> conv shape of those steps (timed in bf16), then ragged ones
GN_TRAIN_SHAPES = list(dict.fromkeys([*GN_TRAIN_LAUNCHES, *GN_JOINT_LAUNCHES, *GN_JOINT_DIFFUSION_LAUNCHES,
                                      *GN_VKITTI_LAUNCHES]))
# ... and at one row a rank (phase 18: SD2's encoder and decoder, GeoWizard's encoder; its decoder at 2B = 2)
GN_DP_LAUNCHES = pair_launches((1, ENCODER_PAIRS), (1, DECODER_PAIRS))
GN_CASES = GN_TRAIN_SHAPES + [s for s in GN_DP_LAUNCHES if s not in GN_TRAIN_SHAPES] + [
    (1, 128, 37, 53, 128),  # ragged: 1961 pixels = 15 * 128 + 41; odd rows for the 16-byte vectors
    (2, 256, 1, 77, 128),  # H = 1: every tap but the middle row is padding
    (3, 128, 9, 9, 96),  # Cout ragged for the 64-wide channel tiles
    (1, 64, 240, 320, 64),  # C = 64, the kernels' own limit (the port's envelope is C % 128): v2 splits its rows
]
GN_BOUND = {torch.float32: FP32_BOUND, torch.bfloat16: BF16_BOUND}  # max|d| / max|plain fp32|


def kernel_modules() -> tuple:
    from diffusion_e2e_ft_tpu_torch.kernels import flash_attention, gn_conv, groupnorm

    return flash_attention, groupnorm, gn_conv


def reset_launches() -> None:
    for module in kernel_modules():
        module.reset_launches()


def read_launches() -> dict:
    """Every kernel's launches since the last `reset_launches()`."""
    return {name: n for module in kernel_modules() for name, n in module.launches.items()}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def roofline(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> dict:
    """The least time the card could take: the larger of the operations over
    their peak (default bf16's) and the bytes over the HBM rate."""
    ops_ms, bytes_ms = flops / peak_flops * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms), "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def attention_bound(shape, dtype, matmuls: int, tensors: int, fp32_rows: int = 0) -> dict:
    """`matmuls` L x L x d products per head, `tensors` [B, L, N, D] arrays in
    `dtype` and `fp32_rows` [B, L, N] fp32 arrays read or written once."""
    b, length, n, d = shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    return roofline(2.0 * matmuls * b * n * length * length * d,
                 tensors * b * length * n * d * itemsize + fp32_rows * b * length * n * 4)


def sdpa(q, k, v):
    """PyTorch's fused attention on [B, L, N, D] tensors (a yardstick; the port never calls it)."""
    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2)


def sdpa_backend(q, k, v) -> str:
    """The backend PyTorch's dispatcher picks for `sdpa` on these inputs."""
    from torch.nn.attention import SDPBackend

    t = (x.transpose(1, 2) for x in (q, k, v))
    return SDPBackend(torch._fused_sdp_choice(*t)).name


def time_ms(fn, reps: int = 10) -> float:
    """Median device time of one call, from CUDA events around each call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(max |got - want|, that divided by max |want|), in fp32."""
    err = (got.float() - want).abs().max().item()
    return err, err / want.abs().max().item()


def forward_times(fa, q, k, v, plain_reps: int = 10) -> dict:
    """bf16 times of the forward kernel, its plain version and the library call
    on the same inputs, with the bound; printed as one line's tail."""
    shape = tuple(q.shape)
    row = {"shape": list(shape), "ms": time_ms(lambda: fa.flash_attention(q, k, v)),
           "plain_ms": time_ms(lambda: fa.flash_attention_reference(q, k, v), reps=plain_reps),
           "library_ms": time_ms(lambda: sdpa(q, k, v)), "library": sdpa_backend(q, k, v),
           **attention_bound(shape, q.dtype, matmuls=2, tensors=4)}
    row["text"] = (f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f}, library ({row['library']}) "
                   f"{row['library_ms']:.4f}, bound {row['bound_ms']:.4f}; kernel/library "
                   f"{row['ms'] / row['library_ms']:.2f}, bound/kernel {row['bound_ms'] / row['ms']:.3f}")
    return row


def phase_kernels(fa) -> dict:
    """The forward kernel against its plain version at the SD2 shapes and
    ragged ones, fp32 and bf16; bf16 times beside the plain version's and the
    library's. Returns the row of the JSON line (at the level-0 shape) with
    the VAE mid block's numbers under `shapes`."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst, rows = 0.0, {}
    for dtype, bound in ((torch.float32, FP32_BOUND), (torch.bfloat16, BF16_BOUND)):
        for shape in ATTN_CASES:
            q, k, v = (torch.randn(shape, device="cuda", generator=gen).to(dtype) for _ in range(3))
            out = fa.flash_attention(q, k, v)
            torch.cuda.synchronize()
            ref = fa.flash_attention_reference(q.float(), k.float(), v.float())
            err, rel = rel_err(out, ref)
            check(bool(torch.isfinite(out).all()), f"kernel output not finite at {shape} {dtype}")
            check(rel <= bound, f"kernel vs plain max|d|/max|plain| {rel} > {bound} at {shape} {dtype}")
            line = f"[kernel] {str(dtype):15s} B,L,N,D={shape}: max|d|={err:.3e}, /max|plain| {rel:.3e} (bound {bound})"
            if dtype == torch.bfloat16:
                rows[shape] = forward_times(fa, q, k, v)
                line += "; " + rows[shape].pop("text")
            else:
                line += f"; kernel {time_ms(lambda: fa.flash_attention(q, k, v)):.4f} ms, " \
                        f"plain {time_ms(lambda: fa.flash_attention_reference(q, k, v)):.4f}"
            print(line, flush=True)
            worst = max(worst, err)
            del q, k, v, out, ref
    row = rows[ATTN_CASES[0]]
    return {"max_abs_err": worst, **{key: row[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
            "shapes": [rows[(1, 9216, 1, 512)]]}


def phase_forward_layouts(fa) -> float:
    """The forward kernel on strided projections (q, k, v as views of one
    [B, L, 3 N D] tensor) and on Lq != Lk, fp32 and bf16, against the plain
    version on the same values. Returns the largest max|d|."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    worst = 0.0
    for dtype, bound in ((torch.float32, FP32_BOUND), (torch.bfloat16, BF16_BOUND)):
        for b, lq, lk, n, d in LAYOUT_CASES:
            if lq == lk:  # one projection, row stride 3 N D
                qkv = torch.randn((b, lq, 3 * n * d), device="cuda", generator=gen).to(dtype)
                q, k, v = qkv.view(b, lq, 3, n, d).unbind(2)
                check(q.stride(1) == 3 * n * d and not q.is_contiguous(), f"q strides {q.stride()}")
            else:
                q = torch.randn((b, lq, n, d), device="cuda", generator=gen).to(dtype)
                k, v = (torch.randn((b, lk, n, d), device="cuda", generator=gen).to(dtype) for _ in range(2))
            out = fa.flash_attention(q, k, v)
            torch.cuda.synchronize()
            ref = fa.flash_attention_reference(q.float(), k.float(), v.float())
            err, rel = rel_err(out, ref)
            check(out.shape == (b, lq, n, d) and bool(torch.isfinite(out).all()), f"{tuple(out.shape)} not finite")
            check(rel <= bound, f"kernel vs plain max|d|/max|plain| {rel} > {bound} at {(b, lq, lk, n, d)} {dtype}")
            print(f"[layout] {str(dtype):15s} B,Lq,Lk,N,D={(b, lq, lk, n, d)}, q strides {q.stride()}: "
                  f"max|d|={err:.3e}, /max|plain| {rel:.3e} (bound {bound})", flush=True)
            worst = max(worst, err)
    return worst


def plain_grads(fa, q, k, v, do) -> list:
    """(out, lse, dq, dk, dv) of plain fp32 autograd on `flash_attention_reference`,
    one head at a time (a [2, 9600, 8, 40] call at once would hold ~6 GB per logit tensor)."""
    heads = []
    for h in range(q.shape[2]):
        leaves = [t[:, :, h:h + 1].float().requires_grad_() for t in (q, k, v)]
        out = fa.flash_attention_reference(*leaves)
        lse = fa.flash_attention_fwd_lse_reference(*(x.detach() for x in leaves))[1]
        heads.append((out.detach(), lse, *torch.autograd.grad(out, leaves, do[:, :, h:h + 1].float())))
    return [torch.cat(parts, dim=2) for parts in zip(*heads)]


def backward_times(fa, q, k, v, do, out, lse) -> dict:
    """bf16 times of forward+LSE, dq and dk/dv, each beside its plain version
    (plain autograd restricted to the same outputs) and the library (SDPA's
    forward with inputs requiring grad; its backward computes dq, dk and dv
    in one call), with each kernel's bound."""
    shape, dtype = tuple(q.shape), q.dtype
    delta = (do.float() * out.float()).sum(-1)
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    plain_out = fa.flash_attention_reference(*plain)
    lib = [t.clone().requires_grad_() for t in (q, k, v)]
    lib_out = sdpa(*lib)
    lib_bwd = time_ms(lambda: torch.autograd.grad(lib_out, lib, do, retain_graph=True))
    rows = {
        "flash_attention_fwd_lse": (time_ms(lambda: fa.flash_attention_fwd_lse(q, k, v)),
                                    time_ms(lambda: fa.flash_attention_fwd_lse_reference(q, k, v), reps=5),
                                    time_ms(lambda: sdpa(*lib)), attention_bound(shape, dtype, 2, 4, fp32_rows=1)),
        "flash_attention_bwd_dq": (
            time_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta)),
            time_ms(lambda: torch.autograd.grad(plain_out, plain[0], do, retain_graph=True), reps=5),
            lib_bwd, attention_bound(shape, dtype, 3, 5, fp32_rows=2)),
        "flash_attention_bwd_dkv": (
            time_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)),
            time_ms(lambda: torch.autograd.grad(plain_out, plain[1:], do, retain_graph=True), reps=5),
            lib_bwd, attention_bound(shape, dtype, 4, 6, fp32_rows=2)),
    }
    print(f"[bwd-time] bf16 B,L,N,D={shape}, library scaled_dot_product_attention ({sdpa_backend(q, k, v)}): "
          + "; ".join(f"{n.replace('flash_attention_', '')} kernel {a:.4f} ms, plain {p:.4f}, library {lb:.4f}, "
                      f"bound {bd['bound_ms']:.4f} ({bd['bound_by']}), kernel/library {a / lb:.2f}"
                      for n, (a, p, lb, bd) in rows.items()), flush=True)
    return {n: {"shape": list(shape), "ms": a, "plain_ms": p, "library_ms": lb, **bd}
            for n, (a, p, lb, bd) in rows.items()}


def phase_backward(fa) -> dict:
    """forward+LSE, dq and dk/dv kernels (through the autograd Function) against
    plain fp32 autograd on `flash_attention_reference`, fp32 and bf16 at every
    case, and their bf16 times at every training shape. Returns each kernel's
    row of the JSON line at the first training shape, the others under `shapes`."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    names = ("flash_attention_fwd_lse", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
    worst = dict.fromkeys(names, 0.0)
    timed: dict = {}
    for dtype, bound in ((torch.float32, FP32_BOUND), (torch.bfloat16, BF16_BOUND)):
        for shape in BWD_CASES:
            q, k, v, do = (torch.randn(shape, device="cuda", generator=gen).to(dtype) for _ in range(4))
            ref = plain_grads(fa, q, k, v, do)
            out, lse = fa.flash_attention_fwd_lse(q, k, v)
            inputs = [t.clone().requires_grad_() for t in (q, k, v)]
            grads = torch.autograd.grad(fa.flash_attention_autograd(*inputs), inputs, do)
            torch.cuda.synchronize()
            errs = {}
            for label, got, want in zip(("out", "lse", "dq", "dk", "dv"), (out, lse, *grads), ref):
                check(bool(torch.isfinite(got).all()), f"{label} not finite at {shape} {dtype}")
                check(got.dtype == (torch.float32 if label == "lse" else dtype), f"{label} dtype {got.dtype}")
                errs[label] = rel_err(got, want)
                check(errs[label][1] <= bound,
                      f"{label} kernel vs plain max|d|/max|plain| {errs[label][1]} > {bound} at {shape} {dtype}")
            for name, labels in zip(names, (("out", "lse"), ("dq",), ("dk", "dv"))):
                worst[name] = max(worst[name], *(errs[x][0] for x in labels))
            print(f"[bwd] {str(dtype):15s} B,L,N,D={shape}: max|d|/max|plain| "
                  + ", ".join(f"{x} {e[1]:.2e}" for x, e in errs.items()) + f" (bound {bound})", flush=True)
            del ref, inputs, grads
            if dtype == torch.bfloat16 and shape in BWD_TRAIN_CASES:
                timed[shape] = backward_times(fa, q, k, v, do, out, lse)
            del q, k, v, do, out, lse
            torch.cuda.empty_cache()
    first, rest = timed[BWD_TRAIN_CASES[0]], [timed[s] for s in BWD_TRAIN_CASES[1:]]
    return {name: {"max_abs_err": worst[name], **{key: first[name][key] for key in
                                                  ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
                   "shapes": [row[name] for row in rest]} for name in names}


def phase_grad_route(fa) -> None:
    """`kernels.joint_attention` under grad on the card, bf16, at GeoWizard's
    joint training shape: one forward+LSE, one dq and one dk/dv launch, and
    the output and gradients within the bound of plain fp32 autograd over the
    same task pairing."""
    from diffusion_e2e_ft_tpu_torch import kernels

    gen = torch.Generator(device="cuda").manual_seed(9)
    two_b, length, n, d = GRAD_ROUTE_SHAPE
    q, k, v, do = (torch.randn(GRAD_ROUTE_SHAPE, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(4))
    inputs = [t.clone().requires_grad_() for t in (q, k, v)]
    reset_launches()
    out = kernels.joint_attention(*inputs)
    grads = torch.autograd.grad(out, inputs, do)
    torch.cuda.synchronize()
    launches = read_launches()
    want = {**dict.fromkeys(launches, 0), "flash_attention_fwd_lse": 1, "flash_attention_bwd_dq": 1,
            "flash_attention_bwd_dkv": 1}
    check(launches == want, f"joint attention under grad launched {launches}")

    def pair(t):  # [2B, L, N, D] -> [B, 2L, N, D], as `joint_attention`
        return t.reshape(2, two_b // 2, length, n, d).transpose(0, 1).reshape(two_b // 2, 2 * length, n, d)

    def unpair(t):
        return t.reshape(two_b // 2, 2, length, n, d).transpose(0, 1).reshape(two_b, length, n, d)

    ref = plain_grads(fa, *(pair(t) for t in (q, k, v, do)))
    errs = {label: rel_err(got, unpair(want))[1]
            for label, got, want in zip(("out", "dq", "dk", "dv"), (out, *grads), (ref[0], *ref[2:]))}
    print(f"[grad-route] bf16 joint_attention under grad at {GRAD_ROUTE_SHAPE}: launches {launches}; "
          "max|d|/max|plain| " + ", ".join(f"{x} {e:.2e}" for x, e in errs.items()) + f" (bound {BF16_BOUND})",
          flush=True)
    for label, e in errs.items():
        check(e <= BF16_BOUND, f"joint attention under grad: {label} max|d|/max|plain| {e} > {BF16_BOUND}")


def gn_conv_only(gc, gn, x, gw, gb, groups, eps, weight, bias, silu):
    """The v1 conv kernel alone (statistics, weight layout and output made
    beforehand), as the wrapper launches it; counted in a dict of its own."""
    from diffusion_e2e_ft_tpu_torch.kernels import _build

    b, c, h, w = x.shape
    cout = weight.shape[0]
    stats = gn.channel_stats(x)
    wk = weight.permute(0, 2, 3, 1).contiguous()
    out = torch.empty((b, cout, h, w), dtype=x.dtype, device=x.device)
    counts = {"gn_silu_conv3x3": 0}
    args = (x.data_ptr(), stats.data_ptr(), gw.data_ptr(), gb.data_ptr(), wk.data_ptr(), bias.data_ptr(),
            out.data_ptr(), _build.DTYPE_CODES[x.dtype], int(silu), b, c, cout, h, w, groups, float(eps))
    return lambda: _build.launch(counts, "gn_silu_conv3x3", x, *args)


def gn_conv_v2_only(gc, x, gw, gb, groups, eps, weight, bias, silu):
    """The v2 kernel alone (weight layout, output and the statistics scratch
    made beforehand), as the wrapper launches it; counted in a dict of its own."""
    from diffusion_e2e_ft_tpu_torch.kernels import _build

    b, c, h, w = x.shape
    cout = weight.shape[0]
    parts = gc.v2_plan(b, c, h, w, cout, torch.cuda.get_device_properties(x.device).multi_processor_count,
                       x.dtype).parts
    stats = torch.empty((b, 2, c, parts), dtype=torch.float32, device=x.device)
    wk = weight.permute(0, 2, 3, 1).contiguous()
    out = torch.empty((b, cout, h, w), dtype=x.dtype, device=x.device)
    counts = {"gn_silu_conv3x3_v2": 0}
    args = (x.data_ptr(), gw.data_ptr(), gb.data_ptr(), wk.data_ptr(), bias.data_ptr(), out.data_ptr(),
            stats.data_ptr(), parts, _build.DTYPE_CODES[x.dtype], int(silu), b, c, cout, h, w, groups, float(eps))
    return lambda: _build.launch(counts, "gn_silu_conv3x3_v2", x, *args)


def batch_ms(fn, reps: int = 20) -> float:
    """Device time of one call: CUDA events around `reps` calls launched back
    to back, over `reps` (the host runs ahead of the card when a call's
    kernels take longer than its launch, so no host gap is counted)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_kernels(fn, reps: int = 1) -> list:
    """The CUDA kernels of `reps` calls of `fn` (torch.profiler), after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def phase_gn_kernels() -> dict:
    """The GroupNorm statistics kernel and the fused GN(+SiLU) -> conv3x3
    kernels (v1: statistics, then the conv with the fold in its prologue; v2:
    one cooperative launch) against their plain versions in fp32 on the same
    values, the statistics twice for identical bits; then, in bf16 at every
    train-step shape, each kernel's time beside its bound, the plain version's
    and the library's (`torch.var_mean`; GroupNorm -> SiLU -> cuDNN conv, three
    calls), and the sums weighted by the launches of one train step."""
    from diffusion_e2e_ft_tpu_torch.kernels import gn_conv as gc
    from diffusion_e2e_ft_tpu_torch.kernels import groupnorm as gn

    gen = torch.Generator(device="cuda").manual_seed(4)

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, device="cuda", generator=gen) * scale + shift

    names = ("gn_channel_stats", "gn_silu_conv3x3", "gn_silu_conv3x3_v2")
    worst = dict.fromkeys(names, 0.0)
    rows: dict = {}
    parts_seen: set = set()
    for dtype in (torch.float32, torch.bfloat16):
        bound = GN_BOUND[dtype]
        for case in GN_CASES:
            b, c, h, w, co = case
            silu = (h, w) != (37, 53)  # one case without the SiLU
            x = randn(b, c, h, w, shift=0.5).to(dtype)
            gw, gb = randn(c, scale=0.2, shift=1.0), randn(c, scale=0.5)  # a non-zero GroupNorm bias
            weight = randn(co, c, 3, 3, scale=(9 * c) ** -0.5).to(dtype)  # the compute dtype's values
            bias = randn(co, scale=0.1)
            gn_args = (gw, gb, 32, 1e-6, weight, bias, silu)
            stats, again = gn.channel_stats(x), gn.channel_stats(x)
            want_stats = gn.channel_stats_reference(x)
            outs = {}
            for form in ("v1", "v2"):
                os.environ["E2EFT_GNCONV_IMPL"] = form
                outs[form] = gc.gn_conv_kernel(x, *gn_args)
            v2_again = gc.gn_conv_kernel(x, *gn_args)
            os.environ.pop("E2EFT_GNCONV_IMPL")
            torch.cuda.synchronize()
            check(torch.equal(stats, again), f"gn_channel_stats: two calls differ at {case} {dtype}")
            check(torch.equal(outs["v2"], v2_again), f"gn_silu_conv3x3_v2: two calls differ at {case} {dtype}")
            plan = gc.v2_plan(b, c, h, w, co, torch.cuda.get_device_properties(0).multi_processor_count, dtype)
            parts_seen.add(plan.parts)
            want = gc.gn_conv_reference(x.float(), gw, gb, 32, 1e-6, weight.float(), bias, silu)
            errs = {"gn_channel_stats": rel_err(stats, want_stats), "gn_silu_conv3x3": rel_err(outs["v1"], want),
                    "gn_silu_conv3x3_v2": rel_err(outs["v2"], want)}
            for name, got in (("gn_silu_conv3x3", outs["v1"]), ("gn_silu_conv3x3_v2", outs["v2"])):
                check(got.dtype == dtype and got.shape == (b, co, h, w), f"{name} {got.dtype} {tuple(got.shape)}")
                check(bool(torch.isfinite(got).all()), f"{name} not finite at {case} {dtype}")
            for name, (err, rel) in errs.items():
                check(rel <= bound, f"{name} kernel vs plain max|d|/max|plain| {rel} > {bound} at {case} {dtype}")
                worst[name] = max(worst[name], err)
            line = (f"[gn] {str(dtype):15s} B,C,H,W={case[:4]} -> {co}{'' if silu else ' (no SiLU)'}: "
                    "max|d|/max|plain| " + ", ".join(f"{n.replace('gn_', '')} {e[1]:.2e}" for n, e in errs.items())
                    + f" (bound {bound}), v2 vs v1 {rel_err(outs['v2'], outs['v1'].float())[1]:.2e}; "
                    f"statistics and v2 ({plan.blocks} blocks, {plan.parts} parts a row, {plan.items} tiles) "
                    "bit-identical over two calls")
            del stats, again, want_stats, outs, want, v2_again
            if dtype == torch.bfloat16 and case in GN_TRAIN_SHAPES:
                rows[case] = gn_times(gc, gn, x, gw, gb, weight, bias, silu)
                line += "; " + rows[case].pop("text")
            print(line, flush=True)
            del x
            torch.cuda.empty_cache()

    def step_sum(name, key, step=GN_TRAIN_LAUNCHES):
        return sum(k * rows[s][name][key] for s, k in step.items())

    for label, step in (("SD2 train step", GN_TRAIN_LAUNCHES), ("GeoWizard joint E2E step", GN_JOINT_LAUNCHES),
                        ("GeoWizard diffusion-loss step", GN_JOINT_DIFFUSION_LAUNCHES),
                        ("SD2 VKITTI2 step (352x1216)", GN_VKITTI_LAUNCHES)):
        print(f"[gn] per {label} ({sum(step.values())} launches each, bf16), events: "
              + ", ".join(f"{n.replace('gn_', '')} {step_sum(n, 'ms', step):.3f} ms (bound "
                          f"{step_sum(n, 'bound_ms', step):.3f})" for n in names)
              + f"; group_norm -> silu -> conv2d {step_sum('gn_silu_conv3x3', 'library_ms', step):.3f} ms; alone: "
              f"stats {step_sum('gn_channel_stats', 'alone_ms', step):.3f}, conv "
              f"{step_sum('gn_silu_conv3x3', 'conv_alone_ms', step):.3f}, v1 pair "
              f"{step_sum('gn_silu_conv3x3', 'alone_ms', step):.3f}, v2 "
              f"{step_sum('gn_silu_conv3x3_v2', 'alone_ms', step):.3f}, library "
              f"{step_sum('gn_silu_conv3x3', 'library_alone_ms', step):.3f} ms", flush=True)
    print(f"[gn] eager launches per v1 pair {rows[GN_CASES[0]]['eager_launches']}, per v2 call "
          f"{rows[GN_CASES[0]]['v2_launches']}", flush=True)
    check(max(parts_seen) > 1, f"no case split v2's statistics rows: parts {parts_seen}")
    first = rows[GN_CASES[0]]
    return {n: {"max_abs_err": worst[n], **{k: first[n][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                                         "bound_by")},
                "per_step_ms": step_sum(n, "ms"), "per_step_bound_ms": step_sum(n, "bound_ms"),
                "per_joint_step_ms": step_sum(n, "ms", GN_JOINT_LAUNCHES),
                "per_joint_step_bound_ms": step_sum(n, "bound_ms", GN_JOINT_LAUNCHES),
                "per_vkitti_step_ms": step_sum(n, "ms", GN_VKITTI_LAUNCHES),
                "per_vkitti_step_bound_ms": step_sum(n, "bound_ms", GN_VKITTI_LAUNCHES),
                "shapes": [rows[s][n] for s in GN_TRAIN_SHAPES if s != GN_CASES[0]]} for n in names}


def gn_times(gc, gn, x, gw, gb, weight, bias, silu) -> dict:
    """bf16 times at one shape: the statistics kernel, the v1 pair (statistics
    + conv, as the wrapper runs them) and its conv kernel alone, v2 (the
    wrapper's call, and the kernel alone), the plain versions and the library
    calls, with each kernel's bound. Each as CUDA events around one call and,
    for the card's time without host gaps, around calls launched back to
    back ("alone", `batch_ms`); torch.profiler only counts the CUDA kernels
    of a call, at the first shape (its per-call sums drop to zero after many
    profiles in one process)."""
    b, c, h, w = x.shape
    co = weight.shape[0]
    gn_args = (gw, gb, 32, 1e-6, weight, bias, silu)
    itemsize = x.element_size()
    flops = 2.0 * b * h * w * co * c * 9
    conv_bound = roofline(flops, (x.numel() + weight.numel() + b * co * h * w) * itemsize)
    stats_bound = roofline(3.0 * x.numel(), x.numel() * itemsize + b * 2 * c * 4)
    fns = {"stats": lambda: gn.channel_stats(x), "v1": lambda: gc.gn_conv_kernel(x, *gn_args),
           "conv": gn_conv_only(gc, gn, x, gw, gb, 32, 1e-6, weight, bias, silu),
           "library": lambda: F.conv2d(F.silu(F.group_norm(x, 32, gw.to(x.dtype), gb.to(x.dtype), 1e-6)),
                                       weight, bias.to(x.dtype), padding=1)}
    ev = {k: time_ms(f) for k, f in fns.items()}
    alone = {k: batch_ms(f) for k, f in fns.items()}
    first = (b, c, h, w, co) == GN_CASES[0]
    plain = time_ms(lambda: gc.gn_conv_reference(x, *gn_args))
    os.environ["E2EFT_GNCONV_IMPL"] = "v2"
    ev["v2"] = time_ms(fns["v1"])
    v2_launches = len(device_kernels(fns["v1"])) if first else None
    os.environ.pop("E2EFT_GNCONV_IMPL")
    alone["v2"] = batch_ms(gn_conv_v2_only(gc, x, *gn_args))
    row = {
        "gn_channel_stats": {"shape": list(x.shape), "ms": ev["stats"], "alone_ms": alone["stats"],
                             "plain_ms": time_ms(lambda: gn.channel_stats_reference(x)),
                             "library_ms": time_ms(lambda: torch.var_mean(x, dim=(2, 3))), **stats_bound},
        "gn_silu_conv3x3": {"shape": list(x.shape) + [co], "ms": ev["v1"], "alone_ms": alone["v1"],
                            "conv_ms": ev["conv"], "conv_alone_ms": alone["conv"], "plain_ms": plain,
                            "library_ms": ev["library"], "library_alone_ms": alone["library"], **conv_bound},
        "gn_silu_conv3x3_v2": {"shape": list(x.shape) + [co], "ms": ev["v2"], "alone_ms": alone["v2"],
                               "plain_ms": plain, "library_ms": ev["library"], "library_alone_ms": alone["library"],
                               **conv_bound},
    }
    if first:
        row["eager_launches"] = len(device_kernels(fns["v1"]))
        row["v2_launches"] = v2_launches
    row["text"] = (f"ms (events / alone): stats {ev['stats']:.4f} / {alone['stats']:.4f} (bound "
                   f"{stats_bound['bound_ms']:.4f}, {stats_bound['bound_ms'] / alone['stats']:.2f} of it; var_mean "
                   f"{row['gn_channel_stats']['library_ms']:.4f}), v1 pair {ev['v1']:.4f} / {alone['v1']:.4f} = conv "
                   f"{ev['conv']:.4f} / {alone['conv']:.4f} ({flops / alone['conv'] / 1e9:.0f} TFLOP/s, "
                   f"{conv_bound['bound_ms'] / alone['conv']:.3f} of the bound {conv_bound['bound_ms']:.4f}) + stats, "
                   f"v2 {ev['v2']:.4f} / {alone['v2']:.4f} ({flops / alone['v2'] / 1e9:.0f} TFLOP/s, "
                   f"{conv_bound['bound_ms'] / alone['v2']:.3f} of the bound), library (3 calls) {ev['library']:.4f} / "
                   f"{alone['library']:.4f}, plain {plain:.4f}")
    return row


# Phase 4c: the standalone GroupNorms' kernels (one launch, or statistics + apply) at every shape that the
# paths driven below send them, at the published widths: serving, the ensembles and the eval frames with the
# unfused VAE, and the train steps with the fused VAE (whose GN -> conv pairs take kernels 7-8; the fused visits
# are a subset of the unfused ones at the same batch). (label, UNet config or None for SD2's, image hw, UNet
# batches, encoder batches, decoder batches, fused); an ensemble's batch is `find_batch_size`'s, as its request
# takes it.
def route_paths() -> list:
    from diffusion_e2e_ft_tpu_torch.pipelines import MarigoldPipeline

    base = MarigoldPipeline.find_batch_size(BASELINE["ensemble_size"], max(BASELINE_HW))
    lcm = MarigoldPipeline.find_batch_size(LCM_REQUEST["ensemble_size"], max(LCM_HW))
    geo = 2 * GEO_ENSEMBLE["batch_size"]  # the joint UNet and the decode take both halves of 5 members
    return [
        ("Marigold 768x768", None, (768, 768), (1,), (1,), (1,), False),
        ("Marigold 576x768", None, (576, 768), (1,), (1,), (1,), False),
        # and the mesh's ensembles (phase 18b), the export round trip and one row a rank of phase 18a's steps
        ("NYU 480x640", None, NYU_HW, (1,), (1,), (1,), False),
        ("KITTI 352x1216", None, KITTI_HW, (1,), (1,), (1,), False),
        ("baseline 480x640", None, BASELINE_HW, (base,), (1,), (base,), False),
        ("LCM 768x768", None, LCM_HW, (lcm,), (1,), (lcm,), False),
        ("GeoWizard 768x768", "geowizard", (768, 768), (2,), (1,), (2,), False),
        ("GeoWizard 576x768", "geowizard", (576, 768), (2,), (1,), (2,), False),
        ("GeoWizard ensemble 576x768", "geowizard", GEO_ENSEMBLE_HW, (geo,), (1,), (geo,), False),
        ("GeoWizard NYU 480x640", "geowizard", NYU_HW, (2,), (1,), (2,), False),
        # the parity and golden runs: Marigold at batch 1 and phase 14's 3-member batch, GeoWizard's pair
        ("Marigold 256x256", None, (256, 256), (1, 3), (1,), (1, 3), False),
        ("GeoWizard 256x256", "geowizard", (256, 256), (2,), (1,), (2,), False),
        ("GeoWizard 512x512", "geowizard", (512, 512), (2,), (1,), (2,), False),
        ("SD2 train 480x640 bs 2", None, (480, 640), (2,), (2,), (2,), True),
        ("SD2 train 480x640 bs 2, unfused VAE", None, (480, 640), (2,), (2,), (2,), False),  # the A/B's other arm
        ("SD2 VKITTI2 train 352x1216 bs 2", None, VKITTI_HW, (2,), (2,), (2,), True),
        # the joint step's UNet and decode at 2B; the diffusion-loss step encodes the GT geometry at 2B too
        ("GeoWizard joint train 480x640 bs 2", "geowizard", (480, 640), (4,), (2, 4), (4,), True),
    ]


ROUTE_TIMED = "Marigold 768x768"  # the slice's main path: its shapes are timed


def route_visits(path) -> dict:
    """{(B, C, H, W): standalone GroupNorms a forward of the path visits there}: UNet, encoder, decoder, at
    each of their batches."""
    from diffusion_e2e_ft_tpu_torch.models import UNetConfig

    _, unet, hw, bu, be, bd, fused = path
    config = UNetConfig.geowizard() if unet == "geowizard" else None
    visits = [norm_visits("unet", b, hw, config=config) for b in bu]
    visits += [norm_visits("encoder", b, hw, fused) for b in be] + [norm_visits("decoder", b, hw, fused) for b in bd]
    out: dict = {}
    for shape in (s for part in visits for s in part):
        out[shape] = out.get(shape, 0) + 1
    return out


@functools.cache
def route_shapes() -> frozenset:
    return frozenset(shape for path in route_paths() for shape in route_visits(path))


# ... and shapes no path sends, for the one-launch kernel's edges: ragged n (1961 values a channel), channels of
# 63 values (vectors cross channels), n = 1 (80 channels a group, a vector spans several), a slab that takes 8
# blocks in bf16 (1.18 MB) and the route in fp32
GROUP_CASES = [(1, 320, 37, 53), (3, 96, 7, 9), (2, 2560, 1, 1), (1, 128, 383, 385)]


def phase_gn_route() -> dict:
    """Phase 4c: `group_norm_kernel` (one C call: one launch of the
    one-launch kernel where `groupnorm.group_fits` takes the shape, else the
    statistics kernel then the apply kernel; the kernels launched are checked
    against that rule) against `group_norm_reference` in fp32 on the same
    values, and the apply kernel alone against `group_norm_apply_reference`
    on the statistics kernel's sums, at every shape of `route_shapes()` and
    `GROUP_CASES`, fp32 and bf16 x (the affine fp32, or bf16 as a bf16 module
    holds it, in turns), with and without the SiLU in turns, a non-zero bias,
    a mean of 3 at every other shape (0.5 otherwise), and at every fourth
    shape off the timed request an x one value past an aligned base (its
    output's base aligned otherwise, its slabs' heads ragged); two calls for
    identical bits. Then, at the Marigold 768x768 request's shapes in bf16
    (bf16 affine, as serving holds it): `route_times`, and their sums over
    one request's visits."""
    from diffusion_e2e_ft_tpu_torch.kernels import groupnorm as gn

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(41)

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, device="cuda", generator=gen) * scale + shift

    eps = 1e-6
    worst = {"gn_group": 0.0, "gn_channel_stats": 0.0, "gn_apply": 0.0}
    shapes = sorted(route_shapes()) + GROUP_CASES
    paths = route_paths()
    timed_path = next(p for p in paths if p[0] == ROUTE_TIMED)
    timed = route_visits(timed_path)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        bound = GN_BOUND[dtype]
        top = {"gn_group": 0.0, "route": 0.0, "apply": 0.0}
        ones = 0
        for i, shape in enumerate(shapes):
            c = shape[1]
            silu = i % 3 != 2
            affine = torch.bfloat16 if dtype == torch.bfloat16 and (i % 2 == 0 or shape in timed) else torch.float32
            x = randn(math.prod(shape) + 1, shift=3.0 if i % 2 else 0.5).to(dtype)
            x = (x[1:] if i % 4 == 3 and shape not in timed else x[:-1]).view(shape)
            w, b = randn(c, scale=0.2, shift=1.0).to(affine), randn(c, scale=0.5).to(affine)
            one = gn.group_fits(shape, dtype, 32)
            ones += one
            gn.reset_launches()
            out, again = gn.group_norm_kernel(x, w, b, 32, eps, silu), gn.group_norm_kernel(x, w, b, 32, eps, silu)
            launched = dict(gn.launches)
            stats = gn.channel_stats(x)
            applied = gn.group_norm_apply(x, stats, w, b, 32, eps, silu)
            torch.cuda.synchronize()
            want = dict.fromkeys(launched, 0) | ({"gn_group": 2} if one else {"gn_channel_stats": 2, "gn_apply": 2})
            check(launched == want, f"group_norm_kernel at {shape} {dtype} launched {launched}, the rule {want}")
            check(out.dtype == dtype and out.shape == x.shape and bool(torch.isfinite(out).all()),
                  f"group_norm_kernel {out.dtype} {tuple(out.shape)} at {shape} {dtype}")
            check(torch.equal(out, again), f"group_norm_kernel: two calls differ at {shape} {dtype}")
            check(one or torch.equal(out, applied), f"the route differs from statistics + apply at {shape} {dtype}")
            # one fp32 reference at a time: the largest shape, [10, 256, 576, 768], holds 4.5 GB in fp32
            err, rel = rel_err(out, gn.group_norm_reference(x.float(), w.float(), b.float(), 32, eps, silu))
            aerr, arel = rel_err(applied, gn.group_norm_apply_reference(x.float(), stats, w.float(), b.float(), 32,
                                                                         eps, silu))
            serr = rel_err(stats, gn.channel_stats_reference(x))
            check(rel <= bound and arel <= bound and serr[1] <= bound,
                  f"group norm at {shape} {dtype} (affine {affine}, silu {silu}, {'one launch' if one else 'route'}): "
                  f"max|d|/max|plain| {rel}, apply alone {arel}, statistics {serr[1]} > {bound}")
            worst["gn_apply"] = max(worst["gn_apply"], aerr)
            worst["gn_channel_stats"] = max(worst["gn_channel_stats"], serr[0])
            if one:
                worst["gn_group"] = max(worst["gn_group"], err)
            top["gn_group" if one else "route"] = max(top["gn_group" if one else "route"], rel)
            top["apply"] = max(top["apply"], arel)
            if dtype == torch.bfloat16 and shape in timed:
                rows[shape] = route_times(gn, x, stats, w, b, eps, silu=True, count=shape == max(timed, key=math.prod))
            del x, stats, out, again, applied
        # the dispatcher on a channels_last x (the VAE encoder's layout when its input is a permuted NHWC image)
        x = randn(1, 128, 96, 128, shift=0.5).to(dtype).to(memory_format=torch.channels_last)
        w, b = randn(128, scale=0.2, shift=1.0), randn(128, scale=0.5)
        err = rel_err(gn.group_norm_silu(x, w, b, 32, eps), gn.group_norm_reference(x.float(), w, b, 32, eps))[1]
        check(err <= bound, f"group_norm_silu on a channels_last x: max|d|/max|plain| {err} > {bound}")
        print(f"[gn-route] {str(dtype):14s} at {len(shapes)} shapes ({len(route_shapes())} of {len(paths)} paths): "
              f"one launch at {ones}, the route at {len(shapes) - ones}; max|d|/max|plain| one launch "
              f"{top['gn_group']:.2e}, route {top['route']:.2e}, apply alone {top['apply']:.2e}, the dispatcher on a "
              f"channels_last x {err:.2e} (bound {bound}); two calls bit-identical", flush=True)
    torch.cuda.empty_cache()
    names = ("kernel", "route", "stats", "apply", "plain", "library", "library_apply", "host_us", "route_host_us",
             "bound_ms", "route_bound_ms", "apply_bound_ms")
    per_request = {k: sum(n * rows[s][k] for s, n in timed.items()) for k in names}
    launches = request_gn(timed_path[2], torch.bfloat16)
    for shape in sorted(rows, key=lambda s: -math.prod(s)):
        r = rows[shape]
        how = "one launch" if r["one_launch"] else "the route"
        print(f"[gn-route] bf16 {list(shape)} x{timed[shape]} a request, {how}: group_norm_kernel {r['kernel']:.4f} "
              f"ms (events {r['kernel_events']:.4f}; host {r['host_us']:.1f} us a call) against its bound "
              f"{r['bound_ms']:.4f} ({r['bound_ms'] / r['kernel']:.2f} of it); the route "
              f"{r['route']:.4f} (host {r['route_host_us']:.1f} us) = stats {r['stats']:.4f} + apply {r['apply']:.4f} "
              f"(bound {r['apply_bound_ms']:.4f}, {r['apply_bound_ms'] / r['apply']:.2f} of it), route bound "
              f"{r['route_bound_ms']:.4f}; plain {r['plain']:.4f}, F.group_norm + F.silu {r['library']:.4f}; the "
              f"apply's library call, torch.addcmul on the folded a, b (no SiLU), {r['library_apply']:.4f}",
              flush=True)
    first = rows[max(rows, key=math.prod)]
    group = rows[max((s for s in rows if rows[s]["one_launch"]), key=math.prod)]
    print(f"[gn-route] per {ROUTE_TIMED} request ({sum(timed.values())} GroupNorms, bf16, back-to-back events): "
          + ", ".join(f"{k} {per_request[k]:.3f} ms" for k in names if not k.endswith("_us"))
          + f"; host {per_request['host_us'] / 1e3:.3f} ms (the route's {per_request['route_host_us'] / 1e3:.3f}); "
          f"launches a request {json.dumps(launches)} ({sum(launches.values())}); launches a call at "
          f"{first['shape']}: group_norm_kernel {first['kernel_launches']}, plain {first['plain_launches']}; "
          f"phase 4c in {time.perf_counter() - t0:.1f} s", flush=True)
    request = {f"{k}_ms" if not k.endswith(("_us", "_ms")) else k: per_request[k] for k in names}
    return {"gn_group": {"max_abs_err": worst["gn_group"], "shape": group["shape"], "ms": group["kernel"],
                         "plain_ms": group["plain"], "library_ms": group["library"],
                         "library": "F.group_norm + F.silu", "bound_ms": group["bound_ms"],
                         "bound_by": group["bound_by"], "host_us": group["host_us"],
                         "shapes": [{k: rows[s][k] for k in ("shape", "kernel", "bound_ms", "host_us", "route",
                                                             "route_host_us")}
                                    for s in sorted(rows, key=math.prod) if rows[s]["one_launch"]],
                         "per_request": request, "launches_per_request": launches},
            "gn_apply": {"max_abs_err": worst["gn_apply"], "shape": first["shape"], "ms": first["apply"],
                         "plain_ms": first["apply_plain"], "library_ms": first["library_apply"],
                         "library": "torch.addcmul(b, x, a) on the folded a, b: the affine alone, without the SiLU",
                         "bound_ms": first["apply_bound_ms"], "bound_by": first["apply_bound_by"],
                         "route_ms": first["route"], "route_plain_ms": first["plain"],
                         "route_library_ms": first["library"], "route_library": "F.group_norm + F.silu",
                         "route_bound_ms": first["route_bound_ms"]},
            "gn_channel_stats_route_err": worst["gn_channel_stats"]}


def host_us(fn, reps: int = 50) -> float:
    """Host microseconds a call: `reps` calls back to back on the host clock,
    after a warm-up call and a synchronise, before the closing synchronise
    (the card's queue takes them without holding the host)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def route_times(gn, x, stats, w, b, eps, silu: bool, count: bool) -> dict:
    """bf16 times at one GroupNorm shape (calls back to back, `batch_ms`; the
    port's GroupNorm also as events around one call): `group_norm_kernel`
    (the port's GroupNorm: one launch where the rule takes the shape, else the
    route), the two-kernel route (`group_norm_apply` on `channel_stats`,
    whatever the rule), the statistics, the apply, their plain versions,
    `F.group_norm` + `F.silu` (the GroupNorm's library call) and
    `torch.addcmul` on the folded a, b (the apply's, without the SiLU); the
    host microseconds a call of the port's GroupNorm and of the route
    (`host_us`). The bounds: the one-launch kernel reads x and writes y
    (2 |x| bytes, and the affine; 3 fp32 operations a value for the sums, 2
    for the affine, 4 more for the SiLU), the apply too (2 |x|, the affine and
    the sums; no sums' operations), the route also reads x for the statistics
    (3 |x|); `bound_ms` is the one-launch kernel's where the rule takes the
    shape, else the route's. `count`: also the kernels a call of
    `group_norm_kernel` and of the plain version launch."""
    itemsize, n = x.element_size(), x.numel()
    affine = 2 * x.shape[1] * w.element_size()
    sums = x.shape[0] * 2 * x.shape[1] * 4
    one = gn.group_fits(x.shape, x.dtype, 32)
    group_bound = roofline((5 + 4 * silu) * n, 2 * n * itemsize + affine, PEAK_FP32_FLOPS)
    apply_bound = roofline((2 + 4 * silu) * n, 2 * n * itemsize + affine + sums, PEAK_FP32_FLOPS)
    route_bound = roofline((5 + 4 * silu) * n, 3 * n * itemsize + affine + sums, PEAK_FP32_FLOPS)
    # the library's one-call apply: x * a + b with the same folded a, b (in x's dtype), without the SiLU
    fold = gn.fold_stats(stats, w, b, 32, eps, n // (x.shape[0] * x.shape[1])).to(x.dtype)
    a_lib, b_lib = (fold[:, k].reshape(*x.shape[:2], *[1] * (x.ndim - 2)) for k in (0, 1))
    fns = {"kernel": lambda: gn.group_norm_kernel(x, w, b, 32, eps, silu),
           "route": lambda: gn.group_norm_apply(x, gn.channel_stats(x), w, b, 32, eps, silu),
           "stats": lambda: gn.channel_stats(x), "apply": lambda: gn.group_norm_apply(x, stats, w, b, 32, eps, silu),
           "plain": lambda: gn.group_norm_reference(x, w, b, 32, eps, silu),
           "apply_plain": lambda: gn.group_norm_apply_reference(x, stats, w, b, 32, eps, silu),
           "library": lambda: F.silu(F.group_norm(x, 32, w, b, eps)),
           "library_apply": lambda: torch.addcmul(b_lib, x, a_lib)}
    out = {k: batch_ms(f) for k, f in fns.items()}
    out["kernel_events"] = time_ms(fns["kernel"])
    out["host_us"], out["route_host_us"] = host_us(fns["kernel"]), host_us(fns["route"])
    kernel_bound = group_bound if one else route_bound
    out.update(shape=list(x.shape), one_launch=one, bound_ms=kernel_bound["bound_ms"],
               bound_by=kernel_bound["bound_by"], route_bound_ms=route_bound["bound_ms"],
               apply_bound_ms=apply_bound["bound_ms"], apply_bound_by=apply_bound["bound_by"])
    if count:  # the port's from its own counts (exact); the plain version's CUDA kernels from torch.profiler
        gn.reset_launches()
        fns["kernel"]()
        out["kernel_launches"], out["plain_launches"] = sum(gn.launches.values()), len(device_kernels(fns["plain"]))
    return out


def phase_e2e_parity(fa):
    from diffusion_e2e_ft_tpu_torch.models import UNetConfig, VAEConfig
    from diffusion_e2e_ft_tpu_torch.pipelines import MarigoldPipeline

    t0 = time.perf_counter()
    cpu = MarigoldPipeline.from_random(UNetConfig.sd2(), VAEConfig(), seed=0, device="cpu")
    img = np.random.default_rng(0).integers(0, 256, (1, 256, 256, 3)).astype(np.float32)
    rgb = torch.from_numpy(img / 255.0 * 2.0 - 1.0)
    # depth is clipped to [-1, 1] before it maps to [0, 1]; the normals are the
    # decoded output unclipped (only normalized), so they see every pixel
    want = {task: cpu.infer(rgb, normals=task == "normals") for task in ("depth", "normals")}
    print(f"[e2e] cpu fp32 runs {time.perf_counter() - t0:.1f} s (incl. random init)", flush=True)
    gpu = MarigoldPipeline(cpu.unet, cpu.vae, cpu.scheduler_config, cpu.empty_text_embed,
                           device="cuda", dtype=torch.float32)
    for task, ref in want.items():
        reset_launches()
        got = gpu.infer(rgb.cuda(), normals=task == "normals")
        torch.cuda.synchronize()
        launches = read_launches()
        err = (got.cpu() - ref).abs().max().item()
        inside = ((ref > 0) & (ref < 1)).float().mean().item()
        bound = E2E_BOUNDS[task]
        print(f"[e2e] fp32 256x256 {task}, gpu vs cpu: max|d|={err:.3e} (bound {bound}), "
              f"kernel launches {launches}, values in (0, 1): {inside:.3f}", flush=True)
        want_launches = {**dict.fromkeys(launches, 0), "flash_attention_fwd": SITES_256,
                         **request_gn((256, 256), torch.float32)}
        check(launches == want_launches, f"256x256 launches {launches}, expected {want_launches}")
        check(bool(torch.isfinite(got).all()), f"gpu {task} not finite")
        check(err <= bound, f"fp32 pipeline {task} gpu vs cpu max|d| {err} > {bound}")
    return gpu


def write_hf_dir(path: str, parts: dict) -> None:
    """An HF pipeline directory: each part (subfolder -> (module, config,
    weights file)) in bf16 `.bin` files, and a trailing-DDIM scheduler."""
    for sub, (module, config, fname) in parts.items():
        os.makedirs(os.path.join(path, sub))
        with open(os.path.join(path, sub, "config.json"), "w") as f:
            json.dump(config, f)
        torch.save({k: t.to("cpu", torch.bfloat16) for k, t in module.state_dict().items()},
                   os.path.join(path, sub, fname))
    write_scheduler(path)


def write_scheduler(path: str) -> None:
    """The HF directory's scheduler: trailing DDIM, v-prediction, SD2's betas."""
    os.makedirs(os.path.join(path, "scheduler"), exist_ok=True)
    with open(os.path.join(path, "scheduler", "scheduler_config.json"), "w") as f:
        json.dump({"_class_name": "DDIMScheduler", "prediction_type": "v_prediction",
                   "timestep_spacing": "trailing", "beta_schedule": "scaled_linear"}, f)


def write_checkpoint(path: str, pipe, text_config) -> None:
    """HF pipeline directory of the pipeline's weights in bf16 `.bin` files,
    plus a text encoder with seeded random weights."""
    from diffusion_e2e_ft_tpu_torch.models import clip
    from diffusion_e2e_ft_tpu_torch.pipelines import loading
    from diffusion_e2e_ft_tpu_torch.pipelines.marigold import init_random_

    t = text_config
    te = clip.CLIPTextModel(t)
    init_random_(te, torch.Generator().manual_seed(1))
    text_json = {
        "vocab_size": t.vocab_size, "hidden_size": t.hidden_size, "num_hidden_layers": t.num_layers,
        "num_attention_heads": t.num_heads, "intermediate_size": t.intermediate_size,
        "max_position_embeddings": t.max_position_embeddings, "hidden_act": t.hidden_act,
    }
    write_hf_dir(path, {
        "unet": (pipe.unet, loading.unet_config_to_hf(pipe.unet.config), "diffusion_pytorch_model.bin"),
        "vae": (pipe.vae, loading.vae_config_to_hf(pipe.vae.config), "diffusion_pytorch_model.bin"),
        "text_encoder": (te, text_json, "pytorch_model.bin"),
    })


def phase_serving(fa, fp32_pipe, ckpt: str) -> dict:
    """Slice A's main path. Writes the fp32 pipeline's weights to `ckpt` (an
    HF directory that phase 15 loads again). Returns the path's launches."""
    from diffusion_e2e_ft_tpu_torch.cli.serve import PipelineService
    from diffusion_e2e_ft_tpu_torch.models.clip import CLIPTextConfig
    from diffusion_e2e_ft_tpu_torch.pipelines import MarigoldPipeline

    t0 = time.perf_counter()
    write_checkpoint(ckpt, fp32_pipe, CLIPTextConfig())  # SD2's OpenCLIP-H text tower
    del fp32_pipe
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    pipe = MarigoldPipeline.from_hf_dir(ckpt, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    print(f"[serve] wrote checkpoint {t1 - t0:.1f} s, from_hf_dir (bf16, cuda) "
          f"{time.perf_counter() - t1:.1f} s", flush=True)

    service = PipelineService(pipe, processing_res=768, denoise_steps=1)
    t0 = time.perf_counter()
    service.warmup()
    print(f"[serve] warmup {time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(0)
    requests = [("depth", (768, 768)), ("normals", (768, 768)), ("depth", (576, 768))] * 3
    images = {hw: rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for _, hw in requests}
    latencies: dict = {}

    per_request = {hw: {"flash_attention_fwd": SITES_768, **request_gn(hw, torch.bfloat16)} for _, hw in requests}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # the main path's run starts here
    for task, hw in requests:
        before = read_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred = service.predict(images[hw], normals=task == "normals")
        torch.cuda.synchronize()
        latencies.setdefault((task, hw), []).append((time.perf_counter() - t0) * 1e3)
        after = read_launches()
        done = {k: after[k] - before[k] for k in after}
        check(done == {**dict.fromkeys(done, 0), **per_request[hw]},
              f"{task} {hw}: launches {done}, expected {per_request[hw]}")
        check(pred.shape == (hw + (3,) if task == "normals" else hw), f"{task} {hw}: shape {pred.shape}")
        check(bool(np.isfinite(pred).all()), f"{task} {hw}: non-finite output")
        if task == "depth":
            check(pred.min() >= 0.0 and pred.max() <= 1.0, f"depth {hw} outside [0, 1]")
        else:
            norms = np.linalg.norm(pred, axis=-1)
            check(bool((norms <= 1.0 + 1e-3).all()), f"normals {hw}: norm above 1")
    launches = read_launches()  # ... and ends here
    peak = torch.cuda.max_memory_allocated() / 2**30
    for (task, hw), ms in latencies.items():
        print(f"[serve] bf16 {task} {hw[0]}x{hw[1]}: latency ms {[round(x, 2) for x in ms]} "
              f"(median {statistics.median(ms):.2f})", flush=True)
    print(f"[serve] peak device memory {peak:.3f} GiB; kernel launches {launches} "
          f"over {len(requests)} requests", flush=True)
    # serving needs no gradient: the plain forward kernel and the GroupNorm kernels only, and no GN -> conv kernel
    # (fused_gn_conv=False)
    check(launches == {**dict.fromkeys(launches, 0), **{k: sum(per_request[hw][k] for _, hw in requests)
                                                          for k in per_request[requests[0][1]]}},
          f"serving launched {launches}")
    return launches


def synthetic_batch(rng, b: int, h: int, w: int, modality: str, invalid: float) -> dict:
    """rgb in [-1, 1], a depth or unit-normal target, and a mask with `invalid` of the pixels off."""
    batch = {"rgb": rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32),
             "val_mask": rng.random((b, h, w)) >= invalid}
    if modality == "depth":
        batch["target"] = rng.uniform(-1, 1, (b, h, w)).astype(np.float32)
    else:
        n = rng.normal(size=(b, h, w, 3)).astype(np.float32)
        batch["target"] = n / np.linalg.norm(n, axis=-1, keepdims=True)
    return batch


def kernel_sites(unet) -> tuple:
    """Record, during the next forward passes, the UNet self-attention modules
    whose sequences (2 L tokens under joint attention) fall in the kernels'
    envelope. Returns the list it fills and the hooks' handles."""
    from diffusion_e2e_ft_tpu_torch.kernels import in_kernel_envelope

    sites, handles = [], []
    for name, module in unet.named_modules():
        if name.endswith(".attn1"):
            def hook(mod, args, name=name):
                lq = args[0].shape[1] * (2 if mod.joint else 1)
                if in_kernel_envelope(lq, lq, mod.head_dim) and name not in sites:
                    sites.append(name)
            handles.append(module.register_forward_pre_hook(hook))
    return sites, handles


def phase_train_parity(fa, cpu_unet, cpu_vae, empty):
    """One train step's loss and gradients, fp32, with the default fused VAE:
    CPU (plain) vs GPU (kernels). Returns the GPU copies of the models."""
    from diffusion_e2e_ft_tpu_torch.training import E2ETrainer, TrainConfig

    gpu_unet, gpu_vae = copy.deepcopy(cpu_unet).cuda(), copy.deepcopy(cpu_vae).cuda()
    sites, handles = kernel_sites(gpu_unet)
    rng = np.random.default_rng(2)
    for modality in ("depth", "normals"):
        config = TrainConfig(modality=modality, gradient_checkpointing=True, gradient_accumulation_steps=1)
        batch = synthetic_batch(rng, 1, 256, 256, modality, invalid=0.2)
        t0 = time.perf_counter()
        loss_c, _, grads_c = E2ETrainer(config, cpu_unet, cpu_vae, empty).value_and_grad(batch)
        t1 = time.perf_counter()
        reset_launches()
        loss_g, _, grads_g = E2ETrainer(config, gpu_unet, gpu_vae, empty).value_and_grad(batch)
        torch.cuda.synchronize()
        launches = read_launches()
        norm_c = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in grads_c.values()])))
        norm_g = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in grads_g.values()])))
        loss_rel = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
        norm_rel = abs(norm_g - norm_c) / norm_c
        leaf_rel = {n: float((grads_g[n].cpu() - grads_c[n]).abs().max() / grads_c[n].abs().max())
                    for n in PARITY_LEAVES}
        print(f"[train-parity] fp32 256x256 {modality}: loss cpu {float(loss_c):.6f} gpu {float(loss_g):.6f} "
              f"(rel {loss_rel:.2e}), grad norm cpu {norm_c:.6e} gpu {norm_g:.6e} (rel {norm_rel:.2e}), "
              f"leaf rel max|d| " + ", ".join(f"{n.replace('.weight', '').split('attn1.')[-1]} {e:.2e}"
                                              for n, e in leaf_rel.items())
              + f"; cpu step {t1 - t0:.1f} s; launches {launches}", flush=True)
        check(loss_rel <= TRAIN_PARITY_BOUNDS["loss"], f"{modality}: loss rel {loss_rel}")
        check(norm_rel <= TRAIN_PARITY_BOUNDS["grad_norm"], f"{modality}: grad norm rel {norm_rel}")
        for n, e in leaf_rel.items():
            check(e <= TRAIN_PARITY_BOUNDS["leaf"], f"{modality}: {n} rel max|d| {e}")
        check(len(sites) == UNET_SITES_256, f"UNet kernel sites at 256x256: {sites}")
        check(launches == step_launches(UNET_SITES_256, hw=(256, 256), dtype=torch.float32),
              f"{modality}: launches {launches}")
        for site in sites:  # the repair: every kernel site's projections get a gradient
            for proj in ("to_q", "to_k", "to_v"):
                g = grads_g[f"{site}.{proj}.weight"]
                check(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0, f"zero gradient at {site}.{proj}")
    print(f"[train-parity] every one of the {len(sites)} UNet kernel sites' to_q/to_k/to_v has a non-zero "
          "gradient", flush=True)
    for handle in handles:
        handle.remove()
    return gpu_unet, gpu_vae


def instrument(trainer) -> tuple:
    """Wrap `trainer.train_step` so that each step is timed on the host clock,
    synchronized on both sides, and its kernel launches counted. Returns the
    lists it fills: (ms per step, launches per step)."""
    step_ms, per_step = [], []
    train_step = trainer.train_step

    def timed_step(state, batch, generator=None):
        before = read_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_step(state, batch, generator)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        after = read_launches()
        per_step.append({k: after[k] - before[k] for k in after})
        return out

    trainer.train_step = timed_step
    return step_ms, per_step


def timed_steps(trainer, state, batches, generator=None) -> tuple:
    """One train step per batch, host clock synchronized around each: (state,
    ms per step, launches per step, losses)."""
    ms, per_step = instrument(trainer)
    losses = []
    for batch in batches:
        state, metrics = trainer.train_step(state, batch, generator)
        losses.append(float(metrics["loss"]))
    return state, ms, per_step, losses


def phase_train(unet, vae, empty) -> dict:
    """The training main path: E2ETrainer with the default TrainConfig (fused
    VAE) + run_training at 480x640 bs 2, bf16 compute, fp32 masters; then
    accumulation 2, the fused / unfused A/B and the v2 steps. Returns the
    kernel launches of the main run, and the v2 launches of the v2 steps."""
    from diffusion_e2e_ft_tpu_torch.training import E2ETrainer, TrainConfig
    from diffusion_e2e_ft_tpu_torch.training.loop import run_training

    rng = np.random.default_rng(3)
    batches = [synthetic_batch(rng, 2, 480, 640, "depth", invalid=0.0) for _ in range(TRAIN_STEPS)]
    watched = PARITY_LEAVES[:2]
    with tempfile.TemporaryDirectory() as out_dir:
        config = TrainConfig(gradient_checkpointing=True, gradient_accumulation_steps=1, lr_warmup_steps=0,
                             train_batch_size=2, max_train_steps=TRAIN_STEPS, checkpointing_steps=10 * TRAIN_STEPS,
                             output_dir=out_dir)
        check(config.fused_vae_kernels, "the default TrainConfig runs the fused VAE kernels")
        trainer = E2ETrainer(config, unet, vae, empty, compute_dtype=torch.bfloat16)
        step_ms, per_step = instrument(trainer)
        start = {n: dict(unet.named_parameters())[n].detach().clone() for n in watched}
        torch.cuda.reset_peak_memory_stats()
        reset_launches()  # the main path's run starts here
        state = run_training(trainer, trainer.init_state(), lambda epoch: batches, log_every=1)
        torch.cuda.synchronize()
        launches = read_launches()  # ... and ends here
        peak = torch.cuda.max_memory_allocated() / 2**30
        logs = [json.loads(line) for line in open(os.path.join(out_dir, "logs", "metrics.jsonl"))]
    check(state.step == TRAIN_STEPS and len(logs) == TRAIN_STEPS, f"ran {state.step} steps, {len(logs)} logged")
    for rec in logs:
        check(np.isfinite(rec["train_loss"]) and np.isfinite(rec["grad_norm"]) and rec["grad_norm"] > 0,
              f"step {rec['step']}: loss {rec['train_loss']}, grad norm {rec['grad_norm']}")
    for n in watched:
        check(not torch.equal(state.params[n], start[n]), f"{n} did not change")
    check(all(s == step_launches(UNET_SITES_480x640) for s in per_step), f"launches per step {per_step}")
    median = statistics.median(step_ms[1:])
    losses = [round(r["train_loss"], 6) for r in logs]
    norms = ", ".join(f"{r['grad_norm']:.3e}" for r in logs)
    print(f"[train] bf16 480x640 bs 2, {TRAIN_STEPS} steps: ms/step {[round(x, 1) for x in step_ms]} "
          f"(median after the first {median:.1f}, {2e3 / median:.2f} img/s), peak device memory {peak:.3f} GiB; "
          f"loss {losses}, grad norm [{norms}]; launches per step {per_step[0]}", flush=True)
    del state, trainer

    # gradient accumulation 2: the weights move at the second micro-step only
    trainer = E2ETrainer(config.replace(gradient_accumulation_steps=2), unet, vae, empty,
                         compute_dtype=torch.bfloat16)
    state = trainer.init_state()
    start = {n: state.params[n].detach().clone() for n in watched}
    state, _ = trainer.train_step(state, batches[0])
    check(state.step == 0 and all(torch.equal(state.params[n], start[n]) for n in watched),
          "accumulation 2: weights moved at the first micro-step")
    state, m = trainer.train_step(state, batches[1])
    check(state.step == 1 and not any(torch.equal(state.params[n], start[n]) for n in watched),
          "accumulation 2: weights did not move at the second micro-step")
    print(f"[train] accumulation 2: weights unchanged after micro-step 1, moved after micro-step 2 "
          f"(grad norm {float(m['grad_norm']):.4f})", flush=True)
    del state, trainer

    # the A/B on this card, in turns: the frozen VAE's resnet pairs plain, fused, fused, plain
    arms: dict = {False: [], True: []}
    for fused in (False, True, True, False):
        trainer = E2ETrainer(config.replace(fused_vae_kernels=fused), unet, vae, empty, compute_dtype=torch.bfloat16)
        torch.cuda.reset_peak_memory_stats()
        state, ms, per_step, _ = timed_steps(trainer, trainer.init_state(), batches[:AB_STEPS])
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = step_launches(UNET_SITES_480x640, "v1" if fused else None)
        check(all(s == want for s in per_step), f"fused_vae_kernels={fused}: launches per step {per_step}")
        arms[fused] += ms[1:]
        print(f"[train-ab] bf16 480x640 bs 2, fused_vae_kernels={fused}: ms/step {[round(x, 1) for x in ms]} "
              f"(the first is the warm-up), peak device memory {peak:.3f} GiB", flush=True)
        del state, trainer
    print("[train-ab] median ms/step after the warm-ups: " + ", ".join(
        f"fused_vae_kernels={f} {statistics.median(v):.1f} ({2e3 / statistics.median(v):.2f} img/s)"
        for f, v in arms.items()), flush=True)

    # the single-launch v2 kernel: AB_STEPS steps from the state v1's loss was taken at
    trainer = E2ETrainer(config, unet, vae, empty, compute_dtype=torch.bfloat16)
    state = trainer.init_state()
    loss_v1 = float(trainer.value_and_grad(batches[0])[0])
    os.environ["E2EFT_GNCONV_IMPL"] = "v2"
    reset_launches()  # the v2 path's run starts here
    state, ms, per_step, losses = timed_steps(trainer, state, batches[:AB_STEPS])
    v2_launches = read_launches()  # ... and ends here
    os.environ.pop("E2EFT_GNCONV_IMPL")
    rel = abs(losses[0] - loss_v1) / abs(loss_v1)
    print(f"[train-v2] E2EFT_GNCONV_IMPL=v2, {AB_STEPS} steps: first loss {losses[0]:.6f} vs v1 {loss_v1:.6f} "
          f"(rel {rel:.2e}, bound {V2_LOSS_BOUND}); ms/step {[round(x, 1) for x in ms]}, median after the first "
          f"{statistics.median(ms[1:]):.1f} vs v1 {statistics.median(arms[True]):.1f} (the A/B above); launches per "
          f"step {per_step[0]}", flush=True)
    want = step_launches(UNET_SITES_480x640, "v2")
    check(all(s == want for s in per_step), f"v2 step launches {per_step}")
    check(np.isfinite(losses).all() and rel <= V2_LOSS_BOUND, f"v2 losses {losses} vs v1 {loss_v1}")
    launches["gn_silu_conv3x3_v2"] = v2_launches["gn_silu_conv3x3_v2"]
    return launches


def reference_by_head(fa, q, k, v) -> torch.Tensor:
    """The plain version in fp32, one head at a time (the whole [1, 18432, 8, 40]
    call would hold 11 GB of logits and a softmax copy)."""
    heads = [fa.flash_attention_reference(*(t[:, :, h:h + 1].float() for t in (q, k, v))) for h in range(q.shape[2])]
    return torch.cat(heads, dim=2)


def phase_geowizard_kernels(fa) -> dict:
    """The forward kernel at GeoWizard's head dims and the heads-per-block
    kernel against the plain version, and their bf16 times beside the plain
    version's and the library call's. Returns the heads-per-block row's
    numbers at the 768x768 level-0 shape (hp = 2), and the forward's there."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = {"flash_attention_fwd": 0.0, "flash_attention_fwd_mh": 0.0}
    fwd_row = mh_ms = None
    for dtype, tol in ((torch.float32, FP32_BOUND), (torch.bfloat16, BF16_BOUND)):
        for shape in GEO_ATTN_CASES:
            q, k, v = (torch.randn(shape, device="cuda", generator=gen).to(dtype) for _ in range(3))
            outs = {1: fa.flash_attention(q, k, v)}
            if shape[-1] == 40:
                outs.update({hp: fa.flash_attention_mh(q, k, v, None, hp) for hp in MH_HEADS})
            torch.cuda.synchronize()
            ref = reference_by_head(fa, q, k, v)
            errs = {}
            for hp, out in outs.items():
                check(out.dtype == dtype and bool(torch.isfinite(out).all()), f"hp={hp} {shape} {dtype}: {out.dtype}")
                errs[hp] = rel_err(out, ref)
                check(errs[hp][1] <= tol,
                      f"hp={hp} kernel vs plain max|d|/max|plain| {errs[hp][1]} > {tol} at {shape} {dtype}")
                name = "flash_attention_fwd" if hp == 1 else "flash_attention_fwd_mh"
                worst[name] = max(worst[name], errs[hp][0])
            line = f"[geo-kernel] {str(dtype):15s} B,L,N,D={shape}: max|plain| {ref.abs().max().item():.3e}, " \
                "max|d|/max|plain| " + ", ".join(f"hp={hp} {e[1]:.3e}" for hp, e in errs.items()) + f" (bound {tol})"
            del ref
            if dtype == torch.bfloat16:  # times in the serving dtype
                times = forward_times(fa, q, k, v, plain_reps=5)
                ms = {hp: time_ms(lambda hp=hp: fa.flash_attention_mh(q, k, v, None, hp)) for hp in outs if hp > 1}
                line += "; " + times.pop("text") + "".join(f", hp={hp} {t:.4f} ms" for hp, t in ms.items())
                if shape == GEO_ATTN_CASES[0]:
                    fwd_row, mh_ms = times, ms[2]
            print(line, flush=True)
            del q, k, v, outs
            torch.cuda.empty_cache()
    return {"flash_attention_fwd_mh": {"max_abs_err": worst["flash_attention_fwd_mh"], "ms": mh_ms,
                                       **{k: fwd_row[k] for k in ("plain_ms", "library_ms", "bound_ms", "bound_by")}},
            "worst_fwd": worst["flash_attention_fwd"], "fwd_row": fwd_row}


def geowizard_full_width(seed: int, device):
    from diffusion_e2e_ft_tpu_torch.models import UNetConfig, VAEConfig
    from diffusion_e2e_ft_tpu_torch.models.clip import CLIPVisionConfig
    from diffusion_e2e_ft_tpu_torch.pipelines import GeoWizardPipeline

    return GeoWizardPipeline.from_random(UNetConfig.geowizard(), VAEConfig(), CLIPVisionConfig(), seed=seed,
                                         device=device)


def phase_geowizard_parity(fa):
    """fp32 full-width GeoWizard, one 256x256 and one 512x512 image: CPU (plain)
    vs GPU (kernels). The GPU pipeline takes the CPU one's modules (moved in
    place), so every CPU output comes first."""
    from diffusion_e2e_ft_tpu_torch.pipelines import GeoWizardPipeline

    t0 = time.perf_counter()
    cpu = geowizard_full_width(seed=2, device="cpu")
    print(f"[geo-e2e] random init on the cpu {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(6)
    rgbs, wants = {}, {}
    for size in GEO_PARITY_SITES:
        img = rng.integers(0, 256, (1, size, size, 3)).astype(np.float32)
        rgbs[size] = torch.from_numpy(img / 255.0 * 2.0 - 1.0)
        t0 = time.perf_counter()
        wants[size] = dict(zip(("depth", "normals"), cpu.infer(rgbs[size], "indoor")))
        print(f"[geo-e2e] cpu fp32 {size}x{size} runs {time.perf_counter() - t0:.1f} s", flush=True)
    gpu = GeoWizardPipeline(cpu.unet, cpu.vae, cpu.image_encoder, cpu.scheduler_config, device="cuda",
                            dtype=torch.float32)
    for size, sites in GEO_PARITY_SITES.items():
        reset_launches()
        got = dict(zip(("depth", "normals"), gpu.infer(rgbs[size].cuda(), "indoor")))
        torch.cuda.synchronize()
        launches = read_launches()
        for task, ref in wants[size].items():
            err = (got[task].cpu() - ref).abs().max().item()
            print(f"[geo-e2e] fp32 {size}x{size} {task}, gpu vs cpu: max|d|={err:.3e} (bound {E2E_BOUNDS[task]})",
                  flush=True)
            check(bool(torch.isfinite(got[task]).all()), f"gpu GeoWizard {task} not finite")
            check(err <= E2E_BOUNDS[task], f"fp32 GeoWizard {size} {task} gpu vs cpu max|d| {err} > {E2E_BOUNDS[task]}")
        print(f"[geo-e2e] {size}x{size} kernel launches {launches}", flush=True)
        want = {**dict.fromkeys(launches, 0), "flash_attention_fwd": sites,
                **geo_request_gn((size, size), torch.float32)}
        check(launches == want, f"GeoWizard {size}x{size} launched {launches}, expected {want}")
    return gpu


def phase_geowizard_serving(fa, fp32_pipe) -> tuple:
    """Slice B's main path: an HF directory of the parity run's weights, loaded
    with `GeoWizardPipeline.from_hf_dir` in bf16 on the default device, and
    joint requests at 768x768 and 576x768; then one 768x768 request with
    E2EFT_FA_HP=2. Returns the kernel launches of the path's run and the
    bf16 pipeline."""
    from diffusion_e2e_ft_tpu_torch.pipelines import GeoWizardPipeline, loading

    with tempfile.TemporaryDirectory() as ckpt:
        t0 = time.perf_counter()
        p = fp32_pipe
        write_hf_dir(ckpt, {
            "unet": (p.unet, loading.unet_config_to_hf(p.unet.config), "diffusion_pytorch_model.bin"),
            "vae": (p.vae, loading.vae_config_to_hf(p.vae.config), "diffusion_pytorch_model.bin"),
            "image_encoder": (p.image_encoder, loading.vision_config_to_hf(p.image_encoder.config),
                              "pytorch_model.bin"),
        })
        del fp32_pipe, p
        gc.collect()  # the fp32 UNet sits in a reference cycle: free it before the bf16 peak below
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        pipe = GeoWizardPipeline.from_hf_dir(ckpt, dtype=torch.bfloat16)  # the device defaults to the card
        torch.cuda.synchronize()
        print(f"[geo-serve] wrote checkpoint {t1 - t0:.1f} s, from_hf_dir (bf16) {time.perf_counter() - t1:.1f} s "
              f"on {pipe.device}", flush=True)
    check(pipe.device.type == "cuda", f"from_hf_dir without a device put the pipeline on {pipe.device}")

    rng = np.random.default_rng(7)
    images = {hw: rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for hw in GEO_SITES}
    t0 = time.perf_counter()
    for hw, img in images.items():  # warm-up, outside the path's run
        pipe(img, color_map=None)
    torch.cuda.synchronize()
    print(f"[geo-serve] warmup {time.perf_counter() - t0:.2f} s", flush=True)

    requests = [(hw, domain) for hw in GEO_SITES for domain in ("indoor", "outdoor")] * 3
    latencies, outputs = {}, {}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # the main path's run starts here
    for hw, domain in requests:
        before = read_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipe(images[hw], domain=domain, color_map=None)
        torch.cuda.synchronize()
        latencies.setdefault((hw, domain), []).append((time.perf_counter() - t0) * 1e3)
        after = read_launches()
        done = {k: after[k] - before[k] for k in after}
        check(done == {**dict.fromkeys(done, 0), "flash_attention_fwd": GEO_SITES[hw],
                       **geo_request_gn(hw, torch.bfloat16)},
              f"GeoWizard {hw} {domain}: launches {done}, expected {GEO_SITES[hw]} forward")
        check(out.depth_np.shape == hw and out.normal_np.shape == hw + (3,), f"{hw}: shapes "
              f"{out.depth_np.shape} {out.normal_np.shape}")
        check(bool(np.isfinite(out.depth_np).all() and np.isfinite(out.normal_np).all()), f"{hw}: non-finite")
        check(out.depth_np.min() >= 0.0 and out.depth_np.max() <= 1.0, f"depth {hw} outside [0, 1]")
        check(bool((np.linalg.norm(out.normal_np, axis=-1) <= 1.0 + 1e-3).all()), f"normals {hw}: norm above 1")
        outputs[(hw, domain)] = out
    check(not np.array_equal(outputs[((768, 768), "indoor")].depth_np, outputs[((768, 768), "outdoor")].depth_np),
          "the domain switcher does not change the depth")
    peak = torch.cuda.max_memory_allocated() / 2**30

    os.environ["E2EFT_FA_HP"] = "2"  # the heads-per-block kernel at the d=40 sites
    before = read_launches()
    mh = pipe(images[(768, 768)], domain="indoor", color_map=None)
    torch.cuda.synchronize()
    os.environ.pop("E2EFT_FA_HP")
    launches = read_launches()  # ... and ends here
    done = {k: launches[k] - before[k] for k in launches}
    want = {**dict.fromkeys(done, 0), "flash_attention_fwd_mh": GEO_MH_SITES,
            "flash_attention_fwd": GEO_SITES[(768, 768)] - GEO_MH_SITES, **geo_request_gn((768, 768), torch.bfloat16)}
    check(done == want, f"E2EFT_FA_HP=2 request launched {done}")
    ref = outputs[((768, 768), "indoor")]
    mh_err = max(np.abs(mh.depth_np - ref.depth_np).max(), np.abs(mh.normal_np - ref.normal_np).max())
    check(mh_err <= BF16_BOUND, f"E2EFT_FA_HP=2 vs hp=1 max|d| {mh_err} > {BF16_BOUND}")

    for (hw, domain), ms in latencies.items():
        print(f"[geo-serve] bf16 joint {hw[0]}x{hw[1]} {domain}: latency ms {[round(x, 2) for x in ms]} "
              f"(median {statistics.median(ms):.2f})", flush=True)
    print(f"[geo-serve] peak device memory {peak:.3f} GiB over {len(requests)} requests; "
          f"E2EFT_FA_HP=2 768x768: launches {done}, max|d| vs hp=1 {mh_err:.3e}; "
          f"the path's kernel launches {launches}", flush=True)
    return launches, pipe


def joint_batch(rng, b: int, h: int, w: int) -> dict:
    """A synthetic GeoWizard batch: rgb in [-1, 1], depth in [-1, 1], unit
    normals, a domain, and a mask with an invalid block in each image (so
    the 8x-pooled latent mask keeps valid cells) and invalid pixels in it."""
    n = rng.normal(size=(b, h, w, 3)).astype(np.float32)
    mask = np.ones((b, h, w), bool)
    for i in range(b):
        y, x = rng.integers(0, h // 2), rng.integers(0, w // 2)
        mask[i, y:y + h // 4, x:x + w // 4] = rng.random((h // 4, w // 4)) > 0.5
    return {"rgb": rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32),
            "depth_target": rng.uniform(-1, 1, (b, h, w)).astype(np.float32),
            "normal_target": n / np.linalg.norm(n, axis=-1, keepdims=True), "val_mask": mask,
            "domain": np.eye(3, dtype=np.float32)[rng.integers(0, 3)]}


def phase_geowizard_train_parity() -> tuple:
    """One GeoWizard joint step's loss, per-loss metrics and gradients, fp32,
    TF32 off, the default fused VAE and UNet checkpointing, full width at
    256x256 bs 1: CPU (plain) vs GPU (kernels), in E2E mode and in
    diffusion-loss mode (the same explicit t and gaussian noise on both
    sides). Returns the GPU UNet and the CPU VAE and image tower."""
    from diffusion_e2e_ft_tpu_torch.training import GeoWizardTrainer, TrainConfig

    t0 = time.perf_counter()
    cpu = geowizard_full_width(seed=3, device="cpu")
    print(f"[geo-train-parity] random init on the cpu {time.perf_counter() - t0:.1f} s", flush=True)
    gpu_unet = copy.deepcopy(cpu.unet).cuda()
    sites, handles = kernel_sites(gpu_unet)
    rng = np.random.default_rng(8)
    batch = joint_batch(rng, 1, 256, 256)
    explicit = {"timesteps": torch.tensor([int(rng.integers(0, 1000))]),
                "noise": torch.randn((2, 4, 32, 32), generator=torch.Generator().manual_seed(8))}
    for e2e in (True, False):
        config = TrainConfig(e2e=e2e, gradient_checkpointing=True, gradient_accumulation_steps=1)
        kw = {} if e2e else explicit
        t0 = time.perf_counter()
        loss_c, m_c, grads_c = GeoWizardTrainer(config, cpu.unet, cpu.vae, cpu.image_encoder).value_and_grad(
            batch, **kw)
        t1 = time.perf_counter()
        reset_launches()
        loss_g, m_g, grads_g = GeoWizardTrainer(config, gpu_unet, cpu.vae, cpu.image_encoder).value_and_grad(
            batch, **kw)
        torch.cuda.synchronize()
        launches = read_launches()
        mode = "e2e" if e2e else "diffusion-loss"
        norm_c = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in grads_c.values()])))
        norm_g = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in grads_g.values()])))
        metric_rel = {k: abs(float(m_g[k]) - float(m_c[k])) / abs(float(m_c[k])) for k in m_c}
        norm_rel = abs(norm_g - norm_c) / norm_c
        leaf_rel = {n: float((grads_g[n].cpu() - grads_c[n]).abs().max() / grads_c[n].abs().max())
                    for n in GEO_PARITY_LEAVES}
        # the worst leaf over all of them, against the largest gradient entry of any leaf (a leaf's own
        # scale can be 0: the cross-attention keys see one context token, so their gradient is 0)
        diffs = {n: float((grads_g[n].cpu() - grads_c[n]).abs().max()) for n in grads_c}
        worst = max(diffs, key=diffs.get)
        worst_rel = diffs[worst] / max(float(g.abs().max()) for g in grads_c.values())
        print(f"[geo-train-parity] fp32 256x256 {mode}: " + ", ".join(
            f"{k} cpu {float(m_c[k]):.6f} gpu {float(m_g[k]):.6f} (rel {e:.2e})" for k, e in metric_rel.items())
            + f", grad norm cpu {norm_c:.6e} gpu {norm_g:.6e} (rel {norm_rel:.2e}), leaf rel max|d| "
            + ", ".join(f"{n.replace('.weight', '').split('attn1.')[-1]} {e:.2e}" for n, e in leaf_rel.items())
            + f"; worst leaf {worst} max|d| / max|g| over all leaves {worst_rel:.2e}; cpu step {t1 - t0:.1f} s; "
            f"launches {launches}", flush=True)
        check(float(loss_c) > 0 and abs(float(loss_c) - float(loss_g)) / float(loss_c) <= TRAIN_PARITY_BOUNDS["loss"],
              f"{mode}: loss cpu {float(loss_c)} gpu {float(loss_g)}")
        for k, e in metric_rel.items():
            check(e <= TRAIN_PARITY_BOUNDS["loss"], f"{mode}: {k} rel {e}")
        check(norm_rel <= TRAIN_PARITY_BOUNDS["grad_norm"], f"{mode}: grad norm rel {norm_rel}")
        for n, e in {**leaf_rel, worst: worst_rel}.items():
            check(e <= TRAIN_PARITY_BOUNDS["leaf"], f"{mode}: {n} rel max|d| {e}")
        check(len(sites) == GEO_TRAIN_SITES_256, f"GeoWizard joint kernel sites at 256x256: {sites}")
        check(launches == step_launches(GEO_TRAIN_SITES_256, e2e=e2e, hw=(256, 256), dtype=torch.float32),
              f"{mode}: launches {launches}")
        for name in [f"{site}.{proj}.weight" for site in sites for proj in ("to_q", "to_k", "to_v")] + [
                "class_embedding.linear_1.weight"]:
            g = grads_g[name]
            check(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0, f"{mode}: zero gradient at {name}")
    print(f"[geo-train-parity] every one of the {len(sites)} joint kernel sites' to_q/to_k/to_v and the class "
          "embedding have a non-zero gradient, both modes", flush=True)
    for handle in handles:
        handle.remove()
    return gpu_unet, cpu.vae, cpu.image_encoder


def phase_geowizard_train(unet, vae, image_encoder) -> dict:
    """Slice B2's main path: GeoWizardTrainer with the default TrainConfig
    (E2E, zeros noise, fused VAE, UNet checkpointing) + run_training at
    480x640 bs 2, bf16 compute, fp32 masters, on synthetic joint batches;
    then a few diffusion-loss steps and a few pyramid-noise steps. Returns the
    kernel launches of the main run."""
    from diffusion_e2e_ft_tpu_torch.training import GeoWizardTrainer, TrainConfig
    from diffusion_e2e_ft_tpu_torch.training.loop import run_training

    rng = np.random.default_rng(9)
    batches = [joint_batch(rng, 2, 480, 640) for _ in range(TRAIN_STEPS)]
    watched = ["conv_in.weight", "class_embedding.linear_1.weight"]
    with tempfile.TemporaryDirectory() as out_dir:
        config = TrainConfig(gradient_checkpointing=True, gradient_accumulation_steps=1, lr_warmup_steps=0,
                             train_batch_size=2, max_train_steps=TRAIN_STEPS, checkpointing_steps=10 * TRAIN_STEPS,
                             output_dir=out_dir)
        check(config.fused_vae_kernels and config.e2e and config.noise_type == "zeros",
              "the default TrainConfig: E2E, zeros noise, the fused VAE kernels")
        trainer = GeoWizardTrainer(config, unet, vae, image_encoder, compute_dtype=torch.bfloat16)
        step_ms, per_step = instrument(trainer)
        start = {n: dict(unet.named_parameters())[n].detach().clone() for n in watched}
        torch.cuda.reset_peak_memory_stats()
        reset_launches()  # the main path's run starts here
        state = run_training(trainer, trainer.init_state(), lambda epoch: batches, log_every=1)
        torch.cuda.synchronize()
        launches = read_launches()  # ... and ends here
        peak = torch.cuda.max_memory_allocated() / 2**30
        logs = [json.loads(line) for line in open(os.path.join(out_dir, "logs", "metrics.jsonl"))]
    check(state.step == TRAIN_STEPS and len(logs) == TRAIN_STEPS, f"ran {state.step} steps, {len(logs)} logged")
    for rec in logs:
        check(np.isfinite(rec["train_loss"]) and rec["train_loss"] > 0 and np.isfinite(rec["grad_norm"])
              and rec["grad_norm"] > 0, f"step {rec['step']}: loss {rec['train_loss']}, grad norm {rec['grad_norm']}")
    for n in watched:
        check(not torch.equal(state.params[n], start[n]), f"{n} did not change")
    want = step_launches(UNET_SITES_480x640)
    check(all(s == want for s in per_step), f"launches per step {per_step}, expected {want}")
    median = statistics.median(step_ms[1:])
    norms = ", ".join(f"{r['grad_norm']:.3e}" for r in logs)
    print(f"[geo-train] bf16 joint 480x640 bs 2, {TRAIN_STEPS} steps: ms/step {[round(x, 1) for x in step_ms]} "
          f"(median after the first {median:.1f}, {2e3 / median:.2f} img/s), peak device memory {peak:.3f} GiB; "
          f"loss {[round(r['train_loss'], 6) for r in logs]}, grad norm [{norms}]; launches per step {per_step[0]}",
          flush=True)
    del state, trainer

    # the diffusion-loss mode and the trainer's pyramid noise (GeoWizard's t-scaled octaves), a few steps each
    for label, cfg in (("diffusion loss", config.replace(e2e=False)), ("pyramid noise", config.replace(
            noise_type="pyramid"))):
        trainer = GeoWizardTrainer(cfg, unet, vae, image_encoder, compute_dtype=torch.bfloat16)
        generator = torch.Generator(device=trainer.device).manual_seed(cfg.seed)
        _, ms, per_step, losses = timed_steps(trainer, trainer.init_state(), batches[:GEO_EXTRA_STEPS], generator)
        want = step_launches(UNET_SITES_480x640, e2e=cfg.e2e)
        print(f"[geo-train] {label}, {GEO_EXTRA_STEPS} steps: loss {[round(x, 6) for x in losses]}, ms/step "
              f"{[round(x, 1) for x in ms]}; launches per step {per_step[0]}", flush=True)
        check(all(np.isfinite(x) and x > 0 for x in losses), f"{label}: losses {losses}")
        check(all(s == want for s in per_step), f"{label}: launches per step {per_step}, expected {want}")
        del trainer
    return launches


def plain_by_row(fa, q, k, v, dtype=None) -> torch.Tensor:
    """The plain version one batch row at a time, in `dtype` (default: the
    inputs'): a whole [10, 9216, 5, 64] call would hold 17 GB of fp32 logits."""
    return torch.cat([fa.flash_attention_reference(*(t[i:i + 1].to(dtype or t.dtype) for t in (q, k, v)))
                      for i in range(q.shape[0])])


def attention_shapes(hw, batch: int, heads, head_dims, pair: int = 1) -> list:
    """The (B, L, N, D) kernel 1 runs at in one device call on `batch`
    members at `hw`: the UNet's self-attention levels 0-3 (those in the
    kernels' envelope; `pair` 2 for GeoWizard's joint attention over each
    member's task pair), the VAE encoder's mid block at B = 1 (one encode a
    call, shared by its members) and the decoder's at `pair * batch`."""
    from diffusion_e2e_ft_tpu_torch.kernels import in_kernel_envelope

    h, w = hw[0] // 8, hw[1] // 8
    shapes = []
    for level, d in enumerate(head_dims):
        tokens = -(-h // 2**level) * -(-w // 2**level)
        if in_kernel_envelope(pair * tokens, pair * tokens, d):
            shapes.append((batch, pair * tokens, heads[level], d))
    return shapes + [(1, h * w, 1, 512), (pair * batch, h * w, 1, 512)]


def slice_c_attention_cases() -> dict:
    """{(B, L, N, D): the phase 15 request that first sends kernel 1 that
    shape}, from the requests' own sizes: (a) the baseline,
    `find_batch_size`'s members a call; (b) the LCM request, the same; (c)
    the GeoWizard ensemble, `batch_size` members a call (joint attention at
    8 heads, d 40 / 80 / 160, and the decode at 2N)."""
    from diffusion_e2e_ft_tpu_torch.pipelines import MarigoldPipeline

    def chunks(members: int, batch: int) -> set:
        return {batch, members % batch} - {0}

    cases: dict = {}
    for label, hw, kw in (("baseline", BASELINE_HW, BASELINE), ("LCM", LCM_HW, LCM_REQUEST)):
        members = kw["ensemble_size"]
        for batch in chunks(members, MarigoldPipeline.find_batch_size(members, max(hw))):
            for shape in attention_shapes(hw, batch, *SD2_ATTN):
                cases.setdefault(shape, label)
    for batch in chunks(GEO_ENSEMBLE["ensemble_size"], GEO_ENSEMBLE["batch_size"]):
        for shape in attention_shapes(GEO_ENSEMBLE_HW, batch, *GEO_ATTN, pair=2):
            cases.setdefault(shape, "GeoWizard")
    return cases


def eval_attention_cases() -> dict:
    """{(B, L, N, D): the phase 16 frame that first sends kernel 1 that
    shape}: one member a call at native resolution, Marigold at NYU's
    480x640 and KITTI's 352x1216 crop (a 44x152 latent: 6688, 1672 and 418
    tokens, ragged against the tiles), GeoWizard at 480x640, and
    run_marigold's 576x768 frames."""
    cases: dict = {}
    for label, hw, attn, pair in (("NYU", NYU_HW, SD2_ATTN, 1), ("KITTI", KITTI_HW, SD2_ATTN, 1),
                                  ("GeoWizard NYU", NYU_HW, GEO_ATTN, 2), ("run_marigold", RUN_HW, SD2_ATTN, 1)):
        for shape in attention_shapes(hw, 1, *attn, pair=pair):
            cases.setdefault(shape, label)
    return cases


@contextlib.contextmanager
def recorded_shapes(fa):
    """The (B, L, N, D) of every `flash_attention` call made inside the
    block (Lq != Lk adds (B, Lq, Lk, N, D)), as a set."""
    shapes, forward = set(), fa.flash_attention

    def record(q, k, v, scale=None):
        b, lq, n, d = q.shape
        shapes.add((b, lq, n, d) if k.shape[1] == lq else (b, lq, k.shape[1], n, d))
        return forward(q, k, v, scale)

    fa.flash_attention = record
    try:
        yield shapes
    finally:
        fa.flash_attention = forward


def phase_batched_kernels(fa) -> tuple:
    """Phase 3c: the forward kernel at every shape phase 15's requests and
    phase 16's frames send it (those phase 3 does not check already), and at
    the table's batch for a 10-member ensemble at 768x768, against the plain
    version (fp32, row by row), fp32 and bf16, with bf16 times beside the
    plain version's, the library's and the bound. Returns the largest max|d|
    and the bf16 rows."""
    from diffusion_e2e_ft_tpu_torch.pipelines import MarigoldPipeline

    gen = torch.Generator(device="cuda").manual_seed(9)
    worst, rows = 0.0, []
    cases = {s: label for s, label in {**eval_attention_cases(), **slice_c_attention_cases()}.items()
             if s not in ATTN_CASES}
    # the table's batch for the baseline's 10 members at 768x768 (processing_res 768), a request phase 15
    # does not send: UNet level 0 and the decoder's mid block
    b768 = MarigoldPipeline.find_batch_size(BASELINE["ensemble_size"], 768)
    cases.update({(b768, 9216, 5, 64): "table 768", (b768, 9216, 1, 512): "table 768"})
    for dtype, bound in ((torch.float32, FP32_BOUND), (torch.bfloat16, BF16_BOUND)):
        for shape, label in cases.items():
            q, k, v = (torch.randn(shape, device="cuda", generator=gen).to(dtype) for _ in range(3))
            out = fa.flash_attention(q, k, v)
            torch.cuda.synchronize()
            ref = plain_by_row(fa, q, k, v, torch.float32)
            err, rel = rel_err(out, ref)
            check(bool(torch.isfinite(out).all()), f"kernel output not finite at {shape} {dtype}")
            check(rel <= bound, f"kernel vs plain max|d|/max|plain| {rel} > {bound} at {shape} {dtype}")
            line = (f"[batched] {label:13s} {str(dtype):15s} B,L,N,D={shape}: max|d|={err:.3e}, /max|plain| "
                    f"{rel:.3e} (bound {bound})")
            del ref
            if dtype == torch.bfloat16:
                row = {"shape": list(shape), "request": label, "ms": time_ms(lambda: fa.flash_attention(q, k, v)),
                       "plain_ms": time_ms(lambda: plain_by_row(fa, q, k, v), reps=3),
                       "library_ms": time_ms(lambda: sdpa(q, k, v)), "library": sdpa_backend(q, k, v),
                       **attention_bound(shape, dtype, matmuls=2, tensors=4)}
                line += (f"; kernel {row['ms']:.4f} ms, plain (row by row) {row['plain_ms']:.4f}, library "
                         f"({row['library']}) {row['library_ms']:.4f}, bound {row['bound_ms']:.4f}; kernel/library "
                         f"{row['ms'] / row['library_ms']:.2f}, bound/kernel {row['bound_ms'] / row['ms']:.3f}")
                rows.append(row)
            print(line, flush=True)
            worst = max(worst, err)
            del q, k, v, out
            torch.cuda.empty_cache()
    return worst, rows


def request_launches(chunks: int, steps: int, unet_sites: int) -> int:
    """Kernel 1's launches of one request: each chunk of members encodes once
    (the VAE encoder's mid block), runs the UNet `steps` times and decodes once."""
    return chunks * (steps * unet_sites + 2)


def phase_slice_c_parity(fa) -> None:
    """Phase 14: slice C's device bodies, fp32, TF32 off, a full-width SD2
    Marigold with seeded random weights at 256x256 on the CPU (plain path) and
    the GPU (kernels) with the same explicit draws: DDIM, DDPM and LCM at 3
    steps, one member each; then a 3-member pyramid-noise DDIM ensemble,
    member by member, through `combine_depths` on the CPU's (s, t) and
    through `ensemble_depths` on each side."""
    from diffusion_e2e_ft_tpu_torch.models import UNetConfig, VAEConfig
    from diffusion_e2e_ft_tpu_torch.ops import noise as noise_ops
    from diffusion_e2e_ft_tpu_torch.pipelines import MarigoldPipeline

    t0 = time.perf_counter()
    cpu = MarigoldPipeline.from_random(UNetConfig.sd2(), VAEConfig(), seed=4, device="cpu")
    t1 = time.perf_counter()
    img = np.random.default_rng(9).integers(0, 256, (1, 256, 256, 3)).astype(np.float32)
    rgb = torch.from_numpy(img / 255.0 * 2.0 - 1.0)
    gen = torch.Generator().manual_seed(9)
    latent_shape = (4, 32, 32)
    runs = {}
    for kind in ("ddim", "ddpm", "lcm"):
        pipe = MarigoldPipeline(cpu.unet, cpu.vae, cpu.scheduler_config, cpu.empty_text_embed, device="cpu",
                                scheduler_type=kind)
        latent0, step_noise = noise_ops.member_draws("gaussian", gen, 1, latent_shape,
                                                     pipe.step_noises(SLICE_C_STEPS))
        runs[kind] = (latent0, step_noise, pipe.infer(rgb, SLICE_C_STEPS, latent0=latent0, step_noise=step_noise))
    members = 3
    ens_latent0, _ = noise_ops.member_draws("pyramid", gen, members, latent_shape)
    ens_want = cpu.infer(rgb, SLICE_C_STEPS, latent0=ens_latent0)
    print(f"[slice-c] cpu fp32: random init {t1 - t0:.1f} s, {3 * SLICE_C_STEPS + SLICE_C_STEPS} UNet calls "
          f"(3 runs + a {members}-member batch) {time.perf_counter() - t1:.1f} s", flush=True)

    gpu = MarigoldPipeline(cpu.unet, cpu.vae, cpu.scheduler_config, cpu.empty_text_embed, device="cuda",
                           dtype=torch.float32)
    bound = E2E_BOUNDS["depth"]
    for kind, (latent0, step_noise, want) in runs.items():
        pipe = MarigoldPipeline(gpu.unet, gpu.vae, gpu.scheduler_config, gpu.empty_text_embed, device="cuda",
                                scheduler_type=kind)
        reset_launches()
        got = pipe.infer(rgb.cuda(), SLICE_C_STEPS, latent0=latent0.cuda(), step_noise=[n.cuda() for n in step_noise])
        torch.cuda.synchronize()
        launches = read_launches()
        err = (got.cpu() - want).abs().max().item()
        expect = request_launches(1, SLICE_C_STEPS, UNET_SITES_256)
        print(f"[slice-c] fp32 256x256 {kind} {SLICE_C_STEPS} steps ({len(step_noise)} step noises), gpu vs cpu: "
              f"max|d|={err:.3e} (bound {bound}), kernel launches {launches['flash_attention_fwd']}", flush=True)
        check(bool(torch.isfinite(got).all()), f"gpu {kind} depth not finite")
        check(err <= bound, f"fp32 {kind} gpu vs cpu max|d| {err} > {bound}")
        check(launches == {**dict.fromkeys(launches, 0), "flash_attention_fwd": expect,
                           **request_gn((256, 256), torch.float32, 1, SLICE_C_STEPS)}, f"{kind}: launches {launches}")
    reset_launches()
    got = gpu.infer(rgb.cuda(), SLICE_C_STEPS, latent0=ens_latent0.cuda())
    torch.cuda.synchronize()
    launches = fa.launches["flash_attention_fwd"]
    member_err = (got.cpu() - ens_want).abs().amax(dim=(1, 2)).tolist()
    check(launches == request_launches(1, SLICE_C_STEPS, UNET_SITES_256), f"ensemble batch: {launches} launches")
    check(max(member_err) <= bound, f"ensemble members gpu vs cpu max|d| {member_err} > {bound}")

    t0 = time.perf_counter()
    with traced_bfgs("phase14"):
        checks = ensemble_checks(ens_want, got, max(member_err))
    print(f"[slice-c] fp32 256x256 {members}-member pyramid ensemble: members gpu vs cpu max|d| "
          f"{[f'{x:.3e}' for x in member_err]} (bound {bound}), {launches} kernel launches for the batch; "
          f"combine_depths on the cpu's BFGS (s, t), depth and uncertainty max|d|: the cpu's members on the card "
          f"{checks['combine']:.3e} (bound {COMBINE_BOUND}), the card's members {checks['members']:.3e} (bound "
          f"{checks['members_bound']:.3e}); ensemble_depths, the card's members on the card vs the cpu's on the "
          f"cpu: drift max|d| {checks['drift']:.3e} (BFGS drift bound {ENSEMBLE_DRIFT}); {time.perf_counter() - t0:.2f} s",
          flush=True)
    check(checks["finite"], "gpu ensemble not finite")
    check(checks["combine"] <= COMBINE_BOUND, f"combine_depths gpu vs cpu, same inputs: {checks}")
    check(checks["members"] <= checks["members_bound"], f"combine_depths on the card's members: {checks}")
    check(checks["drift"] <= ENSEMBLE_DRIFT, f"ensemble gpu vs cpu drift: {checks}")


@contextlib.contextmanager
def traced_bfgs(label: str, times: Optional[list] = None):
    """Inside the block, every `ops.ensemble.align_depths` call (scipy's
    BFGS) runs under `warnings.catch_warnings(record=True)`. At its end,
    each RuntimeWarning is printed once with its file, line and count, and
    the first call that warned has its members, arguments, (scale, shift)
    and warnings written to WARNED_MEMBERS under `label`. `times` gets each
    call's host ms, taken after a synchronise (the members' decode may still
    run on the card: not the BFGS's time)."""
    from diffusion_e2e_ft_tpu_torch.ops import ensemble as ens

    align, kept, seen, calls = ens.align_depths, [], {}, []

    def traced(images, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            result = align(images, *args, **kw)
        if times is not None:
            times.append((time.perf_counter() - t0) * 1e3)
        where = [f"{w.filename}:{w.lineno}: {w.message}" for w in caught if issubclass(w.category, RuntimeWarning)]
        calls.append(len(where))
        for key in where:
            seen[key] = seen.get(key, 0) + 1
        if where and not kept:
            kept.append({"members": images.float().cpu().numpy(), "args": json.dumps([list(args), kw]),
                         "scale": result[0], "shift": result[1], "where": json.dumps(where),
                         "device": str(images.device)})
        return result

    ens.align_depths = traced
    try:
        yield
    finally:
        ens.align_depths = align
    for key, n in seen.items():
        print(f"[bfgs] {label}: RuntimeWarning x{n} at {key}", flush=True)
    print(f"[bfgs] {label}: {sum(n > 0 for n in calls)} of {len(calls)} align_depths calls raised a "
          f"RuntimeWarning", flush=True)
    if kept:
        saved = dict(np.load(WARNED_MEMBERS)) if os.path.exists(WARNED_MEMBERS) else {}
        saved.update({f"{label}/{k}": np.asarray(v) for k, v in kept[0].items()})
        os.makedirs(os.path.dirname(WARNED_MEMBERS), exist_ok=True)
        np.savez_compressed(WARNED_MEMBERS, **saved)
        print(f"[bfgs] {label}: the first members that warned ({kept[0]['members'].shape}, on "
              f"{kept[0]['device']}) written to {WARNED_MEMBERS}", flush=True)


def ensemble_checks(cpu_members: torch.Tensor, members: torch.Tensor, member_err: float) -> dict:
    """`ensemble_depths` on `members` [N, H, W] (on the card) against the CPU
    reference `cpu_members`, whose largest difference is `member_err`:
    max |d| over depth and uncertainty of `combine_depths` given the CPU's
    BFGS (s, t), on the CPU's members moved to the card (`combine`) and on
    the card's own (`members`, with the bound their difference implies), and
    of the whole `ensemble_depths` (`drift`)."""
    from diffusion_e2e_ft_tpu_torch.ops import ensemble as ens

    def max_diff(got: tuple, want: tuple) -> float:
        return max((x.cpu() - y).abs().max().item() for x, y in zip(got, want))

    s, t = ens.align_depths(cpu_members)
    want = ens.combine_depths(cpu_members, s, t)
    # each aligned member moves by at most e = max|s| member_err, so the median, the MAD and each min-max
    # end by at most e, 2e and e: with R the CPU's median range, depth moves by <= 4e / (R - 2e) and the
    # uncertainty by <= 2e (1 + max unc) / (R - 2e)
    shift = float(np.max(np.abs(s))) * member_err
    aligned = cpu_members * torch.as_tensor(s, dtype=torch.float32)[:, None, None] + torch.as_tensor(
        t, dtype=torch.float32)[:, None, None]
    med = aligned.median(dim=0).values
    members_bound = 4 * shift * (1 + want[1].max().item()) / ((med.max() - med.min()).item() - 2 * shift)
    got = ens.ensemble_depths(members)
    return {
        "combine": max_diff(ens.combine_depths(cpu_members.to(members.device), s, t), want),
        "members": max_diff(ens.combine_depths(members, s, t), want),
        "members_bound": members_bound + COMBINE_BOUND,
        "drift": max_diff(got, want),
        "finite": bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()),
    }


def timed_requests(pipe, image, requests: list) -> list:
    """[(output, ms, kernel 1's launches)] of `pipe(image, **kw)` for each kw,
    host clock, synchronised."""
    from diffusion_e2e_ft_tpu_torch.kernels import flash_attention as fa

    out = []
    for kw in requests:
        before = fa.launches["flash_attention_fwd"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = pipe(image, color_map=None, **kw)
        torch.cuda.synchronize()
        out.append((result, (time.perf_counter() - t0) * 1e3, fa.launches["flash_attention_fwd"] - before))
    return out


def check_depth(out, hw, label: str) -> None:
    check(out.depth_np.shape == hw and bool(np.isfinite(out.depth_np).all()), f"{label}: depth {out.depth_np.shape}")
    check(out.depth_np.min() >= 0.0 and out.depth_np.max() <= 1.0, f"{label}: depth outside [0, 1]")
    unc = out.uncertainty
    check(unc is not None and unc.ndim == 2 and bool(np.isfinite(unc).all()) and unc.min() >= 0.0,
          f"{label}: uncertainty {None if unc is None else unc.shape}")


def phase_marigold_ensembles(fa, ckpt: str) -> int:
    """Phase 15 (a, b), slice C's main path: the HF directory phase 6 wrote,
    loaded with `from_hf_dir` in bf16 on the default device. (a) Marigold's
    baseline request (50-step trailing DDIM, ensemble 10, pyramid noise,
    480x640 at processing_res 0, seed 1234, the table's batch); (b) the same
    weights with an `LCMScheduler` config: 4 steps, ensemble 4, gaussian
    noise, 768x768. Returns kernel 1's launches of the path's run."""
    from diffusion_e2e_ft_tpu_torch.pipelines import MarigoldPipeline, loading

    pipe = MarigoldPipeline.from_hf_dir(ckpt, dtype=torch.bfloat16)
    check(pipe.device.type == "cuda" and pipe.scheduler_type == "ddim", f"{pipe.device} {pipe.scheduler_type}")
    rng = np.random.default_rng(10)
    image = rng.integers(0, 256, (*BASELINE_HW, 3), dtype=np.uint8)
    members = BASELINE["ensemble_size"]
    batch = pipe.find_batch_size(members, max(BASELINE_HW))
    expect = request_launches(-(-members // batch), BASELINE["denoising_steps"], UNET_SITES_480x640)
    norms = request_gn(BASELINE_HW, torch.bfloat16, -(-members // batch), BASELINE["denoising_steps"])
    bfgs = []
    with traced_bfgs("phase15a", times=bfgs):
        reset_launches()  # the main path's run starts here
        warmup = timed_requests(pipe, image, [dict(BASELINE, seed=BASELINE_SEED)])
        torch.cuda.reset_peak_memory_stats()
        runs = timed_requests(pipe, image, [dict(BASELINE, seed=BASELINE_SEED)] * BASELINE_WARM
                              + [dict(BASELINE, seed=BASELINE_SEED + 1)])
        peak = torch.cuda.max_memory_allocated() / 2**30
    first, first_ms, _ = warmup[0]
    other = runs[-1][0]
    for out, _, _ in warmup + runs:
        check_depth(out, BASELINE_HW, "baseline")
    ms = [t for _, t, _ in runs]
    print(f"[slice-c] bf16 Marigold baseline 480x640, {BASELINE['denoising_steps']} steps, ensemble {members}, "
          f"pyramid, batch {batch}: latency ms first {first_ms:.1f}, then {len(ms)} warm {[round(t, 1) for t in ms]}: "
          f"median {statistics.median(ms):.1f}, min {min(ms):.1f}, max {max(ms):.1f} (the last: seed + 1); "
          f"kernel 1 launches a request {[n for _, _, n in warmup + runs]} (expected {expect}); BFGS host ms "
          f"{[round(x, 1) for x in bfgs]}; peak device memory {peak:.3f} GiB", flush=True)
    check(all(n == expect for _, _, n in warmup + runs), f"baseline launches {[n for _, _, n in warmup + runs]} != {expect}")
    for again, _, _ in runs[:-1]:
        check(np.array_equal(first.depth_np, again.depth_np) and np.array_equal(first.uncertainty, again.uncertainty),
              "two requests with the same seed gave different bits")
    check(not np.array_equal(first.depth_np, other.depth_np), "another seed gave the same depth")
    del pipe
    torch.cuda.empty_cache()

    # (b) the same weights as a latent-consistency checkpoint
    with open(os.path.join(ckpt, "scheduler", "scheduler_config.json")) as f:
        config = loading.scheduler_config_from_hf(json.load(f))
    with open(os.path.join(ckpt, "scheduler", "scheduler_config.json"), "w") as f:
        json.dump(loading.scheduler_config_to_hf(config, "LCMScheduler"), f)
    lcm = MarigoldPipeline.from_hf_dir(ckpt, dtype=torch.bfloat16)
    check(lcm.scheduler_type == "lcm" and lcm.scheduler_config == config, f"LCM load: {lcm.scheduler_type}")
    image = rng.integers(0, 256, (*LCM_HW, 3), dtype=np.uint8)
    members = LCM_REQUEST["ensemble_size"]
    lcm_chunks = -(-members // lcm.find_batch_size(members, max(LCM_HW)))
    lcm_expect = request_launches(lcm_chunks, LCM_REQUEST["denoising_steps"], UNET_SITES_768)
    lcm_norms = request_gn(LCM_HW, torch.bfloat16, lcm_chunks, LCM_REQUEST["denoising_steps"])
    torch.cuda.reset_peak_memory_stats()
    with traced_bfgs("phase15b"):
        results = timed_requests(lcm, image, [dict(LCM_REQUEST, seed=s) for s in (0, 0, 1)])
    launches = read_launches()  # ... and ends here
    lcm_peak = torch.cuda.max_memory_allocated() / 2**30
    for out, _, _ in results:
        check_depth(out, LCM_HW, "LCM request")
    print(f"[slice-c] bf16 LCM 768x768, {LCM_REQUEST['denoising_steps']} steps, ensemble {members}, gaussian: "
          f"latency ms {[round(t, 1) for _, t, _ in results]}; kernel 1 launches a request "
          f"{[n for _, _, n in results]} (expected {lcm_expect}); peak device memory {lcm_peak:.3f} GiB", flush=True)
    check(all(n == lcm_expect for _, _, n in results), f"LCM launches {[n for _, _, n in results]}")
    check(np.array_equal(results[0][0].depth_np, results[1][0].depth_np), "LCM: same seed, different bits")
    check(not np.array_equal(results[0][0].depth_np, results[2][0].depth_np), "LCM: another seed, same depth")
    check(launches == {**dict.fromkeys(launches, 0),
                       "flash_attention_fwd": len(warmup + runs) * expect + len(results) * lcm_expect,
                       **gn_sum((len(warmup + runs), norms), (len(results), lcm_norms))},
          f"slice C's Marigold requests launched {launches}")
    return launches["flash_attention_fwd"]


def phase_geowizard_ensemble(fa, pipe) -> int:
    """Phase 15 (c): a GeoWizard ensemble request on slice B's bf16 pipeline:
    576x768, 10 DDIM steps, ensemble 10, pyramid noise, 5 members a call (a
    2N = 10 batch through the UNet and the decode). Returns kernel 1's
    launches of the run."""
    image = np.random.default_rng(11).integers(0, 256, (*GEO_ENSEMBLE_HW, 3), dtype=np.uint8)
    members, batch = GEO_ENSEMBLE["ensemble_size"], GEO_ENSEMBLE["batch_size"]
    expect = request_launches(-(-members // batch), GEO_ENSEMBLE["denoising_steps"], GEO_SITES[GEO_ENSEMBLE_HW] - 2)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # the path's run starts here
    with traced_bfgs("phase15c"):
        results = timed_requests(pipe, image, [dict(GEO_ENSEMBLE, seed=s) for s in (0, 0)])
    launches = read_launches()  # ... and ends here
    peak = torch.cuda.max_memory_allocated() / 2**30
    for out, _, _ in results:
        check_depth(out, GEO_ENSEMBLE_HW, "GeoWizard ensemble")
        check(out.normal_np.shape == GEO_ENSEMBLE_HW + (3,) and bool(np.isfinite(out.normal_np).all()),
              f"GeoWizard ensemble normals {out.normal_np.shape}")
    print(f"[slice-c] bf16 GeoWizard 576x768, {GEO_ENSEMBLE['denoising_steps']} steps, ensemble {members}, pyramid, "
          f"batch {batch}: latency ms {[round(t, 1) for _, t, _ in results]}; kernel 1 launches a request "
          f"{[n for _, _, n in results]} (expected {expect}); peak device memory {peak:.3f} GiB", flush=True)
    check(all(n == expect for _, _, n in results), f"GeoWizard ensemble launches {[n for _, _, n in results]}")
    norms = geo_request_gn(GEO_ENSEMBLE_HW, torch.bfloat16, -(-members // batch), GEO_ENSEMBLE["denoising_steps"])
    check(launches == {**dict.fromkeys(launches, 0), "flash_attention_fwd": 2 * expect, **gn_sum((2, norms))},
          f"launched {launches}")
    check(np.array_equal(results[0][0].normal_np, results[1][0].normal_np), "GeoWizard: same seed, different bits")
    return launches["flash_attention_fwd"]


# ---------------------------------------------------------------------------
# Phase 16: slice E1, the evaluation path
# ---------------------------------------------------------------------------


def compiler_finds(header: str) -> bool:
    """Whether g++ finds `header` on its include path."""
    gxx = shutil.which("g++")
    return gxx is not None and subprocess.run(
        [gxx, "-E", "-x", "c++", "-"], input=f"#include <{header}>\n", capture_output=True, text=True, timeout=120,
    ).returncode == 0


def phase_eval_host() -> None:
    """Phase 16a: what the host offers the path's image IO (it needs none of PIL, cv2, PyYAML)."""
    import importlib

    from diffusion_e2e_ft_tpu_torch import native_io
    from diffusion_e2e_ft_tpu_torch.data import image_io

    t0 = time.perf_counter()
    built = "built" if native_io.available() else f"unavailable ({native_io.build_error()})"
    found = {}
    for name in ("PIL", "cv2", "yaml"):
        try:
            found[name] = getattr(importlib.import_module(name), "__version__", "imports")
        except ImportError as e:
            found[name] = f"no ({e})"
    print(f"[eval] host: g++ {shutil.which('g++') or 'missing'}; png.h {compiler_finds('png.h')}, jpeglib.h "
          f"{compiler_finds('jpeglib.h')}; native_io {built} in {time.perf_counter() - t0:.1f} s; PNG decoder "
          f"{image_io.png_decoder()}; {found}", flush=True)


def write_config(path: str, template: str, **values) -> str:
    """A dataset config with the keys of `config/dataset/<template>`, `values` replacing some."""
    from diffusion_e2e_ft_tpu_torch.cli.common import load_dataset_config

    cfg = {**load_dataset_config(os.path.join(REPO_DIR, "config", "dataset", template)), **values}
    with open(path, "w") as f:
        f.writelines(f"{k}: {v}\n" for k, v in cfg.items())
    return path


def synthetic_depth(rng, hw, lo: float, hi: float, holes: float) -> np.ndarray:
    """A tilted plane from `lo` to `hi` metres with ripples; `holes` of the pixels 0 (no GT)."""
    yy, xx = np.meshgrid(np.linspace(0, 1, hw[0]), np.linspace(0, 1, hw[1]), indexing="ij")
    depth = lo + (hi - lo) * (0.6 * yy + 0.35 * xx + 0.05 * np.sin(20 * xx) * np.cos(15 * yy))
    depth[rng.random(hw) < holes] = 0.0
    return depth


def write_tar(path: str, members: dict) -> None:
    """A tar whose members are named `./<relative path>`, as the eval archives'."""
    import io
    import tarfile

    with tarfile.open(path, "w") as tar:
        for name, blob in members.items():
            info = tarfile.TarInfo("./" + name)
            info.size = len(blob)
            tar.addfile(info, io.BytesIO(blob))


def write_nyu_tree(root: str, rng, frames: int) -> str:
    """Phase 16b: an NYU-layout tar of `frames` 480x640 frames (an RGB PNG, a
    16-bit depth PNG in mm, a filled-depth PNG; frame 0's RGB rows all Paeth,
    1's Average), its filename list and its dataset config."""
    from diffusion_e2e_ft_tpu_torch.data import image_io

    members, lines, scene = {}, [], "test/kitchen_0004"
    for i in range(frames):
        mm = np.round(synthetic_depth(rng, NYU_HW, 1.0, 9.0, 0.05) * 1000).astype(np.uint16)
        members[f"{scene}/rgb_{i:04d}.png"] = image_io.encode_png(
            rng.integers(0, 256, (*NYU_HW, 3), dtype=np.uint8), filter_type=(4, 3, 2, 1)[i % 4])
        members[f"{scene}/depth_{i:04d}.png"] = image_io.encode_png(mm)
        members[f"{scene}/filled_{i:04d}.png"] = image_io.encode_png(np.where(mm == 0, 5000, mm).astype(np.uint16))
        lines.append(f"{scene}/rgb_{i:04d}.png {scene}/depth_{i:04d}.png {scene}/filled_{i:04d}.png")
    write_tar(os.path.join(root, "nyu_test.tar"), members)
    with open(os.path.join(root, "nyu_list.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return write_config(os.path.join(root, "data_nyu.yaml"), "data_nyu_test.yaml", dir="nyu_test.tar",
                        filenames=os.path.join(root, "nyu_list.txt"))


def write_kitti_tree(root: str, rng) -> str:
    """Phase 16c: a KITTI-layout directory: one 375x1242 frame with sparse
    16-bit GT (metres x 256) and one list line without GT (`None`), which
    the reader drops."""
    from diffusion_e2e_ft_tpu_torch.data import image_io

    drive = "2011_09_26_drive_0002_sync"
    rgb = f"2011_09_26/{drive}/image_02/data/0000000069.png"
    gt = f"{drive}/proj_depth/groundtruth/image_02/0000000069.png"
    for rel, a in ((rgb, rng.integers(0, 256, (*KITTI_RAW_HW, 3), dtype=np.uint8)),
                   (gt, np.round(synthetic_depth(rng, KITTI_RAW_HW, 4.0, 70.0, 0.8) * 256).astype(np.uint16))):
        os.makedirs(os.path.dirname(os.path.join(root, "kitti", rel)), exist_ok=True)
        image_io.write_png(os.path.join(root, "kitti", rel), a)
    with open(os.path.join(root, "kitti_list.txt"), "w") as f:
        f.write(f"{rgb} {gt} 721.5377\n2011_09_26/{drive}/image_02/data/0000000054.png None 721.5377\n")
    return write_config(os.path.join(root, "data_kitti.yaml"), "data_kitti_eigen_test.yaml", dir="kitti",
                        filenames=os.path.join(root, "kitti_list.txt"))


def timed_infer(pipeline_cls, argv: list) -> tuple:
    """`cli.infer.main(argv)` with each frame's host ms split into read +
    decode (`DepthEvalDataset.__getitem__`), pipeline (`__call__` of
    `pipeline_cls`, synchronised) and save (the rest, up to the next read),
    and kernel 1's launches in each pipeline call. Returns (frames, the
    readers' PNG decoders)."""
    from diffusion_e2e_ft_tpu_torch.cli import infer
    from diffusion_e2e_ft_tpu_torch.data.depth_eval import DepthEvalDataset
    from diffusion_e2e_ft_tpu_torch.kernels import flash_attention as fa

    frames, decoders = [], set()
    getitem, call = DepthEvalDataset.__getitem__, pipeline_cls.__call__

    def timed_getitem(self, index):
        t0 = time.perf_counter()
        if frames:
            frames[-1]["save"] = (t0 - frames[-1].pop("end")) * 1e3
        sample = getitem(self, index)
        decoders.add(self.decoder)
        frames.append({"read": (time.perf_counter() - t0) * 1e3})
        return sample

    def timed_call(self, *args, **kw):
        torch.cuda.synchronize()
        before, t0 = fa.launches["flash_attention_fwd"], time.perf_counter()
        out = call(self, *args, **kw)
        torch.cuda.synchronize()
        end = time.perf_counter()
        frames[-1].update(pipeline=(end - t0) * 1e3, launches=fa.launches["flash_attention_fwd"] - before, end=end)
        return out

    DepthEvalDataset.__getitem__, pipeline_cls.__call__ = timed_getitem, timed_call
    try:
        infer.main(argv)
    finally:
        DepthEvalDataset.__getitem__, pipeline_cls.__call__ = getitem, call
    frames[-1]["save"] = (time.perf_counter() - frames[-1].pop("end")) * 1e3
    return frames, decoders


def check_dump(label: str, out: str, hw, frames: list, names: list) -> None:
    """One finite [0, 1] depth .npy of shape `hw` a frame, named `names`,
    kernel 1 EVAL_SITES times a frame, and the arguments record."""
    got = sorted(f for f in os.listdir(out) if f.endswith(".npy"))
    check(got == sorted(names), f"{label}: dump {got}, expected {names}")
    for name in names:
        d = np.load(os.path.join(out, name))
        check(d.shape == hw and d.dtype == np.float32 and bool(np.isfinite(d).all()), f"{label} {name}: {d.shape}")
        check(d.min() >= 0.0 and d.max() <= 1.0, f"{label} {name}: depth outside [0, 1]")
    check(all(f["launches"] == EVAL_SITES for f in frames), f"{label}: kernel 1 launches a frame "
          f"{[f['launches'] for f in frames]}, expected {EVAL_SITES}")
    check(os.path.exists(os.path.join(out, "arguments.txt")), f"{label}: no arguments.txt")


def print_frames(label: str, hw, frames: list, decoders: set) -> None:
    warm = frames[1:] or frames
    med = {k: statistics.median(f[k] for f in warm) for k in ("read", "pipeline", "save")}
    print(f"[eval] infer {label} {hw[0]}x{hw[1]}, bf16, 1 step, PNG decoder {sorted(decoders)}: host ms a frame "
          f"(read+decode / pipeline / save) {[[round(f[k], 2) for k in ('read', 'pipeline', 'save')] for f in frames]}; "
          f"warm median {med['read']:.2f} / {med['pipeline']:.2f} / {med['save']:.2f} "
          f"({1e3 / sum(med.values()):.2f} frames/s); kernel 1 a frame {[f['launches'] for f in frames]}", flush=True)


def quiet(fn, *args):
    """`fn(*args)` with its standard output dropped (the eval CLIs print their tables)."""
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args)


def rel_diff(got: dict, want: dict) -> float:
    return max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-12) for k in want)


def phase_eval_path(fa, ckpt: str) -> int:
    """Phase 16 (a-g), slice E1's main path on phase 6's HF directory, bf16,
    through the port's CLIs with `--device cuda`: `infer` on synthetic NYU
    and KITTI trees at native resolution; `eval_depth` on the dumps (both
    alignments; cuda against cpu; a known-answer case); `eval_normals` on a
    DSINE nyuv2 tree; `run_marigold` on a folder of 576x768 PNGs, once under
    `--profile_dir`. Returns kernel 1's launches of the path's run."""
    from diffusion_e2e_ft_tpu_torch.cli import eval_depth, eval_normals, run_marigold
    from diffusion_e2e_ft_tpu_torch.cli.common import load_dataset_config
    from diffusion_e2e_ft_tpu_torch.data import depth_eval, image_io
    from diffusion_e2e_ft_tpu_torch.evaluation import metrics
    from diffusion_e2e_ft_tpu_torch.ops import image as im
    from diffusion_e2e_ft_tpu_torch.pipelines import MarigoldPipeline

    phase_eval_host()
    write_scheduler(ckpt)  # phase 15 left an LCMScheduler config there
    rng = np.random.default_rng(16)
    cuda = ["--device", "cuda"]
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        nyu, kitti = write_nyu_tree(work, rng, NYU_FRAMES), write_kitti_tree(work, rng)
        print(f"[eval] synthetic NYU tar ({NYU_FRAMES} frames) and KITTI tree written in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()  # the path's run starts here
        # (d) the depth dumps
        dumps = {}
        for label, config, hw, names in (
            ("NYU", nyu, NYU_HW, [f"pred_{i:04d}.npy" for i in range(NYU_FRAMES)]),
            ("KITTI cold", kitti, KITTI_HW, ["pred_0000000069.npy"]),  # the first call at this shape
            ("KITTI", kitti, KITTI_HW, ["pred_0000000069.npy"]),
        ):
            out = os.path.join(work, "infer_" + label)
            t0 = time.perf_counter()
            frames, decoders = timed_infer(MarigoldPipeline, [
                "--checkpoint", ckpt, "--dataset_config", config, "--base_data_dir", work, "--output_dir", out,
                "--half_precision", "--processing_res", "0", "--denoise_steps", "1", "--noise", "zeros", *cuda])
            print(f"[eval] cli.infer {label}: {time.perf_counter() - t0:.1f} s with the checkpoint's load", flush=True)
            check_dump(label, out, hw, frames, names)
            print_frames(label, hw, frames, decoders)
            dumps[label] = (config, out)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"[eval] peak device memory of the dumps {peak:.3f} GiB", flush=True)

        # (e) the depth eval: both alignments on the card, the same files on the cpu, and a known answer
        dataset = depth_eval.get_depth_dataset(load_dataset_config(nyu), work, depth_eval.DatasetMode.EVAL)
        known = {"least_square": lambda gt: 0.37 * gt + 0.05,
                 "least_square_disparity": lambda gt: np.where(gt > 0, 0.5 / np.maximum(gt, 1e-6) + 0.1, 0.0)}
        for alignment, affine in known.items():
            pred_dir = os.path.join(work, "known_" + alignment)
            os.makedirs(pred_dir)
            for i in range(len(dataset)):
                np.save(os.path.join(pred_dir, dataset.pred_name(i)),
                        affine(dataset[i]["depth_raw_linear"]).astype(np.float32))
            dumps["known " + alignment] = (nyu, pred_dir)
        for label, (config, pred_dir) in dumps.items():
            if label == "KITTI cold":
                continue
            for alignment in known:
                if label.startswith("known") and not label.endswith(alignment):
                    continue
                t0 = time.perf_counter()
                results = {dev: quiet(eval_depth.main, [
                    "--dataset_config", config, "--base_data_dir", work, "--prediction_dir", pred_dir,
                    "--alignment", alignment, "--output_dir", os.path.join(work, f"eval_{label}_{alignment}_{dev}"),
                    "--device", dev]) for dev in ("cuda", "cpu")}
                seconds = time.perf_counter() - t0
                got = results["cuda"]
                check(list(got) == list(metrics.DEPTH_METRIC_FUNCS) and all(np.isfinite(v) for v in got.values()),
                      f"eval {label} {alignment}: {got}")
                check(sorted(os.listdir(os.path.join(work, f"eval_{label}_{alignment}_cuda"))) ==
                      sorted(["per_sample_metrics.csv", f"eval_metrics-{alignment}.txt"]), f"eval {label}: files")
                if label.startswith("known"):  # float32 rounding on both devices: no relative comparison
                    for dev, res in results.items():
                        check(res["abs_relative_difference"] <= KNOWN_ANSWER_ABS_REL and res["delta1_acc"] == 1.0,
                              f"known answer {alignment} on {dev}: {res}")
                    comparison = (f"abs_rel on the cpu {results['cpu']['abs_relative_difference']:.3g} (bound "
                                  f"{KNOWN_ANSWER_ABS_REL} on both)")
                else:
                    rel = rel_diff(got, results["cpu"])
                    check(rel <= EVAL_CPU_RTOL, f"eval {label} {alignment}: cuda vs cpu {rel} > {EVAL_CPU_RTOL}")
                    comparison = f"cuda vs cpu max rel {rel:.2e} (bound {EVAL_CPU_RTOL})"
                print(f"[eval] eval_depth {label} {alignment}, cuda: abs_rel {got['abs_relative_difference']:.6g}, "
                      f"delta1 {got['delta1_acc']:.6g}, rmse {got['rmse_linear']:.6g}; {comparison}; both "
                      f"{seconds:.2f} s", flush=True)

        # (f) the normals: Marigold normals in bf16 over a DSINE nyuv2 tree
        scene = os.path.join(work, "dsine_eval", "nyuv2", "scene0")
        os.makedirs(scene)
        for i in range(2):
            stem = os.path.join(scene, f"{i:06d}")
            image_io.write_png(stem + "_img.png", rng.integers(0, 256, (*NYU_HW, 3), dtype=np.uint8))
            n = rng.normal(size=(*NYU_HW, 3))
            n8 = ((n / np.linalg.norm(n, axis=-1, keepdims=True) + 1) / 2 * 255).astype(np.uint8)
            n8[:8] = 0  # rows without GT
            image_io.write_png(stem + "_normal.png", n8, filter_type=4)
            np.save(stem + "_intrins.npy", np.array([[518.8, 0, 325.6], [0, 519.5, 253.7], [0, 0, 1]]))
        split = os.path.join(work, "dsine_eval", "nyuv2", "test.txt")
        with open(split, "w") as f:
            f.write("scene0/000000_img.png\nscene0/000001_img.png\n")
        before, t0 = fa.launches["flash_attention_fwd"], time.perf_counter()
        eval_normals.main(["--checkpoint", ckpt, "--base_data_dir", work, "--eval_data", "nyuv2", "--split_paths",
                           f"nyuv2={split}", "--output_dir", os.path.join(work, "normals"), "--half_precision", *cuda])
        seconds, done = time.perf_counter() - t0, fa.launches["flash_attention_fwd"] - before
        with open(os.path.join(work, "normals", "nyuv2_metrics.txt")) as f:
            header, values = f.read().split("\n")[:2]
        check(header.split() == ["mean", "median", "rmse", "a1", "a2", "a3", "a4", "a5"] and len(values.split()) == 8
              and all(np.isfinite(float(v)) for v in values.split()), f"nyuv2_metrics.txt: {header!r} {values!r}")
        check(done == 2 * EVAL_SITES, f"eval_normals: {done} kernel 1 launches for 2 frames")
        print(f"[eval] eval_normals nyuv2, 2 frames 480x640, bf16: {values.split()} in {seconds:.1f} s with the "
              f"checkpoint's load; kernel 1 {done}", flush=True)

        # (g) run_marigold over a folder of 576x768 PNGs, then again under the profiler
        images = os.path.join(work, "images")
        os.makedirs(images)
        for stem, filter_type in (("a", 4), ("b", 0)):
            image_io.write_png(os.path.join(images, f"{stem}.png"),
                               rng.integers(0, 256, (*RUN_HW, 3), dtype=np.uint8), filter_type)
        for run, extra in (("run", []), ("profiled", ["--profile_dir", os.path.join(work, "trace")])):
            out = os.path.join(work, run)
            before, t0 = fa.launches["flash_attention_fwd"], time.perf_counter()
            quiet(run_marigold.main, ["--checkpoint", ckpt, "--input_rgb_dir", images, "--output_dir", out,
                                      "--half_precision", *extra, *cuda])
            seconds, done = time.perf_counter() - t0, fa.launches["flash_attention_fwd"] - before
            check(done == 2 * EVAL_SITES, f"run_marigold {run}: {done} kernel 1 launches for 2 frames")
            for stem in ("a", "b"):
                depth = np.load(os.path.join(out, "depth_npy", f"{stem}_pred.npy"))
                bw = image_io.read_image(os.path.join(out, "depth_bw", f"{stem}_bw.png"))
                colored = image_io.read_image(os.path.join(out, "depth_colored", f"{stem}_colored.png"))
                check(depth.shape == RUN_HW and bw.dtype == np.uint16 and np.array_equal(bw, im.to_uint16(depth)),
                      f"run_marigold {stem}: depth_bw does not read back as to_uint16(depth_np)")
                check(colored.shape == (*RUN_HW, 3) and colored.dtype == np.uint8, f"depth_colored {colored.shape}")
            print(f"[eval] run_marigold {run}, 2 frames 576x768, bf16: {seconds:.1f} s with the checkpoint's load; "
                  f"kernel 1 {done}; depth_bw reads back as to_uint16(depth_np)", flush=True)
        with open(os.path.join(work, "trace", "trace.json")) as f:
            trace = f.read()
        check("flash_fwd" in trace, "run_marigold --profile_dir: no kernel 1 in the trace")
        print(f"[eval] run_marigold --profile_dir: trace.json {len(trace) / 2**20:.1f} MiB with kernel 1's device "
              f"events", flush=True)
    launches = read_launches()  # ... and ends here
    frames = NYU_FRAMES + 2 + 2 + 4  # the dumps, the normals, two run_marigold runs
    expect = {"flash_attention_fwd": frames * EVAL_SITES, **gn_sum(
        (NYU_FRAMES + 2, request_gn(NYU_HW, torch.bfloat16)), (2, request_gn(KITTI_HW, torch.bfloat16)),
        (4, request_gn(RUN_HW, torch.bfloat16)))}
    check(launches == {**dict.fromkeys(launches, 0), **expect}, f"the eval path launched {launches}, expected {expect}")
    return launches["flash_attention_fwd"]


def phase_eval_geowizard(fa, geo_pipe) -> int:
    """Phase 16d, GeoWizard: slice B's bf16 weights written as an HF
    directory and two NYU frames (the first cold) through `cli.infer
    --model_type geowizard` (joint attention at 480x640). Returns kernel 1's
    launches of the run."""
    from diffusion_e2e_ft_tpu_torch.pipelines import GeoWizardPipeline, loading

    with tempfile.TemporaryDirectory() as work:
        ckpt, p = os.path.join(work, "geowizard"), geo_pipe
        write_hf_dir(ckpt, {
            "unet": (p.unet, loading.unet_config_to_hf(p.unet.config), "diffusion_pytorch_model.bin"),
            "vae": (p.vae, loading.vae_config_to_hf(p.vae.config), "diffusion_pytorch_model.bin"),
            "image_encoder": (p.image_encoder, loading.vision_config_to_hf(p.image_encoder.config),
                              "pytorch_model.bin"),
        })
        config = write_nyu_tree(work, np.random.default_rng(17), 2)
        out = os.path.join(work, "infer")
        reset_launches()  # the path's run starts here
        t0 = time.perf_counter()
        frames, decoders = timed_infer(GeoWizardPipeline, [
            "--checkpoint", ckpt, "--model_type", "geowizard", "--domain", "indoor", "--dataset_config", config,
            "--base_data_dir", work, "--output_dir", out, "--half_precision", "--processing_res", "0", "--device",
            "cuda"])
        seconds = time.perf_counter() - t0
        launches = read_launches()  # ... and ends here
        check_dump("GeoWizard NYU", out, NYU_HW, frames, ["pred_0000.npy", "pred_0001.npy"])
        with open(os.path.join(out, "arguments.txt")) as f:
            check("model_type: geowizard" in f.read(), "GeoWizard dump: arguments.txt")
    print(f"[eval] cli.infer --model_type geowizard: {seconds:.1f} s with the checkpoint's load", flush=True)
    print_frames("GeoWizard NYU", NYU_HW, frames, decoders)
    check(launches == {**dict.fromkeys(launches, 0), "flash_attention_fwd": 2 * EVAL_SITES,
                       **gn_sum((2, geo_request_gn(NYU_HW, torch.bfloat16)))}, f"launched {launches}")
    return launches["flash_attention_fwd"]


# ---------------------------------------------------------------------------
# Phase 17: slice E2, the training-data path
# ---------------------------------------------------------------------------

HYPERSIM_RAW_HW = (768, 1024)  # Hypersim's frames; its reader resizes them to 480x640
HYPERSIM_SCENES, HYPERSIM_SCENE_FRAMES = 2, 9  # 18 frames: 9 batches of 2 beside VKITTI2's 1, a 9:1 epoch
VKITTI_FRAMES = 2
E2_EPOCH = 10  # one epoch of the 9:1 mix: 9 Hypersim batches and 1 VKITTI2 batch
E2_STEPS = 2 * E2_EPOCH  # two epochs: the second VKITTI2 step is the first warm one at its shape
# D2NT, float64 normals, the card vs the CPU: the same operations in the same order; only the soft-min's
# pow (CUDA's against the CPU's, a few ulps) may differ, and the MRF choice is held equal exactly
D2NT_CPU_BOUND = 1e-12
HYPERSIM_RGB_LEVELS, HYPERSIM_DEPTH_MM = 1, 1  # the written PNGs, --device cuda vs cpu


def phase_data_host() -> bool:
    """Phase 17a: which of PIL, cv2, pandas and h5py import. The readers need
    PIL (JPEG and 8-bit PNG decodes, the resize); without h5py, phase 17b
    feeds the frames' arrays to `preprocess_scene_frames` instead of the CLI."""
    import importlib

    found = {}
    for name in ("PIL", "cv2", "pandas", "h5py"):
        try:
            found[name] = getattr(importlib.import_module(name), "__version__", "imports")
        except ImportError as e:
            found[name] = None
            print(f"[data] {name} does not import: {e}", flush=True)
    print(f"[data] host: {found}", flush=True)
    check(found["PIL"] is not None, "PIL does not import: the training readers need it (JPEG, 8-bit PNG, resize)")
    if found["h5py"] is None:
        print("[data] no h5py: phase 17b feeds the frames' arrays to preprocess_scene_frames (the CLI's "
              "HDF5 reader is covered by the CPU tests)", flush=True)
    return found["h5py"] is not None


def hypersim_frame(rng, hw, index: int) -> tuple:
    """One synthetic raw Hypersim frame: linear HDR colour, distance to the
    camera centre in metres (a tilted floor, a box in front of it, a few NaN
    pixels with no hit) and render-entity ids (-1 on a window of no geometry)."""
    h, w = hw
    yy, xx = np.meshgrid(np.linspace(0, 1, h, dtype=np.float32), np.linspace(0, 1, w, dtype=np.float32),
                         indexing="ij")
    shade = (0.2 + xx * (1 + index % 3) + 0.5 * yy)[..., None]
    rgb = (rng.gamma(2.0, 0.5, (h, w, 3)).astype(np.float32) * shade * (0.5 + index / 4)).astype(np.float32)
    distance = (2.0 + 12.0 * (1 - yy) + 3.0 * xx).astype(np.float32)
    distance[h // 3 : h // 2, w // 4 + 20 * index : w // 2 + 20 * index] = 1.5
    distance[:4, :4] = np.nan
    entity = rng.integers(0, 50, (h, w)).astype(np.int32)
    entity[h // 8 : h // 4, w // 8 : w // 3] = -1
    return rgb, distance, entity


def write_hypersim_raw(root: str, out_dir: str, rng, with_h5py: bool) -> dict:
    """Phase 17b's raw tree: HYPERSIM_SCENES scenes of HYPERSIM_SCENE_FRAMES
    frames (HDF5 where h5py imports), and the `geometry_preview` normal PNGs
    the reader takes from `<out_dir>/normals`. Returns {scene: [frames]}."""
    from diffusion_e2e_ft_tpu_torch.data import image_io

    scenes = {}
    for s in range(HYPERSIM_SCENES):
        scene = f"ai_001_{s + 1:03d}"
        color = os.path.join(root, scene, "images", "scene_cam_00_final_hdf5")
        geom = os.path.join(root, scene, "images", "scene_cam_00_geometry_hdf5")
        normals = os.path.join(out_dir, "normals", scene, "images", "scene_cam_00_geometry_preview")
        for d in (color, geom, normals):
            os.makedirs(d)
        scenes[scene] = []
        for i in range(HYPERSIM_SCENE_FRAMES):
            frame = f"{i:04d}"
            rgb, distance, entity = hypersim_frame(rng, HYPERSIM_RAW_HW, s * HYPERSIM_SCENE_FRAMES + i)
            scenes[scene].append((frame, rgb, distance, entity))
            if with_h5py:
                import h5py

                for path, array in ((os.path.join(color, f"frame.{frame}.color.hdf5"), rgb),
                                    (os.path.join(geom, f"frame.{frame}.depth_meters.hdf5"), distance),
                                    (os.path.join(geom, f"frame.{frame}.render_entity_id.hdf5"), entity)):
                    with h5py.File(path, "w") as f:
                        f.create_dataset("dataset", data=array)
            n = rng.normal(size=(*HYPERSIM_RAW_HW, 3))
            n8 = ((n / np.linalg.norm(n, axis=-1, keepdims=True) + 1) / 2 * 255).astype(np.uint8)
            image_io.write_png(os.path.join(normals, f"frame.{frame}.normal_cam.png"), n8)
    return scenes


def run_preprocess(raw: str, out: str, device: str, scenes: dict, with_h5py: bool) -> str:
    """`cli.preprocess_hypersim` on `device` (or, without h5py, the same frames'
    arrays through `preprocess_scene_frames`); returns the CSV's path."""
    from diffusion_e2e_ft_tpu_torch.cli import preprocess_hypersim
    from diffusion_e2e_ft_tpu_torch.tools import hypersim_preprocess as hp

    if with_h5py:
        return quiet(preprocess_hypersim.main, ["--hypersim_raw_dir", raw, "--output_dir", out, "--device", device])
    rows = []
    for scene, frames in scenes.items():
        rows += hp.preprocess_scene_frames(frames, os.path.join(out, "train"), scene, device=device, progress=False)
    csv_path = os.path.join(out, "processed", "train", "filename_meta_train.csv")
    os.makedirs(os.path.dirname(csv_path), exist_ok=True)
    preprocess_hypersim.write_csv(csv_path, rows)
    return csv_path


def sync_ms(fn, reps: int) -> float:
    """Median host ms of `reps` calls, synchronised on both sides, after one warm-up call."""
    fn()
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms)


def phase_hypersim(work: str, rng, with_h5py: bool) -> str:
    """Phase 17b: a synthetic raw Hypersim tree through `cli.preprocess_hypersim
    --device cuda`; one scene's PNGs and CSV rows held against `--device cpu`;
    ms a frame. Returns the processed tree's root."""
    from diffusion_e2e_ft_tpu_torch.data import image_io
    from diffusion_e2e_ft_tpu_torch.tools import hypersim_preprocess as hp

    raw, out = os.path.join(work, "hypersim_raw"), os.path.join(work, "hypersim")
    t0 = time.perf_counter()
    scenes = write_hypersim_raw(raw, out, rng, with_h5py)
    frames = sum(len(f) for f in scenes.values())
    print(f"[data] synthetic Hypersim: {frames} frames {HYPERSIM_RAW_HW[0]}x{HYPERSIM_RAW_HW[1]} in "
          f"{len(scenes)} scenes ({'HDF5' if with_h5py else 'arrays'}) written in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    csv_path = run_preprocess(raw, out, "cuda", scenes, with_h5py)
    cli_ms = (time.perf_counter() - t0) * 1e3 / frames
    first = sorted(scenes)[0]
    cpu_raw, cpu_out = os.path.join(work, "hypersim_raw_cpu"), os.path.join(work, "hypersim_cpu")
    os.makedirs(cpu_raw)
    os.symlink(os.path.join(raw, first), os.path.join(cpu_raw, first))
    t0 = time.perf_counter()
    cpu_csv = run_preprocess(cpu_raw, cpu_out, "cpu", {first: scenes[first]}, with_h5py)
    cpu_cli_ms = (time.perf_counter() - t0) * 1e3 / len(scenes[first])
    with open(csv_path) as f:
        lines = f.read().splitlines()
    with open(cpu_csv) as f:
        cpu_lines = f.read().splitlines()
    check(len(lines) == frames + 1 and lines[0] == ",".join(hp.CSV_COLUMNS), f"Hypersim CSV: {lines[:2]}")
    check(cpu_lines == [lines[0]] + [x for x in lines[1:] if f",{first},cam_00," in x],
          f"Hypersim CSV rows, cuda vs cpu: {lines[:3]} vs {cpu_lines[:3]}")
    worst = {"rgb": 0, "depth": 0}
    for frame, *_ in scenes[first]:
        for kind in worst:
            rel = os.path.join("train", first, kind, f"frame.{frame}.png")
            got, want = (image_io.read_image(os.path.join(root, rel)).astype(np.int64) for root in (out, cpu_out))
            check(got.shape == want.shape == HYPERSIM_RAW_HW + ((3,) if kind == "rgb" else ()), f"{rel}: {got.shape}")
            worst[kind] = max(worst[kind], int(np.abs(got - want).max()))
    check(worst["rgb"] <= HYPERSIM_RGB_LEVELS and worst["depth"] <= HYPERSIM_DEPTH_MM,
          f"Hypersim PNGs, cuda vs cpu: {worst}")
    _, rgb, distance, entity = scenes[first][0]
    compute = {dev: sync_ms(lambda: hp.preprocess_frame(rgb, distance, entity, dev), 5 if dev == "cuda" else 2)
               for dev in ("cuda", "cpu")}
    print(f"[data] cli.preprocess_hypersim {frames} frames: {cli_ms:.1f} ms a frame on cuda (read, compute, two "
          f"PNG writes), {cpu_cli_ms:.1f} on cpu; preprocess_frame alone (host arrays in and out) "
          f"{compute['cuda']:.2f} ms on cuda, {compute['cpu']:.2f} on cpu; cuda vs cpu: CSV rows equal, max|d| rgb "
          f"{worst['rgb']} levels (bound {HYPERSIM_RGB_LEVELS}), depth {worst['depth']} mm (bound "
          f"{HYPERSIM_DEPTH_MM})", flush=True)
    return out


def vkitti_depth(index: int) -> np.ndarray:
    """One synthetic VKITTI2 depth frame, 16-bit cm: sky at 65535 above the
    horizon, a ground plane below it, a slanted wall and a fronto-parallel box
    in front (depth steps at their edges)."""
    from diffusion_e2e_ft_tpu_torch.tools.depth_to_normal import VKITTI_INTRINSICS

    h, w = KITTI_RAW_HW
    fx, fy, cx, cy = VKITTI_INTRINSICS
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    depth = np.where(v > cy + 4, fy * 160.0 / np.maximum(v - cy, 1.0), 65535.0)
    wall = (u > 950) & (v < 290)
    depth[wall] = 800.0 + 9.0 * (w - u[wall])
    depth[190:300, 300 + 120 * index : 520 + 120 * index] = 1200.0 + 40 * index
    return np.clip(np.round(depth), 1, 65535).astype(np.uint16)


def phase_vkitti(work: str, rng) -> str:
    """Phase 17c: a synthetic VKITTI2 tree (JPEG rgb, 16-bit cm depth) through
    `cli.gen_vkitti_normals --device cuda`; the normals held against the CPU's
    in float64 and the PNGs within 1 LSB; ms a frame. Returns the tree's root."""
    from PIL import Image

    from diffusion_e2e_ft_tpu_torch.cli import gen_vkitti_normals
    from diffusion_e2e_ft_tpu_torch.data import image_io
    from diffusion_e2e_ft_tpu_torch.tools import depth_to_normal as d2n

    root = os.path.join(work, "vkitti")
    leaf = os.path.join("Scene01", "morning", "frames")
    rgb_dir = os.path.join(root, "vkitti_2.0.3_rgb", leaf, "rgb", "Camera_0")
    depth_dir = os.path.join(root, "vkitti_2.0.3_depth", leaf, "depth", "Camera_0")
    for d in (rgb_dir, depth_dir):
        os.makedirs(d)
    for i in range(VKITTI_FRAMES):
        Image.fromarray(rng.integers(0, 256, (*KITTI_RAW_HW, 3), dtype=np.uint8)).save(
            os.path.join(rgb_dir, f"rgb_{i:05d}.jpg"), quality=90)
        image_io.write_png(os.path.join(depth_dir, f"depth_{i:05d}.png"), vkitti_depth(i))
    t0 = time.perf_counter()
    n = quiet(gen_vkitti_normals.main, ["--vkitti_root", root, "--device", "cuda"])
    cli_ms = (time.perf_counter() - t0) * 1e3 / VKITTI_FRAMES
    check(n == VKITTI_FRAMES, f"gen_vkitti_normals: {n} frames")
    worst, lsb, firsts = 0.0, 0, 0
    args = (*d2n.VKITTI_INTRINSICS, "v3")
    for depth_path, normal_path in d2n.vkitti_frames(root):
        depth = image_io.read_image(depth_path)
        got, want = (d2n.depth_to_normal64(depth, *args, device=dev) for dev in ("cuda", "cpu"))
        check(bool(torch.isfinite(got).all()) and got.shape == (*KITTI_RAW_HW, 3), f"{depth_path}: {got.shape}")
        worst = max(worst, float((got.cpu() - want).abs().max()))
        z = torch.from_numpy(depth.astype(np.float64))
        choice = d2n.mrf_choice(z.cuda()).cpu()
        check(torch.equal(choice, d2n.mrf_choice(z)), f"{depth_path}: the MRF choice differs, cuda vs cpu")
        firsts += int((choice == 0).sum())
        written = image_io.read_image(normal_path).astype(np.int64)
        lsb = max(lsb, int(np.abs(written - d2n.normal_to_uint16(want.float())).max()))
    check(worst <= D2NT_CPU_BOUND, f"D2NT float64, cuda vs cpu max|d| {worst} > {D2NT_CPU_BOUND}")
    check(lsb <= 1, f"VKITTI normal PNGs, cuda vs the cpu's normals: {lsb} LSB")
    depth = image_io.read_image(os.path.join(depth_dir, "depth_00000.png"))
    compute = {dev: sync_ms(lambda: d2n.depth_to_normal(depth, *args, device=dev), 10 if dev == "cuda" else 2)
               for dev in ("cuda", "cpu")}
    print(f"[data] cli.gen_vkitti_normals {VKITTI_FRAMES} frames {KITTI_RAW_HW[0]}x{KITTI_RAW_HW[1]}: {cli_ms:.1f} ms "
          f"a frame on cuda (depth PNG read, D2NT v3, 16-bit PNG write); depth_to_normal alone (host uint16 in, "
          f"float32 on the device out) {compute['cuda']:.2f} ms on cuda, {compute['cpu']:.2f} on cpu; cuda vs cpu "
          f"float64 max|d| {worst:.3e} (bound {D2NT_CPU_BOUND}), MRF choice equal on every pixel ({firsts} took the "
          f"first candidate), PNGs within {lsb} LSB", flush=True)
    return root


@contextlib.contextmanager
def recorded_launches():
    """(kernel name, shape of the tensor it was launched on) of every launch
    made inside the block, in order (each kernel of a call that launches
    several)."""
    from diffusion_e2e_ft_tpu_torch.kernels import _build

    seen, launch = [], _build.launch

    def record(counts, name, t, *args, **kw):
        launch(counts, name, t, *args, **kw)
        seen.extend((n, tuple(t.shape)) for n in ((name,) if isinstance(name, str) else name))

    _build.launch = record
    try:
        yield seen
    finally:
        _build.launch = launch


@contextlib.contextmanager
def instrumented_training(steps: list, reads: dict, waits: list):
    """Inside the block, every `E2ETrainer.train_step` appends {"hw", "ms",
    "loss", "launches", "shapes"} to `steps` (host clock, synchronised), each
    reader's `__getitem__` its host ms to `reads[reader]`, and each batch the
    step loop takes from `Prefetcher` the host ms it waited to `waits`."""
    from diffusion_e2e_ft_tpu_torch.data import mixer, train_datasets
    from diffusion_e2e_ft_tpu_torch.training.trainer import E2ETrainer

    saved = [(E2ETrainer, "train_step"), (mixer.Prefetcher, "__iter__"), (train_datasets.Hypersim, "__getitem__"),
             (train_datasets.VirtualKITTI2, "__getitem__")]
    originals = [getattr(owner, name) for owner, name in saved]
    train_step, prefetch, hypersim_getitem, vkitti_getitem = originals
    seen: list = []

    def timed_step(self, state, batch, generator=None):
        first = len(seen)
        before = read_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(self, state, batch, generator)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        after = read_launches()
        steps.append({"hw": tuple(batch["rgb"].shape[1:3]), "ms": ms, "loss": loss,
                      "launches": {k: after[k] - before[k] for k in after}, "shapes": set(seen[first:])})
        return state, metrics

    def timed_iter(self):
        it = prefetch(self)
        while True:
            t0 = time.perf_counter()
            item = next(it, None)
            if item is None:
                return
            waits.append((time.perf_counter() - t0) * 1e3)
            yield item

    def timed(original, label):
        def getitem(self, idx):
            t0 = time.perf_counter()
            sample = original(self, idx)
            reads.setdefault(label, []).append((time.perf_counter() - t0) * 1e3)
            return sample
        return getitem

    E2ETrainer.train_step, mixer.Prefetcher.__iter__ = timed_step, timed_iter
    train_datasets.Hypersim.__getitem__ = timed(hypersim_getitem, "Hypersim")
    train_datasets.VirtualKITTI2.__getitem__ = timed(vkitti_getitem, "VirtualKITTI2")
    try:
        with recorded_launches() as recorded:
            seen = recorded
            yield
    finally:
        for (owner, name), original in zip(saved, originals):
            setattr(owner, name, original)


def held_shapes() -> dict:
    """{kernel: the shapes phases 3, 3c, 4, 4b and 4c hold it at against its
    plain version}: attention (B, L, N, D); the GroupNorm kernels and GN ->
    conv (B, C, H, W)."""
    gn, route = {case[:4] for case in GN_CASES}, route_shapes()
    bwd = set(BWD_CASES)
    return {"flash_attention_fwd": set(ATTN_CASES) | set(eval_attention_cases()) | set(slice_c_attention_cases()),
            "flash_attention_fwd_lse": bwd, "flash_attention_bwd_dq": bwd, "flash_attention_bwd_dkv": bwd,
            "gn_channel_stats": gn | route, "gn_apply": route, "gn_group": route, "gn_silu_conv3x3": gn,
            "gn_silu_conv3x3_v2": gn}


def phase_train_from_trees(ckpt: str, hypersim: str, vkitti: str) -> dict:
    """Phase 17d: the real `cli.train` on the trees 17b and 17c wrote, bf16,
    UNet checkpointing, bs 2, two 9:1 epochs (E2_STEPS steps, two of them
    VKITTI2 batches at 352x1216), for normals and for depth, on phase 6's HF
    directory. Returns every kernel's launches of the two runs."""
    from diffusion_e2e_ft_tpu_torch.cli import train as train_cli
    from diffusion_e2e_ft_tpu_torch.pipelines import MarigoldPipeline

    held = held_shapes()
    total: dict = {}
    with tempfile.TemporaryDirectory() as work:
        for modality in ("normals", "depth"):
            out = os.path.join(work, modality)
            steps, reads, waits = [], {}, []
            torch.cuda.reset_peak_memory_stats()
            reset_launches()  # the path's run starts here
            t0 = time.perf_counter()
            with instrumented_training(steps, reads, waits):
                train_cli.main([
                    "--pretrained_model_name_or_path", ckpt, "--modality", modality, "--output_dir", out,
                    "--hypersim_root", hypersim, "--vkitti_root", vkitti, "--train_batch_size", "2",
                    "--gradient_accumulation_steps", "1", "--max_train_steps", str(E2_STEPS),
                    "--checkpointing_steps", str(10 * E2_STEPS), "--gradient_checkpointing", "--half_precision",
                    "--seed", "0", "--device", "cuda"])
            seconds = time.perf_counter() - t0
            launches = read_launches()  # ... and ends here
            peak = torch.cuda.max_memory_allocated() / 2**30
            for name, n in launches.items():
                total[name] = total.get(name, 0) + n
            by_hw: dict = {}
            for s in steps:
                by_hw.setdefault(s["hw"], []).append(s)
            check(len(steps) == E2_STEPS and set(by_hw) == {NYU_HW, VKITTI_HW},
                  f"{modality}: steps at {[s['hw'] for s in steps]}")
            for s in steps:
                check(bool(np.isfinite(s["loss"])), f"{modality} step at {s['hw']}: loss {s['loss']}")
                check(s["launches"] == step_launches(UNET_SITES_480x640, hw=s["hw"]),
                      f"{modality} step at {s['hw']}: launches {s['launches']}, expected step_launches(15)")
                for name, shape in s["shapes"]:
                    check(shape[:4] in held[name], f"{modality} step at {s['hw']}: {name} at {shape}, a shape "
                          "no phase holds against the plain version")
            rows = []
            for hw, group in sorted(by_hw.items()):
                kinds = sorted({(n.replace("flash_attention_", "").replace("gn_", ""), sh)
                                for s in group for n, sh in s["shapes"]})
                rows.append(f"{hw[0]}x{hw[1]}: {len(group)} steps, ms {[round(s['ms'], 1) for s in group]}, losses "
                            f"{[round(s['loss'], 5) for s in group]}, kernel shapes {kinds}")
            read_ms = {k: f"median {statistics.median(v):.1f}, max {max(v):.1f} over {len(v)}" for k, v in reads.items()}
            print(f"[train-e2] cli.train {modality}, bf16, bs 2, {E2_STEPS} steps in {seconds:.1f} s with the "
                  f"checkpoint's load and the export; launches a step step_launches(15) at both shapes; "
                  + "; ".join(rows) + f"; peak device memory {peak:.3f} GiB; reader host ms a sample {read_ms}; "
                  f"the step loop waited on Prefetcher {[round(x, 1) for x in waits]} ms (sum {sum(waits):.1f})",
                  flush=True)
            pipe = MarigoldPipeline.from_hf_dir(os.path.join(out, "export"), device="cuda", dtype=torch.bfloat16)
            check(pipe.unet.config.in_channels == 8, f"{modality} export: conv_in {pipe.unet.config.in_channels}")
            del pipe
            gc.collect()
            torch.cuda.empty_cache()
        print("[train-e2] both exports load with MarigoldPipeline.from_hf_dir", flush=True)
    return total


def phase_data_path(ckpt: str) -> dict:
    """Phase 17 (a-d), slice E2's main path. Returns every kernel's launches of 17d."""
    rng = np.random.default_rng(17)
    with_h5py = phase_data_host()
    with tempfile.TemporaryDirectory() as work:
        hypersim = phase_hypersim(work, rng, with_h5py)
        vkitti = phase_vkitti(work, rng)
        return phase_train_from_trees(ckpt, hypersim, vkitti)


# Slice F + D3 (phase 18). (a) Data parallelism on the one card: NCCL refuses two ranks on one GPU, so
# the two ranks of a 480x640 global batch of 2 meet over gloo (which all-reduces CUDA tensors through the
# host); a 1-rank NCCL group runs the NCCL init and all-reduce on the card. 2 ranks vs 1 process, fp32,
# TF32 off, one step, relative: the loss, the grad norm (phase 7's bound: cuDNN picks its conv algorithms
# by batch size, and the SSI solve of random-weight predictions amplifies their rounding) and every
# parameter after the step against the largest update. Adam's first step is lr g / (|g| + eps): with the
# random weights' gradients of ~1e-6 and eps 1e-6 it is smooth in g (no sign flips from float noise) and
# ~lr, far above the parameters' fp32 rounding (at lr 3e-5, eps 1e-3 it was 3e-7, at their rounding)
DP_WORLD = 2
DP_BOUNDS = {"loss": 1e-5, "grad_norm": TRAIN_PARITY_BOUNDS["grad_norm"], "update": 1e-2}
DP_PARITY = dict(gradient_checkpointing=True, gradient_accumulation_steps=1, lr_warmup_steps=0,
                 noise_type="pyramid", learning_rate=1e-3, adam_epsilon=1e-6, seed=18)
DP_STEPS = 3  # bf16 steps of each data-parallel run (the first is the warm-up)
# (b) with_mesh's ensembles: one member a call, no mesh, against two a call on [cuda:0, cuda:0] (one on
# a replica of its own): every kernel-1 shape is an eval frame's (phase 3c)
MESH_HW, MESH_MEMBERS, MESH_STEPS = (480, 640), 10, 4
D3_OPTIONS = [  # (c) the SD2 step's options at 480x640 bs 2, bf16, the default (save nothing) first and last
    ("save nothing", {}), ("remat_policy=dots", dict(remat_policy="dots")),
    ("remat_policy=dots_all", dict(remat_policy="dots_all")), ("vae_decode_checkpoint", dict(vae_decode_checkpoint=True)),
    ("adam_mu_dtype=bfloat16", dict(adam_mu_dtype="bfloat16")), ("save nothing, again", {}),
]
D3_STEPS = 4  # steps of each option (the first is the warm-up)
D3_LOSS_BOUND = 1e-2  # second-step loss vs the default's, relative: a bf16 first moment moves the first update
SUBPIXEL_HW = (768, 768)
SUBPIXEL_BOUND = 1e-5  # fp32 decode, sub-pixel vs resize, max|d| / max|resize|: the same sums in another order


def dp_batch() -> dict:
    """The global batch of phase 18a: two 480x640 rows whose valid counts
    differ (rank 0's row loses a block, rank 1's keeps one), so that a mean
    of the ranks' means would not be the global mean."""
    rng = np.random.default_rng(18)
    batch = synthetic_batch(rng, 2, 480, 640, "depth", invalid=0.0)
    batch["val_mask"][0, 64:192, 96:288] = False
    batch["val_mask"][1] = False
    batch["val_mask"][1, 120:360, 160:480] = True
    return batch


def dp_sd2_trainer(weights: dict, compute_dtype=None, **config):
    """An E2ETrainer on cuda:0 over phase 8's saved SD2 weights."""
    from diffusion_e2e_ft_tpu_torch.models import AutoencoderKL, UNet2DCondition
    from diffusion_e2e_ft_tpu_torch.training import E2ETrainer, TrainConfig

    with torch.device("meta"):
        unet, vae = UNet2DCondition(weights["unet_config"]), AutoencoderKL(weights["vae_config"])
    unet.load_state_dict(weights["unet"], assign=True)
    vae.load_state_dict(weights["vae"], assign=True)
    return E2ETrainer(TrainConfig(**config), unet.cuda(), vae, weights["empty"], compute_dtype=compute_dtype)


def dp_geo_trainer(weights: dict):
    """A bf16 GeoWizardTrainer (the default TrainConfig) on cuda:0 over phase 13's saved weights."""
    from diffusion_e2e_ft_tpu_torch.models import AutoencoderKL, UNet2DCondition
    from diffusion_e2e_ft_tpu_torch.models import clip
    from diffusion_e2e_ft_tpu_torch.training import GeoWizardTrainer, TrainConfig

    with torch.device("meta"):
        modules = (UNet2DCondition(weights["unet_config"]), AutoencoderKL(weights["vae_config"]),
                   clip.CLIPVisionModelWithProjection(weights["encoder_config"]))
    for module, key in zip(modules, ("unet", "vae", "encoder")):
        module.load_state_dict({k: v.float() for k, v in weights[key].items()}, assign=True)
    unet, vae, encoder = modules
    config = TrainConfig(gradient_checkpointing=True, gradient_accumulation_steps=1, lr_warmup_steps=0)
    return GeoWizardTrainer(config, unet.cuda(), vae, encoder, compute_dtype=torch.bfloat16)


def dp_bf16_steps(trainer, batches: list, dp, label: str) -> dict:
    """DP_STEPS bf16 steps on this rank's rows of `batches` (the group `dp`,
    None for no group), from reset launch counts: ms a step (host clock),
    peak memory, losses, launches and the kernel shapes of each step."""
    from diffusion_e2e_ft_tpu_torch.parallel import shard_train_batch

    rank, world = (0, 1) if dp is None else (dp.rank, dp.world)
    reduce_ms: list = []
    if dp is not None:
        trainer.place_frozen(dp)
        all_reduce = dp.all_reduce_

        def timed_reduce(tensors):  # the gradient all-reduce's share of the step, host clock
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            all_reduce(tensors)
            torch.cuda.synchronize()
            reduce_ms.append((time.perf_counter() - t0) * 1e3)

        dp.all_reduce_ = timed_reduce
    generator = torch.Generator(device="cuda").manual_seed(DP_PARITY["seed"])
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # the path's run starts here
    try:
        with recorded_launches() as seen:
            state, ms, per_step, losses = timed_steps(
                trainer, trainer.init_state(), [shard_train_batch(b, rank, world) for b in batches], generator)
    finally:
        if dp is not None:
            dp.all_reduce_ = all_reduce
    launches = read_launches()  # ... and ends here
    shapes = sorted({(name, shape[:4]) for name, shape in seen})
    out = {"ms": ms, "median_ms": statistics.median(ms[1:]), "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "losses": losses, "per_step": per_step, "launches": launches, "shapes": [list(x) for x in shapes],
           "reduce_ms": statistics.median(reduce_ms[1:]) if reduce_ms else 0.0}
    print(f"[dp] {label} rank {rank} of {world}: {len(ms)} steps of {len(batches[0]['rgb']) // world} rows, ms/step "
          f"{[round(x, 1) for x in ms]} (median after the first {out['median_ms']:.1f}, of it the gradient "
          f"all-reduce {out['reduce_ms']:.1f}), peak {out['peak_gib']:.3f} GiB, losses {[round(x, 6) for x in losses]}, "
          f"launches a step {per_step[-1]}", flush=True)
    return out


def dp_parity_step(trainer, dp) -> tuple:
    """One fp32 step on the global batch (dp None) or this rank's rows of
    it: (the state after it, its loss and grad norm)."""
    from diffusion_e2e_ft_tpu_torch.parallel import shard_train_batch

    batch = dp_batch()
    if dp is not None:
        trainer.place_frozen(dp)
        batch = shard_train_batch(batch, dp.rank, dp.world)
    generator = torch.Generator(device="cuda").manual_seed(DP_PARITY["seed"])
    state, metrics = trainer.train_step(trainer.init_state(), batch, generator)
    return state, {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"])}


def dp_setup() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def dp_reference(_: int, work: str) -> None:
    """Phase 18a's first process: the fp32 step on the whole global batch in
    one process (its parameters written for the ranks to compare), then a
    1-rank NCCL group's bf16 steps on the card."""
    from diffusion_e2e_ft_tpu_torch.parallel import init_data_parallel

    dp_setup()
    weights = torch.load(os.path.join(work, "sd2.pt"), weights_only=False, mmap=True)
    trainer = dp_sd2_trainer(weights, **DP_PARITY)
    state, out = dp_parity_step(trainer, None)
    torch.save({n: p.detach().cpu() for n, p in state.params.items()}, os.path.join(work, "reference.pt"))
    del state, trainer
    gc.collect()
    torch.cuda.empty_cache()
    dp = init_data_parallel(0, 1, "cuda:0", init_file=os.path.join(work, "nccl-rendezvous"))
    try:
        check(dp.backend == "nccl", f"a CUDA rank took {dp.backend}")
        rng = np.random.default_rng(19)
        batches = [synthetic_batch(rng, 2, 480, 640, "depth", invalid=0.0) for _ in range(DP_STEPS)]
        out["nccl"] = dp_bf16_steps(dp_sd2_trainer(weights, torch.bfloat16, **dict(DP_PARITY, noise_type="zeros")),
                                    batches, dp, "SD2 bf16 NCCL")
    finally:
        dp.close()
    with open(os.path.join(work, "reference.json"), "w") as f:
        json.dump(out, f)


def dp_rank(rank: int, work: str) -> None:
    """Phase 18a's ranks on cuda:0 over gloo: the fp32 step on the rank's row
    against the reference's parameters, then the bf16 SD2 and GeoWizard
    steps on the rank's rows of global batches of 2."""
    from diffusion_e2e_ft_tpu_torch.parallel import init_data_parallel

    dp_setup()
    dp = init_data_parallel(rank, DP_WORLD, "cuda:0", init_file=os.path.join(work, "gloo-rendezvous"), backend="gloo")
    try:
        weights = torch.load(os.path.join(work, "sd2.pt"), weights_only=False, mmap=True)
        trainer = dp_sd2_trainer(weights, **DP_PARITY)
        state, out = dp_parity_step(trainer, dp)
        reference = torch.load(os.path.join(work, "reference.pt"), mmap=True)
        errs = {n: float((p.detach() - reference[n].to(p.device)).abs().max()) for n, p in state.params.items()}
        update = max(float((reference[n] - weights["unet"][n]).abs().max()) for n in errs)  # the reference's step
        out["update_err"], out["worst_param"] = max(errs.values()) / update, max(errs, key=errs.get)
        out["params"], out["largest_update"] = len(errs), update
        del state, trainer, reference
        gc.collect()
        torch.cuda.empty_cache()
        rng = np.random.default_rng(19)  # the NCCL run's batches
        batches = [synthetic_batch(rng, 2, 480, 640, "depth", invalid=0.0) for _ in range(DP_STEPS)]
        out["sd2"] = dp_bf16_steps(dp_sd2_trainer(weights, torch.bfloat16, **dict(DP_PARITY, noise_type="zeros")),
                                   batches, dp, "SD2 bf16 gloo")
        del weights
        gc.collect()
        torch.cuda.empty_cache()
        rng = np.random.default_rng(20)
        geo_batches = [joint_batch(rng, 2, 480, 640) for _ in range(DP_STEPS)]
        geo = torch.load(os.path.join(work, "geowizard.pt"), weights_only=False, mmap=True)
        out["geowizard"] = dp_bf16_steps(dp_geo_trainer(geo), geo_batches, dp, "GeoWizard joint bf16 gloo")
    finally:
        dp.close()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def phase_data_parallel(work: str) -> dict:
    """Phase 18a, slice F's main path, on the weights phases 8 and 13 left in
    `work`: the reference process, then the two gloo ranks, each spawned
    after the last has ended (this process holds no model by then). Returns
    the kernel launches of the ranks' bf16 runs (both ranks, SD2 and
    GeoWizard) and of the NCCL run."""
    t0 = time.perf_counter()
    torch.multiprocessing.spawn(dp_reference, args=(work,), nprocs=1)
    t1 = time.perf_counter()
    torch.multiprocessing.spawn(dp_rank, args=(work,), nprocs=DP_WORLD)
    t2 = time.perf_counter()
    ref = json.load(open(os.path.join(work, "reference.json")))
    ranks = [json.load(open(os.path.join(work, f"rank{r}.json"))) for r in range(DP_WORLD)]
    counts = [int(m.sum()) for m in dp_batch()["val_mask"]]
    for r, got in enumerate(ranks):
        rel = {k: abs(got[k] - ref[k]) / abs(ref[k]) for k in ("loss", "grad_norm")}
        print(f"[dp] fp32 480x640, valid pixels {counts} a row, pyramid noise: rank {r} of 2 (gloo) loss "
              f"{got['loss']:.8f} vs one process {ref['loss']:.8f} (rel {rel['loss']:.2e}, bound {DP_BOUNDS['loss']}), "
              f"grad norm {got['grad_norm']:.6e} vs {ref['grad_norm']:.6e} (rel {rel['grad_norm']:.2e}, bound "
              f"{DP_BOUNDS['grad_norm']}), every one of {got['params']} parameters after the step max|d| / the "
              f"largest update ({got['largest_update']:.3e}) {got['update_err']:.2e} ({got['worst_param']}; bound "
              f"{DP_BOUNDS['update']})", flush=True)
        for k in ("loss", "grad_norm"):
            check(rel[k] <= DP_BOUNDS[k], f"rank {r}: {k} {got[k]} vs one process {ref[k]}")
        check(got["update_err"] <= DP_BOUNDS["update"], f"rank {r}: parameter {got['worst_param']} off by "
              f"{got['update_err']} of the largest update")
    check(ranks[0]["loss"] == ranks[1]["loss"] and ranks[0]["grad_norm"] == ranks[1]["grad_norm"],
          "the ranks' global loss or grad norm differ")
    held = held_shapes()
    total: dict = {}
    runs = [(f"rank {r} {model}", ranks[r][model]) for model in ("sd2", "geowizard") for r in range(DP_WORLD)]
    for label, run in [*runs, ("nccl", ref["nccl"])]:
        check(np.isfinite(run["losses"]).all(), f"{label}: losses {run['losses']}")
        check(all(s == step_launches(UNET_SITES_480x640) for s in run["per_step"]),
              f"{label}: launches a step {run['per_step']}, expected step_launches(15)")
        for name, shape in run["shapes"]:
            check(tuple(shape) in held[name], f"{label}: {name} at {shape}, a shape no phase holds against the "
                  "plain version")
        for name, n in run["launches"].items():
            total[name] = total.get(name, 0) + n
    for model in ("sd2", "geowizard"):
        check(ranks[0][model]["losses"] == ranks[1][model]["losses"], f"{model}: the ranks' global losses differ")
        print(f"[dp] bf16 {model} 2 ranks x 1 row (gloo on one card): median ms/step "
              f"{[round(r[model]['median_ms'], 1) for r in ranks]} (the all-reduce "
              f"{[round(r[model]['reduce_ms'], 1) for r in ranks]}), peak GiB a rank "
              f"{[round(r[model]['peak_gib'], 3) for r in ranks]}, launches a rank a step "
              f"{ranks[0][model]['per_step'][-1]}", flush=True)
    print(f"[dp] bf16 sd2 1 rank x 2 rows (NCCL): median ms/step {ref['nccl']['median_ms']:.1f} (the all-reduce "
          f"{ref['nccl']['reduce_ms']:.1f}), peak "
          f"{ref['nccl']['peak_gib']:.3f} GiB; the processes took {t1 - t0:.1f} s (reference + NCCL) and "
          f"{t2 - t1:.1f} s (the gloo ranks)", flush=True)
    return total


def phase_mesh_marigold(ckpt: str) -> int:
    """Phase 18b (Marigold): a seeded pyramid ensemble at 480x640 in bf16, no
    mesh against the mesh [cuda:0, cuda:0]. Returns kernel 1's launches of both."""
    from diffusion_e2e_ft_tpu_torch.pipelines import MarigoldPipeline

    pipe = MarigoldPipeline.from_hf_dir(ckpt, device="cuda", dtype=torch.bfloat16)
    launches = mesh_ensembles(pipe, "Marigold", ("depth_np", "uncertainty"))
    del pipe
    return launches


def mesh_ensembles(pipe, label: str, fields: tuple) -> int:
    """The mesh check of phase 18b on `pipe`: one member a call without the
    mesh, two a call with it. The mesh shares the pipeline for a repeated
    device; its second position is given a replica of its own
    (`_replica_on`, what a second card gets), so the replica's build and the
    gather run on the card. The members of each run are
    recorded: equal to the bit, the outputs must be too; else (a card that
    is not deterministic) within the BFGS drift (`ENSEMBLE_DRIFT`)."""
    from diffusion_e2e_ft_tpu_torch import parallel
    from diffusion_e2e_ft_tpu_torch.kernels import flash_attention as fa
    from diffusion_e2e_ft_tpu_torch.ops import ensemble as ens

    image = np.random.default_rng(21).integers(0, 256, (*MESH_HW, 3), dtype=np.uint8)
    kw = dict(denoising_steps=MESH_STEPS, ensemble_size=MESH_MEMBERS, noise="pyramid", processing_res=0, seed=5,
              color_map=None)
    members, combine = [], ens.ensemble_depths

    def recorded(preds, *args, **kwargs):
        members.append(preds.float().cpu())
        return combine(preds, *args, **kwargs)

    ens.ensemble_depths = recorded
    reset_launches()
    try:
        with recorded_shapes(fa) as shapes:
            t0 = time.perf_counter()
            want = pipe(image, batch_size=1, **kw)
            t1 = time.perf_counter()
            pipe.with_mesh(parallel.make_mesh(devices=["cuda:0", "cuda:0"]))
            pipe._replicas[1] = pipe._replica_on(torch.device("cuda:0"))
            check(pipe._replicas[1].unet is not pipe.unet, f"{label}: the mesh's second position holds no replica")
            got = pipe(image, batch_size=2, **kw)
            t2 = time.perf_counter()
    finally:
        ens.ensemble_depths = combine
        pipe.with_mesh(None)
    launches = read_launches()["flash_attention_fwd"]
    check(shapes <= held_shapes()["flash_attention_fwd"], f"{label}: kernel 1 at {sorted(shapes)}, not all held")
    member_diff = float((members[0] - members[1]).abs().max())
    diffs = {f: float(np.abs(getattr(got, f) - getattr(want, f)).max()) for f in fields}
    bound = 0.0 if member_diff == 0.0 else ENSEMBLE_DRIFT
    print(f"[mesh] {label} bf16 480x640, {MESH_STEPS} steps, ensemble {MESH_MEMBERS}, pyramid: mesh [cuda:0, cuda:0] "
          f"(2 members a call, 1 on a replica of its own) vs no mesh (1 a call): members max|d| {member_diff:.3e}, "
          "outputs max|d| "
          + ", ".join(f"{f} {d:.3e}" for f, d in diffs.items()) + f" (bound {bound}); {t1 - t0:.2f} s vs "
          f"{t2 - t1:.2f} s; kernel 1 launches {launches}", flush=True)
    check(all(d <= bound for d in diffs.values()), f"{label}: with_mesh changed the output: {diffs}")
    return launches


def phase_trainer_options(unet, vae, empty) -> None:
    """Phase 18c, slice D3 on the card: (1) the remat policies' gradients
    against the no-checkpoint ones (bf16, the same batch and weights); (2)
    one SD2 step a D3 option at 480x640 bs 2, bf16, each from the same
    weights (D3_STEPS steps; ms, peak, launches, losses against the
    default's); (3) the sub-pixel decoder against the resize one, fp32 at
    768x768, and the bf16 serving decode's ms and peak of each."""
    from diffusion_e2e_ft_tpu_torch.training import E2ETrainer, TrainConfig
    from diffusion_e2e_ft_tpu_torch.parallel import frozen_copy

    batch = synthetic_batch(np.random.default_rng(22), 2, 480, 640, "depth", invalid=0.1)
    base = TrainConfig(gradient_checkpointing=True, gradient_accumulation_steps=1, lr_warmup_steps=0)
    start = {n: p.detach().cpu() for n, p in unet.named_parameters()}  # on the host: no share of the peak

    def restore():
        with torch.no_grad():
            for n, p in unet.named_parameters():
                p.copy_(start[n])

    def grads(**override):
        trainer = E2ETrainer(base.replace(**override), unet, vae, empty, compute_dtype=torch.bfloat16)
        reset_launches()
        loss, _, g = trainer.value_and_grad(batch)
        return float(loss), g, read_launches()

    loss0, plain, _ = grads(gradient_checkpointing=False)
    for policy in ("dots", "dots_all"):
        loss, g, launches = grads(remat_policy=policy)
        rel = max(float((g[n] - plain[n]).abs().max()) / max(float(plain[n].abs().max()), 1e-30) for n in plain)
        print(f"[d3] remat_policy={policy}: loss {loss:.6f} vs no checkpoint {loss0:.6f}; gradients max|d|/max|g| "
              f"{rel:.2e} over {len(plain)} leaves (bound {BF16_BOUND}); launches {launches}", flush=True)
        check(rel <= BF16_BOUND and launches == step_launches(UNET_SITES_480x640),
              f"remat_policy={policy}: gradients off by {rel}, launches {launches}")
        del g
    del plain
    torch.cuda.empty_cache()

    results = {}
    for name, override in D3_OPTIONS:
        restore()
        trainer = E2ETrainer(base.replace(**override), unet, vae, empty, compute_dtype=torch.bfloat16)
        torch.cuda.reset_peak_memory_stats()
        state, ms, per_step, losses = timed_steps(trainer, trainer.init_state(), [batch] * D3_STEPS)
        results[name] = {"ms": statistics.median(ms[1:]), "peak": torch.cuda.max_memory_allocated() / 2**30,
                         "losses": losses, "launches": per_step[-1]}
        del state, trainer
        gc.collect()
        torch.cuda.empty_cache()
    restore()
    del start
    default = results["save nothing"]
    for name, r in results.items():
        rel = abs(r["losses"][1] - default["losses"][1]) / abs(default["losses"][1])
        print(f"[d3] {name}: bf16 480x640 bs 2, median ms/step after the first {r['ms']:.1f}, peak {r['peak']:.3f} "
              f"GiB, losses {[round(x, 6) for x in r['losses']]} (second vs the default's rel {rel:.2e}, bound "
              f"{D3_LOSS_BOUND}); launches a step {r['launches']}", flush=True)
        first = abs(r["losses"][0] - default["losses"][0]) / abs(default["losses"][0])  # the same forward
        check(first <= 1e-6 and rel <= D3_LOSS_BOUND, f"{name}: losses {r['losses']}")
        # vae_decode_checkpoint: the backward runs the decode again (its mid attention, pairs and GroupNorms)
        want = step_launches(UNET_SITES_480x640, decode_checkpoint=name == "vae_decode_checkpoint")
        check(r["launches"] == want, f"{name}: launches {r['launches']}, expected {want}")

    cfg = dataclasses.replace(vae.config, fused_gn_conv=False)
    resize, sub = frozen_copy(vae, "cuda", cfg), frozen_copy(vae, "cuda", dataclasses.replace(cfg, subpixel_upsample=True))
    z = torch.randn(1, 4, SUBPIXEL_HW[0] // 8, SUBPIXEL_HW[1] // 8, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(23))
    with torch.no_grad():
        want, got = resize.decode(z), sub.decode(z)
        rel = float((got - want).abs().max()) / float(want.abs().max())
        del want, got
        rows = []
        for label, module in (("resize", resize), ("sub-pixel", sub)):
            module.to(torch.bfloat16)
            zb = z.to(torch.bfloat16)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ms = time_ms(lambda: module.decode(zb))
            rows.append(f"{label} {ms:.3f} ms, peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    print(f"[d3] subpixel_upsample: fp32 decode at {SUBPIXEL_HW[0]}x{SUBPIXEL_HW[1]}, sub-pixel vs resize max|d|/max|d| "
          f"{rel:.2e} (bound {SUBPIXEL_BOUND}); bf16 serving decode (CUDA events, median of 10): " + "; ".join(rows),
          flush=True)
    check(rel <= SUBPIXEL_BOUND, f"sub-pixel decode off by {rel}")
    del resize, sub
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 19: slices F2 and G, FSDP ranks and the export round trip
# ---------------------------------------------------------------------------

# (a)-(c) two gloo ranks on cuda:0 as mesh (data 1, fsdp 2): both hold the global batch's two rows, each
# half of every leaf of at least 2^18 elements (the parameters and Adam's moments)
FSDP_SIZE = 2
# (d) the export round trip's probe: the UNet's and the VAE's attention at the NYU frames' shapes (phase 3c)
EXPORT_HW = (480, 640)


def fsdp_rule_bytes(shapes: dict, trainer) -> int:
    """The bytes a rank's state holds by the rule: each parameter's elements
    a rank (half of a sharded one) times the bytes of its master, Adam's two
    moments, and the accumulator and the EMA where the config keeps them."""
    from diffusion_e2e_ft_tpu_torch.parallel import param_spec

    c = trainer.config
    mu = 2 if c.adam_mu_dtype in ("bfloat16", "float16") else 4
    per_element = 4 + mu + 4 + 4 * (c.gradient_accumulation_steps > 1) + 4 * c.use_ema
    elements = sum(math.prod(s) // (FSDP_SIZE if param_spec(tuple(s), FSDP_SIZE) is not None else 1)
                   for s in shapes.values())
    return elements * per_element


def fsdp_bf16_steps(trainer, batches: list, dp, label: str, shapes: dict) -> dict:
    """DP_STEPS bf16 steps of this fsdp rank on its rows of `batches`, from a
    `shard_state` of the trainer's state and reset launch counts: ms a step
    and the gather's ms of it (host clock, synchronised), peak memory, the
    state's bytes against the rule's, what the UNet holds between steps,
    losses, launches and the kernel shapes."""
    from diffusion_e2e_ft_tpu_torch.parallel import shard_state
    from diffusion_e2e_ft_tpu_torch.training.trainer import state_tensors

    trainer.place_frozen(dp)
    state = shard_state(trainer.init_state(), dp)
    gather, gather_ms = dp.gather_shards, []

    def timed_gather(shards, axes, *args):  # the parameters' all-gather share of the step, host clock
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gather(shards, axes, *args)
        torch.cuda.synchronize()
        gather_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    dp.gather_shards = timed_gather
    generator = torch.Generator(device="cuda").manual_seed(DP_PARITY["seed"])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # the path's run starts here
    try:
        with recorded_launches() as seen:
            state, ms, per_step, losses = timed_steps(trainer, state, [dp.shard_batch(b) for b in batches], generator)
    finally:
        dp.gather_shards = gather
    launches = read_launches()  # ... and ends here
    stored = sum(t.numel() * t.element_size() for _, t in state_tensors(state))
    held = sum(p.numel() for n, p in trainer.unet.named_parameters() if n in state.sharding.axes)
    out = {"ms": ms, "median_ms": statistics.median(ms[1:]), "gather_ms": statistics.median(gather_ms[1:]),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "losses": losses, "per_step": per_step,
           "launches": launches, "shapes": [list(x) for x in sorted({(name, shape[:4]) for name, shape in seen})],
           "state_bytes": stored, "rule_bytes": fsdp_rule_bytes(shapes, trainer), "held_between_steps": held,
           "sharded": len(state.sharding.axes), "leaves": len(state.params)}
    print(f"[fsdp] {label} rank {dp.rank} (data {dp.data_index} of {dp.data_size}, fsdp {dp.fsdp_index} of "
          f"{dp.fsdp_size}): {len(ms)} steps of {len(batches[0]['rgb'])} rows, ms/step {[round(x, 1) for x in ms]} "
          f"(median after the first {out['median_ms']:.1f}, of it the all-gather {out['gather_ms']:.1f}), peak "
          f"{out['peak_gib']:.3f} GiB, state {stored / 1e9:.4f} GB (the rule's {out['rule_bytes'] / 1e9:.4f}; "
          f"{out['sharded']} of {out['leaves']} leaves sharded), losses {[round(x, 6) for x in losses]}, "
          f"launches a step {per_step[-1]}", flush=True)
    return out


def fsdp_checkpoint(trainer, state, batch: dict, dp, work: str) -> dict:
    """Phase 19c on a rank: the group saves the sharded state (every rank
    gathers, rank 0 takes each bucket to the host and writes the one-process
    file), the state's tensors are zeroed and restored from the file, must
    equal a host copy of them to the bit, and take one more step. The peak
    of the save and restore is read on its own."""
    from diffusion_e2e_ft_tpu_torch.training import checkpoints as ckpt
    from diffusion_e2e_ft_tpu_torch.training.trainer import state_tensors

    before = [t.detach().cpu() for _, t in state_tensors(state)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = ckpt.save_checkpoint(os.path.join(work, "fsdp-checkpoints"), state.step, state)
    dp.barrier()
    t1 = time.perf_counter()
    with torch.no_grad():
        for _, t in state_tensors(state):
            t.zero_()
    state = ckpt.restore_checkpoint(path, state)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() / 2**30
    equal = all(torch.equal(t.detach().cpu(), b) for (_, t), b in zip(state_tensors(state), before))
    del before
    state, metrics = trainer.train_step(state, batch, torch.Generator(device="cuda").manual_seed(DP_PARITY["seed"] + 1))
    return {"equal": equal, "save_s": t1 - t0, "restore_s": t2 - t1, "step": state.step, "loss": float(metrics["loss"]),
            "file_gb": os.path.getsize(os.path.join(path, ckpt.STATE_FILE)) / 1e9, "peak_gib": peak}


def fsdp_rank(rank: int, work: str) -> None:
    """Phase 19's ranks on cuda:0 over gloo, mesh (data 1, fsdp 2): (b) the
    fp32 step on the global batch of phase 18a from sharded state, against
    the reference process's parameters; (c) its checkpoint; (a) the bf16 SD2
    and GeoWizard steps."""
    from diffusion_e2e_ft_tpu_torch.parallel import init_data_parallel, shard_state
    from diffusion_e2e_ft_tpu_torch.training.trainer import gather_tensors

    dp_setup()
    dp = init_data_parallel(rank, FSDP_SIZE, "cuda:0", init_file=os.path.join(work, "fsdp-rendezvous"),
                            backend="gloo", fsdp=FSDP_SIZE)
    out: dict = {}
    try:
        weights = torch.load(os.path.join(work, "sd2.pt"), weights_only=False, mmap=True)
        trainer = dp_sd2_trainer(weights, **DP_PARITY)
        trainer.place_frozen(dp)
        state = shard_state(trainer.init_state(), dp)
        batch = dp.shard_batch(dp_batch())
        torch.cuda.reset_peak_memory_stats()
        state, metrics = trainer.train_step(state, batch, torch.Generator(device="cuda").manual_seed(DP_PARITY["seed"]))
        out.update(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                   step_peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        reference = torch.load(os.path.join(work, "reference.pt"), mmap=True)
        full = gather_tensors(state.params, state.sharding)
        errs = {n: float((p.detach() - reference[n].to(p.device)).abs().max()) for n, p in full.items()}
        update = max(float((reference[n] - weights["unet"][n]).abs().max()) for n in errs)  # the reference's step
        out["update_err"], out["worst_param"] = max(errs.values()) / update, max(errs, key=errs.get)
        out["params"], out["largest_update"] = len(errs), update
        del full, reference
        out["checkpoint"] = fsdp_checkpoint(trainer, state, batch, dp, work)
        del state, trainer
        gc.collect()
        torch.cuda.empty_cache()
        rng = np.random.default_rng(19)  # phase 18a's batches
        batches = [synthetic_batch(rng, 2, 480, 640, "depth", invalid=0.0) for _ in range(DP_STEPS)]
        trainer = dp_sd2_trainer(weights, torch.bfloat16, **dict(DP_PARITY, noise_type="zeros"))
        out["sd2"] = fsdp_bf16_steps(trainer, batches, dp, "SD2 bf16", {n: t.shape for n, t in weights["unet"].items()})
        del weights, trainer
        gc.collect()
        torch.cuda.empty_cache()
        rng = np.random.default_rng(20)
        geo_batches = [joint_batch(rng, 2, 480, 640) for _ in range(DP_STEPS)]
        geo = torch.load(os.path.join(work, "geowizard.pt"), weights_only=False, mmap=True)
        out["geowizard"] = fsdp_bf16_steps(dp_geo_trainer(geo), geo_batches, dp, "GeoWizard joint bf16",
                                           {n: t.shape for n, t in geo["unet"].items()})
    finally:
        dp.close()
    with open(os.path.join(work, f"fsdp{rank}.json"), "w") as f:
        json.dump(out, f)


def phase_fsdp(work: str) -> dict:
    """Phase 19 (a)-(c), slice F2's main path, after phase 18a (its reference
    process's parameters and 1-process NCCL run are the one-process side):
    two FSDP ranks spawned on cuda:0. Returns the kernel launches of their
    bf16 runs (both ranks, SD2 and GeoWizard)."""
    t0 = time.perf_counter()
    torch.multiprocessing.spawn(fsdp_rank, args=(work,), nprocs=FSDP_SIZE)
    seconds = time.perf_counter() - t0
    ref = json.load(open(os.path.join(work, "reference.json")))
    ranks = [json.load(open(os.path.join(work, f"fsdp{r}.json"))) for r in range(FSDP_SIZE)]
    for r, got in enumerate(ranks):
        rel = {k: abs(got[k] - ref[k]) / abs(ref[k]) for k in ("loss", "grad_norm")}
        print(f"[fsdp] fp32 480x640, 2 rows, pyramid noise: rank {r} of (data 1, fsdp 2) loss {got['loss']:.8f} vs one "
              f"process {ref['loss']:.8f} (rel {rel['loss']:.2e}, bound {DP_BOUNDS['loss']}), grad norm "
              f"{got['grad_norm']:.6e} vs {ref['grad_norm']:.6e} (rel {rel['grad_norm']:.2e}, bound "
              f"{DP_BOUNDS['grad_norm']}), every one of {got['params']} gathered parameters after the step max|d| / the "
              f"largest update ({got['largest_update']:.3e}) {got['update_err']:.2e} ({got['worst_param']}; bound "
              f"{DP_BOUNDS['update']})", flush=True)
        for k in ("loss", "grad_norm"):
            check(rel[k] <= DP_BOUNDS[k], f"fsdp rank {r}: {k} {got[k]} vs one process {ref[k]}")
        check(got["update_err"] <= DP_BOUNDS["update"], f"fsdp rank {r}: parameter {got['worst_param']} off by "
              f"{got['update_err']} of the largest update")
        c = got["checkpoint"]
        print(f"[fsdp] checkpoint rank {r}: {c['file_gb']:.3f} GB written (gather + save {c['save_s']:.1f} s), "
              f"restored into zeroed shards in {c['restore_s']:.1f} s, equal to the bit: {c['equal']}; peak of the "
              f"save and restore {c['peak_gib']:.3f} GiB vs the fp32 step's {got['step_peak_gib']:.3f} GiB; one more "
              f"step: step {c['step']}, loss {c['loss']:.6f}", flush=True)
        check(c["equal"] and c["step"] == 2 and np.isfinite(c["loss"]), f"fsdp rank {r}: checkpoint round trip {c}")
        check(c["peak_gib"] < got["step_peak_gib"], f"fsdp rank {r}: the checkpoint's peak {c['peak_gib']} GiB is "
              f"not below the step's {got['step_peak_gib']} GiB")
    check(ranks[0]["loss"] == ranks[1]["loss"] and ranks[0]["grad_norm"] == ranks[1]["grad_norm"],
          "the fsdp ranks' loss or grad norm differ")
    held = held_shapes()
    total: dict = {}
    for model in ("sd2", "geowizard"):
        for r, got in enumerate(ranks):
            run = got[model]
            label = f"fsdp rank {r} {model}"
            check(np.isfinite(run["losses"]).all(), f"{label}: losses {run['losses']}")
            check(all(s == step_launches(UNET_SITES_480x640) for s in run["per_step"]),
                  f"{label}: launches a step {run['per_step']}, expected step_launches(15)")
            for name, shape in run["shapes"]:
                check(tuple(shape) in held[name], f"{label}: {name} at {shape}, a shape no phase holds against the "
                      "plain version")
            check(run["state_bytes"] == run["rule_bytes"], f"{label}: state {run['state_bytes']} bytes, the rule's "
                  f"{run['rule_bytes']}")
            check(run["held_between_steps"] == 0, f"{label}: the UNet holds {run['held_between_steps']} elements of "
                  "sharded parameters between steps")
            for name, n in run["launches"].items():
                total[name] = total.get(name, 0) + n
        check(ranks[0][model]["losses"] == ranks[1][model]["losses"], f"{model}: the fsdp ranks' losses differ")
        print(f"[fsdp] bf16 {model} (data 1, fsdp 2) x 2 rows (gloo on one card): median ms/step "
              f"{[round(r[model]['median_ms'], 1) for r in ranks]} (the all-gather "
              f"{[round(r[model]['gather_ms'], 1) for r in ranks]}), peak GiB a rank "
              f"{[round(r[model]['peak_gib'], 3) for r in ranks]}, state GB a rank "
              f"{[round(r[model]['state_bytes'] / 1e9, 4) for r in ranks]} (the rule's "
              f"{ranks[0][model]['rule_bytes'] / 1e9:.4f})", flush=True)
    peak = max(r["sd2"]["peak_gib"] for r in ranks)
    print(f"[fsdp] SD2 peak a rank {peak:.3f} GiB vs one process on the same 2 rows (phase 18a's 1-rank NCCL run) "
          f"{ref['nccl']['peak_gib']:.3f} GiB; the ranks took {seconds:.1f} s", flush=True)
    check(peak < ref["nccl"]["peak_gib"], f"an fsdp rank's peak {peak} GiB is not below one process's")
    return total


def phase_export_roundtrip(work: str) -> int:
    """Phase 19d, slice G: `tools/export_roundtrip` at full width on cuda:0,
    fp32 and bf16, at a 480x640 probe; every row must be 0. Returns kernel
    1's launches (the UNet, the decode and the single-step depth of both
    pipelines), at shapes phase 3c holds."""
    from diffusion_e2e_ft_tpu_torch.kernels import flash_attention as fa
    from diffusion_e2e_ft_tpu_torch.tools import export_roundtrip

    reset_launches()
    with recorded_shapes(fa) as shapes:
        ok, _, report = export_roundtrip.run(None, device="cuda", dtypes=("float32", "bfloat16"), image_hw=EXPORT_HW,
                                             workdir=work)
    launches = read_launches()["flash_attention_fwd"]
    for line in report.splitlines():
        if line:
            print(f"[export] {line}", flush=True)
    print(f"[export] kernel 1 launches {launches} at {sorted(shapes)}", flush=True)
    check(ok, "the export round trip is not zero-diff")
    check(shapes <= held_shapes()["flash_attention_fwd"], f"export round trip: kernel 1 at {sorted(shapes)}, not all held")
    return launches


# ---------------------------------------------------------------------------
# Phase 20: slice E3, the card against the JAX reference's golden outputs
# ---------------------------------------------------------------------------

# the card goldens' UNets (one block a level) at 256x256: kernel sites at levels 0 and 1 (1024 and 256 tokens;
# GeoWizard's joint 2048 and 512), one down and two up blocks each; a Marigold or GeoWizard run adds the VAE's two
GOLDEN_UNET_SITES = 6
GOLDEN_HP_SITES = 3  # ... GeoWizard's d=40 ones (level 0), under E2EFT_FA_HP=2


def load_test_module(name: str):
    """`tests/<name>.py` loaded by its path (the golden rule and the port's
    runners; they import no JAX)."""
    import importlib.util

    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, os.path.join(REPO_DIR, "tests", f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


def card_bounds(P, g) -> dict:
    """A golden's bounds on the card: the port's CPU-vs-JAX bound of each
    output (`P.BOUNDS`) plus the card-vs-CPU bound the earlier phases hold
    the same path to: `E2E_BOUNDS` for depth and normals, and
    `TRAIN_PARITY_BOUNDS` for the loss, the grad norm and, through Adam's
    first step, each updated parameter: |d p| <= lr |d u| with u = g / (|g|
    + eps), |d u| <= min(2, |d g| / eps), |d g| <= leaf bound * max |g|."""
    out = {}
    for key, (kind, bound) in P.BOUNDS[g.name].items():
        if kind == "abs":
            bound += E2E_BOUNDS["normals" if "normal" in key else "depth"]
        elif kind == "rel":
            bound += TRAIN_PARITY_BOUNDS["grad_norm" if key.endswith("grad_norm") else "loss"]
        elif kind == "sums":
            cfg = g.meta["train_config"]
            prefix = key[: -len("param_sums")]
            du = np.minimum(2.0, TRAIN_PARITY_BOUNDS["leaf"] * g[f"{prefix}grad_max"] / cfg["adam_epsilon"])
            bound = bound + cfg["learning_rate"] * du
        out[key] = (kind, bound)
    return out


def phase_goldens() -> dict:
    """Phase 20: the port on cuda:0, fp32 with the kernels on, held to the
    JAX package's committed goldens (tests/golden/*.npz) within the CPU-vs-JAX
    bound plus the card-vs-CPU bound of each path (`card_bounds`): the card
    set at published widths and 256x256 (Marigold depth and normals;
    GeoWizard, again under `E2EFT_FA_HP=2`; the SD2 depth train step with
    the fused VAE, again under `E2EFT_GNCONV_IMPL=v2`) and the tiny Tier-1
    goldens of the main path (Marigold single step, the SD2 train step).
    Every one of kernels 1-8, the GroupNorm apply and the one-launch GroupNorm must launch. Then the card set's serving
    goldens in bf16: max |d| against the fp32 goldens, printed (no bound).
    Returns the phase's launches."""
    R, P = load_test_module("_torch_golden"), load_test_module("_torch_golden_port")
    t_phase = time.perf_counter()
    launches = dict.fromkeys(read_launches(), 0)
    dev = "cuda"

    def tally(label: str, expect: dict) -> None:
        """Add the launches since the last tally; they must be `expect`'s (the rest 0)."""
        torch.cuda.synchronize()
        done = read_launches()
        reset_launches()
        for name, n in done.items():
            launches[name] += n
        check(done == {**dict.fromkeys(done, 0), **expect}, f"{label} launched {done}, expected {expect}")

    def held(g, got: dict, label: str, expect: dict) -> None:
        tally(g.name + label, expect)
        rows = P.compare(g, got, card_bounds(P, g))
        for row in rows:
            print(f"[golden] {g.name}{label} {row}", flush=True)
        check(all(row.ok for row in rows), f"{g.name}{label}: the card disagrees with the JAX golden")

    def drift(g, got: dict, expect: dict) -> None:
        tally(g.name + " bf16", expect)
        for key in ("depth", "normals"):
            d = np.abs(got[key] - g[key])
            print(f"[golden] {g.name} bf16 {key} vs the fp32 JAX golden: max|d| {d.max():.3e}, mean {d.mean():.3e}",
                  flush=True)

    def weights_of(g):
        t0 = time.perf_counter()
        mods = P.modules(g, dev)  # drawn by the rule on the host, the digest checked on the card
        print(f"[golden] {g.name}: {sum(p.numel() for m in mods.values() for p in m.parameters()) / 1e6:.1f} M "
              f"weights drawn and digest-checked in {time.perf_counter() - t0:.1f} s", flush=True)
        return mods

    def configs(g) -> tuple:
        """The golden's UNet and VAE configs, as the port's modules hold them."""
        return P.new_module("unet", g.meta["unet"]).config, P.new_module("vae", g.meta["vae"]).config

    def single_gn(g, dtype, hw=None) -> dict:
        """The GroupNorm kernels' launches of one single-step request of the golden's models at its image."""
        return request_gn(tuple(hw or g.meta["image_hw"][0]), dtype, 1, 1, *configs(g))

    reset_launches()
    # tiny: no attention kernel site and no GN -> conv pair in the kernels' envelope (C % 128); every standalone
    # GroupNorm takes the GroupNorm kernels, the fused VAE's pairs the plain composite
    g = R.Golden("marigold_single")
    held(g, P.single_step(g, P.marigold_pipeline(g, P.modules(g, dev), dev), ("_64", "_72x56")), "",
         gn_sum(*((2, single_gn(g, torch.float32, hw)) for hw in g.meta["image_hw"])))  # depth and normals
    g = R.Golden("train_sd2")
    unet_cfg, vae_cfg = configs(g)
    hw = tuple(g.meta["image_hw"][0])
    step_gn = gn_sum((2, gn_launches("unet", hw, torch.float32, config=unet_cfg)),
                     (1, gn_launches("encoder", hw, torch.float32, True, vae_cfg)),
                     (1, gn_launches("decoder", hw, torch.float32, True, vae_cfg)))
    held(g, {k: v for m in g.meta["modalities"] for k, v in P.train_step(g, P.modules(g, dev), f"{m}.", dev, m).items()},
         "", gn_sum((len(g.meta["modalities"]), step_gn)))

    g = R.Golden("card_marigold")
    marigold = {"flash_attention_fwd": 2 * (GOLDEN_UNET_SITES + 2)}  # depth, normals
    mods = weights_of(g)
    held(g, P.single_step(g, P.marigold_pipeline(g, mods, dev)), " fp32",
         {**marigold, **gn_sum((2, single_gn(g, torch.float32)))})
    bf16 = {k: copy.deepcopy(m) for k, m in mods.items()}
    drift(g, P.single_step(g, P.marigold_pipeline(g, bf16, dev, torch.bfloat16)),
          {**marigold, **gn_sum((2, single_gn(g, torch.bfloat16)))})
    del bf16
    g_train = R.Golden("card_train")
    check(g_train.meta["weights"] == g.meta["weights"] and all(
        np.array_equal(g_train.digests[p], g.digests[p]) for p in g.digests), "card_train's weights are not card_marigold's")
    initial = {n: p.detach().clone() for n, p in mods["unet"].named_parameters()}
    card_unet = configs(g_train)[0]
    held(g_train, P.train_step(g_train, mods, "depth.", dev, "depth"), " v1",
         step_launches(GOLDEN_UNET_SITES, unet_config=card_unet, hw=(256, 256), dtype=torch.float32))
    with torch.no_grad():
        for n, p in mods["unet"].named_parameters():
            p.copy_(initial[n])
    del initial
    os.environ["E2EFT_GNCONV_IMPL"] = "v2"
    try:
        held(g_train, P.train_step(g_train, mods, "depth.", dev, "depth"), " v2",
             step_launches(GOLDEN_UNET_SITES, "v2", unet_config=card_unet, hw=(256, 256), dtype=torch.float32))
    finally:
        del os.environ["E2EFT_GNCONV_IMPL"]
    del mods
    gc.collect()
    torch.cuda.empty_cache()

    g = R.Golden("card_geowizard")
    geowizard = {"flash_attention_fwd": GOLDEN_UNET_SITES + 2, **single_gn(g, torch.float32)}
    mods = weights_of(g)
    pipe = P.geowizard_pipeline(mods, dev)
    held(g, P.geowizard(g, pipe, ensemble=False), " fp32", geowizard)
    os.environ["E2EFT_FA_HP"] = "2"
    try:
        held(g, P.geowizard(g, pipe, ensemble=False), " fp32 hp 2",
             {**geowizard, "flash_attention_fwd_mh": GOLDEN_HP_SITES,
              "flash_attention_fwd": GOLDEN_UNET_SITES + 2 - GOLDEN_HP_SITES})
    finally:
        del os.environ["E2EFT_FA_HP"]
    drift(g, P.geowizard(g, P.geowizard_pipeline({k: copy.deepcopy(m) for k, m in mods.items()}, dev, torch.bfloat16),
                         ensemble=False), {**geowizard, **single_gn(g, torch.bfloat16)})
    del pipe, mods
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"[golden] launches in phase 20 {json.dumps(launches)}", flush=True)
    print(f"[golden] phase 20 in {seconds:.1f} s", flush=True)
    check(all(n > 0 for n in launches.values()), f"phase 20: a kernel held to the goldens never launched: {launches}")
    return launches


def save_weights(path: str, **parts) -> None:
    """Modules' configs and weights (on the CPU, `dtype` if given) for phase 18a's processes."""
    dtype = parts.pop("dtype", None)
    out = {}
    for key, value in parts.items():
        if isinstance(value, torch.nn.Module):
            out[f"{key}_config"] = value.config
            value = {k: (v.detach().to("cpu", dtype) if dtype else v.detach().cpu()) for k, v in value.state_dict().items()}
        out[key] = value
    torch.save(out, path)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible to torch; this run needs one GPU")
    dp_work = tempfile.mkdtemp(prefix="chip_smoke_dp_")  # phase 18a's weights and results
    try:
        return run(dp_work)
    finally:
        shutil.rmtree(dp_work, ignore_errors=True)


def run(dp_work: str) -> int:
    t_run = time.perf_counter()
    check(torch.cuda.device_count() == 1, f"expected one visible GPU, got {torch.cuda.device_count()}")
    from diffusion_e2e_ft_tpu_torch.kernels import _build
    from diffusion_e2e_ft_tpu_torch.kernels import flash_attention as fa

    dp_setup()
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}", flush=True)

    lib, seconds, log = _build.build()
    print(f"[build] {lib.relative_to(_build.PACKAGE_DIR.parent)} from "
          f"{[str(s.relative_to(_build.PACKAGE_DIR.parent)) for s in _build.sources()]} "
          f"in {seconds:.2f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}", flush=True)
    _build.load_library()

    numbers = {"flash_attention_fwd": phase_kernels(fa)}
    fwd = numbers["flash_attention_fwd"]
    fwd["max_abs_err"] = max(fwd["max_abs_err"], phase_forward_layouts(fa))
    batched_worst, batched_rows = phase_batched_kernels(fa)
    fwd["max_abs_err"] = max(fwd["max_abs_err"], batched_worst)
    fwd["shapes"].extend(batched_rows)
    numbers.update(phase_backward(fa))
    phase_grad_route(fa)
    numbers.update(phase_gn_kernels())
    route = phase_gn_route()
    numbers["gn_apply"], numbers["gn_group"] = route["gn_apply"], route["gn_group"]
    numbers["gn_channel_stats"]["max_abs_err"] = max(numbers["gn_channel_stats"]["max_abs_err"],
                                                     route["gn_channel_stats_route_err"])
    # every GroupNorm kernel launch of the in-process paths, phases 5 to 17 and the GeoWizard phases, is recorded:
    # each must fall at a shape phase 4c held
    route_record = contextlib.ExitStack()
    recorded = route_record.enter_context(recorded_launches())
    with tempfile.TemporaryDirectory() as ckpt:
        # no reference kept to phase 5's weights; phase 15 loads them again from ckpt
        launches = phase_serving(fa, phase_e2e_parity(fa), ckpt)
        torch.cuda.empty_cache()
        phase_slice_c_parity(fa)
        gc.collect()
        torch.cuda.empty_cache()
        with recorded_shapes(fa) as slice_c_shapes:
            launches["flash_attention_fwd"] += phase_marigold_ensembles(fa, ckpt)  # slice C's main path
        gc.collect()
        torch.cuda.empty_cache()
        launches["flash_attention_fwd"] += phase_mesh_marigold(ckpt)  # slice F's with_mesh
        gc.collect()
        torch.cuda.empty_cache()
        with recorded_shapes(fa) as eval_shapes:
            launches["flash_attention_fwd"] += phase_eval_path(fa, ckpt)  # slice E1's main path
        gc.collect()
        torch.cuda.empty_cache()
        data_path = phase_data_path(ckpt)  # slice E2's main path
    gc.collect()
    torch.cuda.empty_cache()

    from diffusion_e2e_ft_tpu_torch.models import UNetConfig, VAEConfig
    from diffusion_e2e_ft_tpu_torch.pipelines import MarigoldPipeline

    cpu = MarigoldPipeline.from_random(UNetConfig.sd2(), VAEConfig(), seed=1, device="cpu")
    empty = np.random.default_rng(1).normal(size=(1, 77, 1024)).astype(np.float32)  # a 77-token text context
    unet, vae = phase_train_parity(fa, cpu.unet, cpu.vae, empty)
    del cpu
    trained = phase_train(unet, vae, empty)
    for name, n in trained.items():  # kernel 1 counts the serving paths' launches only
        if name != "flash_attention_fwd":
            launches[name] += n
    phase_trainer_options(unet, vae, empty)  # slice D3
    save_weights(os.path.join(dp_work, "sd2.pt"), unet=unet, vae=vae, empty=empty)  # for phase 18a
    del unet, vae, empty
    gc.collect()
    torch.cuda.empty_cache()

    geo = phase_geowizard_kernels(fa)
    numbers["flash_attention_fwd_mh"] = geo["flash_attention_fwd_mh"]
    fwd["max_abs_err"] = max(fwd["max_abs_err"], geo["worst_fwd"])
    fwd["shapes"].insert(0, geo["fwd_row"])  # [1, 18432, 8, 40] beside the VAE mid block's [1, 9216, 1, 512]
    geo_path, geo_pipe = phase_geowizard_serving(fa, phase_geowizard_parity(fa))
    # the forward kernel's launches: slice A's, slice B's and slice C's serving runs
    with recorded_shapes(fa) as geo_shapes:
        launches["flash_attention_fwd"] += geo_path["flash_attention_fwd"] + phase_geowizard_ensemble(fa, geo_pipe)
    # phase 3 and 3c held kernel 1 against its plain version at every shape slice C's requests sent it
    slice_c_shapes |= geo_shapes
    check(slice_c_shapes == set(slice_c_attention_cases()),
          f"slice C's requests sent kernel 1 {sorted(slice_c_shapes)}, phase 3c expected {sorted(slice_c_attention_cases())}")
    launches["flash_attention_fwd_mh"] = geo_path["flash_attention_fwd_mh"]
    with recorded_shapes(fa) as geo_eval_shapes:
        launches["flash_attention_fwd"] += phase_eval_geowizard(fa, geo_pipe)
    # phase 3c held kernel 1 against its plain version at every shape the eval path's frames sent it
    eval_shapes |= geo_eval_shapes
    check(eval_shapes == set(eval_attention_cases()),
          f"the eval path sent kernel 1 {sorted(eval_shapes)}, phase 3c expected {sorted(eval_attention_cases())}")
    launches["flash_attention_fwd"] += mesh_ensembles(geo_pipe, "GeoWizard", ("depth_np", "normal_np", "uncertainty"))
    del geo_pipe
    gc.collect()
    torch.cuda.empty_cache()
    geo_modules = phase_geowizard_train_parity()
    geo_train = phase_geowizard_train(*geo_modules)  # slice B2's main path
    save_weights(os.path.join(dp_work, "geowizard.pt"), unet=geo_modules[0], vae=geo_modules[1],
                 encoder=geo_modules[2], dtype=torch.bfloat16)
    del geo_modules
    route_record.close()
    route_seen = {shape for name, shape in recorded if name in ("gn_apply", "gn_group")}
    check(route_seen <= route_shapes(), f"the GroupNorm kernels ran at {sorted(route_seen - route_shapes())}, "
          "shapes phase 4c does not hold")
    print(f"[gn-route] the in-process paths launched the GroupNorm kernels at {len(route_seen)} shapes, each held "
          f"by phase 4c ({len(route_shapes())} shapes)", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    dp_launches = phase_data_parallel(dp_work)  # slice F's main path, in processes of its own
    fsdp_launches = phase_fsdp(dp_work)  # slice F2's main path, after 18a's reference
    launches["flash_attention_fwd"] += phase_export_roundtrip(dp_work)  # slice G
    phase_goldens()  # slice E3: every kernel against the JAX package's numbers; a check, not a main path
    for name, n in [*geo_train.items(), *data_path.items(), *dp_launches.items(), *fsdp_launches.items()]:
        launches[name] += n
    check(all(n > 0 for n in launches.values()), f"a kernel of the main paths was not launched: {launches}")

    table = {  # kernel: (source under csrc/, the TPU kernel under diffusion_e2e_ft_tpu/kernels/)
        "flash_attention_fwd": ("flash_attention.cu", "flash_attention.py:114"),
        "flash_attention_fwd_mh": ("flash_attention.cu", "flash_attention.py:181"),
        "flash_attention_fwd_lse": ("flash_attention.cu", "flash_attention.py:294"),
        "flash_attention_bwd_dq": ("flash_attention_bwd.cu", "flash_attention.py:374"),
        "flash_attention_bwd_dkv": ("flash_attention_bwd.cu", "flash_attention.py:407"),
        "gn_channel_stats": ("groupnorm.cu", "groupnorm.py:88"),
        "gn_apply": ("groupnorm.cu", "groupnorm.py:141-148 (XLA's apply after _stats_kernel; no Pallas kernel)"),
        "gn_group": ("groupnorm.cu", "groupnorm.py:88 (_stats_kernel, with XLA's apply after it at :141-148, in "
                                     "one launch where a group fits)"),
        "gn_silu_conv3x3": ("gn_conv.cu", "gn_conv.py:80"),
        "gn_silu_conv3x3_v2": ("gn_conv.cu", "gn_conv.py:209"),
    }
    kernels = [{
        "name": name,
        "route": "cuda",
        "source": f"diffusion_e2e_ft_tpu_torch/csrc/{source}",
        "replaces": f"diffusion_e2e_ft_tpu/kernels/{replaces}",
        "launches": launches[name],
        **numbers[name],
    } for name, (source, replaces) in table.items()]
    print(f"[smoke] every phase passed in {time.perf_counter() - t_run:.1f} s", flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
