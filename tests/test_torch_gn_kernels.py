"""The Hopper GroupNorm kernels' algorithms, emulated in plain fp32 torch on
the CPU: the bf16 GroupNorm+SiLU -> conv3x3 kernel's schedule (its tiles,
tap shifts, channel chunks, in-kernel fold and masking of ragged H, W and
Cout) against the plain composite, the statistics kernel's split-row
reduction order against the plain sums, the in-kernel fold against
`fold_stats`; the single-launch v2 kernel's statistics phase (rows cut by
its plan into one warp's segments, the parts added in order), its tile walk
and its fold; and the Python views of the kernels' tiles and host rules
against the CUDA sources.

The kernels run only on the card; `chip_smoke.py` holds them to their plain
versions there.

Tolerances: fp32 on both sides, differing only in summation order: 1e-5
relative to max(1, |ref|) for the conv (K = 9 C products summed by chunk and
tap against one ATen convolution), 1e-5 relative for the row sums, 1e-6 for
the fold (the same formula, group sums in another order).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diffusion_e2e_ft_tpu_torch.kernels import gn_conv as tgc
from diffusion_e2e_ft_tpu_torch.kernels import groupnorm as tgn

CSRC = Path(tgc.__file__).parent.parent / "csrc"
GROUPS, EPS = 32, 1e-6
# (B, C, H, W, Cout): ragged against the 4 x 64 tile, H = 1 (every tap but the
# middle row is padding), Cout ragged against the 128-channel tile, W one and
# two columns past a tile, and whole tiles
RAGGED = [(1, 128, 37, 53, 128), (2, 256, 1, 77, 128), (3, 128, 9, 9, 96), (1, 128, 6, 65, 64),
          (1, 256, 5, 130, 160), (2, 128, 8, 64, 256)]
RAGGED_IDS = ["37x53", "1x77", "9x9-to-96", "6x65-to-64", "5x130-to-160", "8x64-to-256"]
# the 480x640 bs-2 train step's GN -> conv shapes (B, C, H, W, Cout) and the v1 kernel's blocks
TRAIN_SHAPES = [
    ((2, 128, 480, 640, 128), 2400), ((2, 256, 480, 640, 128), 2400), ((2, 128, 240, 320, 256), 1200),
    ((2, 256, 240, 320, 256), 1200), ((2, 512, 240, 320, 256), 1200), ((2, 256, 120, 160, 512), 720),
    ((2, 512, 120, 160, 512), 720), ((2, 512, 60, 80, 512), 240),
]


def _inputs(b, c, h, w, co, seed):
    """NCHW x (mean 0.5), the GroupNorm's weight and non-zero bias, OIHW conv weight and bias."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((shift + scale * rng.standard_normal(shape)).astype(np.float32))

    return dict(x=t(b, c, h, w, shift=0.5), gn_weight=t(c, scale=0.2, shift=1.0), gn_bias=t(c, scale=0.5),
                weight=t(co, c, 3, 3, scale=(9 * c) ** -0.5), conv_bias=t(co, scale=0.1))


def _emulate_fold(stats, gn_weight, gn_bias, groups, eps, count):
    """`fold_groups` (csrc/gn_common.cuh), channel by channel: each channel's
    partial sums (stats [B, 2, C] or, v2's scratch, [B, 2, C, parts]) added
    in part order, the group's channel sums in channel order, in fp32; mean,
    E[x^2] - mean^2 clamped at 0, a = rsqrt(var + eps) * w, b = bias - mean *
    a. -> fp32 (a, b), each [B, C]."""
    if stats.ndim == 3:
        stats = stats[..., None]
    b, _, c, parts = stats.shape
    gs = c // groups
    n = torch.tensor(float(count * gs))
    a = torch.empty(b, c)
    bb = torch.empty(b, c)
    for ch in range(c):
        g0 = ch // gs * gs
        gsum = torch.zeros(b)
        gsq = torch.zeros(b)
        for j in range(gs):
            cs, csq = torch.zeros(b), torch.zeros(b)
            for q in range(parts):
                cs, csq = cs + stats[:, 0, g0 + j, q], csq + stats[:, 1, g0 + j, q]
            gsum = gsum + cs
            gsq = gsq + csq
        mean = gsum / n
        var = torch.clamp(gsq / n - mean * mean, min=0.0)
        a[:, ch] = torch.rsqrt(var + eps) * gn_weight[ch]
        bb[:, ch] = gn_bias[ch] - mean * a[:, ch]
    return a, bb


def _emulate_conv_schedule(x, gn_weight, gn_bias, groups, eps, weight, conv_bias, silu, stats=None):
    """The bf16 wgmma body (csrc/gn_conv.cu, `hop::wgmma_tile`, as v1's
    `gn_conv_wgmma_kernel` runs it) in plain fp32: per image, TH x TW output
    tiles and BN-channel output tiles; the tile's (TH + 2) x (TW + 2) halo
    normalised with the folded a, b (halved under SiLU, which is then h + h
    tanh(h)) and zeroed outside the image, BKC channels at a time; for each
    chunk the nine taps in order, each the halo shifted by (dy, dx) times the
    tap's [BN, BKC] weight slab (zeros past Cout); the fp32 bias, then the
    rows and columns inside the image and the channels below Cout stored. The
    fold takes `stats` (v2's split sums) where given, else the plain sums."""
    th, tw, bn, bkc = (tgc.BF16_TILE[k] for k in ("TH", "TW", "BN", "BKC"))
    b, c, h, w = x.shape
    cout = weight.shape[0]
    stats = tgn.channel_stats_reference(x) if stats is None else stats
    a, bb = _emulate_fold(stats, gn_weight, gn_bias, groups, eps, h * w)
    if silu:
        a, bb = 0.5 * a, 0.5 * bb
    out = torch.full((b, cout, h, w), float("nan"))
    for i in range(b):
        for h0 in range(0, h, th):
            for w0 in range(0, w, tw):
                hs, ws = torch.arange(h0 - 1, h0 + th + 1), torch.arange(w0 - 1, w0 + tw + 1)
                inside = ((hs >= 0) & (hs < h))[:, None] & ((ws >= 0) & (ws < w))[None, :]
                raw = x[i][:, hs.clamp(0, h - 1)][:, :, ws.clamp(0, w - 1)]  # [C, TH + 2, TW + 2]
                y = raw * a[i][:, None, None] + bb[i][:, None, None]
                if silu:
                    y = y + y * torch.tanh(y)
                y = torch.where(inside, y, torch.zeros(()))
                for n0 in range(0, cout, bn):
                    slab = torch.zeros(bn, 3, 3, c)
                    valid = min(bn, cout - n0)
                    slab[:valid] = weight[n0:n0 + valid].permute(0, 2, 3, 1)
                    acc = torch.zeros(th * tw, bn)
                    for c0 in range(0, c, bkc):
                        for tap in range(9):
                            dy, dx = divmod(tap, 3)
                            a_op = y[c0:c0 + bkc, dy:dy + th, dx:dx + tw].reshape(bkc, th * tw).T
                            acc = acc + a_op @ slab[:, dy, dx, c0:c0 + bkc].T
                    bias = torch.zeros(bn)
                    bias[:valid] = conv_bias[n0:n0 + valid]
                    tile = (acc + bias).T.reshape(bn, th, tw)
                    rows, cols = min(th, h - h0), min(tw, w - w0)
                    out[i, n0:n0 + valid, h0:h0 + rows, w0:w0 + cols] = tile[:valid, :rows, :cols]
    return out


@pytest.mark.parametrize("silu", [True, False], ids=["silu", "no-silu"])
@pytest.mark.parametrize("b,c,h,w,co", RAGGED, ids=RAGGED_IDS)
def test_conv_schedule_matches_plain(b, c, h, w, co, silu):
    args = _inputs(b, c, h, w, co, seed=h * w + co)
    got = _emulate_conv_schedule(**args, groups=GROUPS, eps=EPS, silu=silu)
    want = tgc.gn_conv_reference(**args, groups=GROUPS, eps=EPS, silu=silu)
    assert not torch.isnan(got).any()  # every output written once
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5 * max(1.0, want.abs().max().item()), rtol=0)


@pytest.mark.parametrize("loc", [0.0, 30.0], ids=["centred", "large-mean"])
def test_kernel_fold_matches_fold_stats(loc):
    """The in-kernel fold, emulated, is `fold_stats`' formula: the same a, b
    (at a large mean the clamp at 0 included: one group is constant)."""
    args = _inputs(2, 256, 6, 5, 128, seed=21)
    x = args["x"] + loc
    x[1, 8:16] = 0.3
    stats = tgn.channel_stats_reference(x)
    a, bb = _emulate_fold(stats, args["gn_weight"], args["gn_bias"], GROUPS, EPS, 30)
    want = tgc.fold_stats(stats, args["gn_weight"], args["gn_bias"], GROUPS, EPS, 30)
    torch.testing.assert_close(a, want[:, 0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(bb, want[:, 1], rtol=1e-6, atol=1e-6 * max(1.0, loc))


def _section(src: str, start: str) -> str:
    return src[src.index(start):]


def test_conv_tiles_match_the_kernel_source():
    """`BF16_TILE` is the Python view of the wgmma kernel's constants."""
    hop = _section((CSRC / "gn_conv.cu").read_text(), "namespace hop {")
    found = {}
    for name in tgc.BF16_TILE:
        m = re.search(rf"\b{name} = (\d+)", hop)
        assert m, name
        found[name] = int(m.group(1))
    assert found == tgc.BF16_TILE


@pytest.mark.parametrize("shape,blocks", TRAIN_SHAPES,
                         ids=[f"{s[1]}x{s[2]}x{s[3]}-to-{s[4]}" for s, _ in TRAIN_SHAPES])
def test_blocks_at_the_train_shapes(shape, blocks):
    """The v1 kernel's grid at the train step's shapes: 1.8 waves of one block
    an SM on 132 SMs at the 60x80 decoder layer, at least 5 elsewhere."""
    b, _, h, w, co = shape
    assert tgc.conv_blocks(b, co, h, w) == blocks


def test_stats_split_matches_the_kernel_source():
    src = (CSRC / "groupnorm.cu").read_text()
    found = {name: int(re.search(rf"{name} = (\d+);", src).group(1)) for name in tgn.STATS_SPLIT}
    assert found == tgn.STATS_SPLIT
    # the train step's 8 shapes (B * C rows of H * W values) on 132 SMs: about one wave of 1056 blocks
    shapes = [s for s, _ in TRAIN_SHAPES]
    assert [tgn.stats_parts(b * c, h * w) for b, c, h, w, _ in shapes] == [4, 2, 4, 2, 1, 1, 1, 1]
    assert tgn.stats_parts(1, 10**7) == 8 and tgn.stats_parts(2, 10**7, sms=1) == 4


def _emulate_row_sums(row, parts, threads=256, vec=8, only=None):
    """`segment_stats` over one row of fp32 values (the bf16 layout: 8 values a
    16-byte vector, the row 16-byte aligned: no scalar head) + the cluster's
    rank-order sum: each part a run of whole vectors, each thread's vectors in
    index order (the unrolled loop adds them in that order too), warp
    butterfly sums, warps in order, parts in rank order; the scalar tail in
    the last part. `only`: that part's sums alone (one warp's item in v2,
    threads=32)."""
    n = row.numel()
    nvec = n // vec
    body = row[:nvec * vec].reshape(nvec, vec)
    total_s, total_ss = torch.zeros(()), torch.zeros(())
    for part in range(parts) if only is None else (only,):
        v0, v1 = nvec * part // parts, nvec * (part + 1) // parts
        s, ss = torch.zeros(threads), torch.zeros(threads)
        idx = torch.arange(threads) + v0
        while True:
            live = idx < v1
            if not live.any():
                break
            vals = body[idx.clamp(max=nvec - 1)] * live[:, None]
            for j in range(vec):
                s = s + vals[:, j]
                ss = torch.addcmul(ss, vals[:, j], vals[:, j])
            idx = idx + threads
        if part == parts - 1:
            tail = row[nvec * vec:]
            for k in range(tail.numel()):
                s[k % threads] += tail[k]
                ss[k % threads] += tail[k] * tail[k]
        for off in (16, 8, 4, 2, 1):  # __shfl_xor_sync butterfly, per warp
            lanes = torch.arange(threads)
            s, ss = s + s[lanes ^ off], ss + ss[lanes ^ off]
        ws, wss = torch.zeros(()), torch.zeros(())
        for warp in range(threads // 32):
            ws, wss = ws + s[32 * warp], wss + ss[32 * warp]
        total_s, total_ss = total_s + ws, total_ss + wss
    return total_s, total_ss


@pytest.mark.parametrize("n", [4800, 40000, 76803], ids=["one-part", "two-parts", "four-parts-ragged"])
def test_stats_split_order_matches_plain(n):
    """The statistics kernel's split-row reduction, emulated, against the plain
    per-channel sums (ragged n: a scalar tail in the last part)."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy((0.5 + rng.standard_normal((1, 3, n))).astype(np.float32))
    parts = tgn.stats_parts(3, n)
    assert parts == {4800: 1, 40000: 2, 76803: 4}[n]
    want = tgn.channel_stats_reference(x)
    for c in range(3):
        s, ss = _emulate_row_sums(x[0, c], parts)
        torch.testing.assert_close(s, want[0, 0, c], rtol=1e-5, atol=1e-5 * n ** 0.5)
        torch.testing.assert_close(ss, want[0, 1, c], rtol=1e-5, atol=0)


# v2's plans at the train step's shapes on the H100's 132 SMs: parts a row (4 of 256 rows, 2 of 512, 1 of 1024
# fill the grid's 1056 warps 97%) and the conv's tiles; every launch takes the whole card
V2_TRAIN_PARTS = [4, 2, 4, 2, 1, 2, 1, 1]
SMS = {"h100": 132, "small": 7}


def _emulate_v2_stats(x, parts, warp=32):
    """v2's statistics phase (`v2_stats`): each (b, c) row cut into `parts`
    segments of whole 16-byte vectors, each reduced by one warp (its lanes'
    vectors in index order, the butterfly), written to [B, 2, C, parts]."""
    b, c = x.shape[:2]
    out = torch.empty(b, 2, c, parts)
    for i in range(b):
        for ch in range(c):
            row = x[i, ch].reshape(-1)
            for part in range(parts):
                out[i, 0, ch, part], out[i, 1, ch, part] = _emulate_row_sums(row, parts, threads=warp, only=part)
    return out


@pytest.mark.parametrize("shape,parts", list(zip([s for s, _ in TRAIN_SHAPES], V2_TRAIN_PARTS)),
                         ids=[f"{s[1]}x{s[2]}x{s[3]}-to-{s[4]}" for s, _ in TRAIN_SHAPES])
def test_v2_plan_at_the_train_shapes(shape, parts):
    """v2's grid on 132 SMs: one block an SM, every SM busy, the rows cut so
    that B * C * parts warp items fill their waves, and as many conv items as
    v1 has blocks."""
    b, c, h, w, co = shape
    plan = tgc.v2_plan(b, c, h, w, co, SMS["h100"])
    assert (plan.parts, plan.blocks, plan.items) == (parts, 132, tgc.conv_blocks(b, co, h, w))
    items = b * c * parts
    assert items / (-(-items // (132 * tgc.V2_WARPS)) * 132 * tgc.V2_WARPS) >= tgc.V2_SPLIT["kV2FillPct"] / 100


@pytest.mark.parametrize("sms", sorted(SMS.values()), ids=sorted(SMS, key=SMS.get))
@pytest.mark.parametrize("shape", [s for s, _ in TRAIN_SHAPES],
                         ids=[f"{s[1]}x{s[2]}x{s[3]}-to-{s[4]}" for s, _ in TRAIN_SHAPES])
def test_v2_stats_split_matches_plain(shape, sms):
    """v2's statistics phase at each train shape's plan, emulated on a short
    synthetic row set of the shape's layout (2 images x 4 channels, rows of
    parts x 1024 + 13 values: a scalar tail in the last part): the parts'
    sums added in part order are the plain per-channel sums."""
    b, c, h, w, co = shape
    parts = tgc.v2_plan(b, c, h, w, co, sms).parts
    n = parts * 1024 + 13
    rng = np.random.default_rng(parts * 100 + sms)
    x = torch.from_numpy((0.5 + rng.standard_normal((2, 4, n))).astype(np.float32))
    split = _emulate_v2_stats(x, parts)
    want = tgn.channel_stats_reference(x)
    total = torch.zeros(2, 2, 4)
    for q in range(parts):  # the fold's order
        total = total + split[..., q]
    torch.testing.assert_close(total[:, 0], want[:, 0], rtol=1e-5, atol=1e-5 * n ** 0.5)
    torch.testing.assert_close(total[:, 1], want[:, 1], rtol=1e-5, atol=0)


def _walk(plan, blocks, th, tw, bn):
    """v2's phase-2 walk (`gn_conv_v2_kernel`): block k takes items k, k +
    blocks, ...; item t is image t / per_image, pixel tile t % per_image /
    ntiles, channel tile t % ntiles; the block folds whenever the image
    changes. -> {block: [(b, h0, w0, n0), ...]}, {block: [images folded]}."""
    per_image = plan.tiles_hw * plan.ntiles
    visits, folds = {}, {}
    for k in range(blocks):
        folded = -1
        for t in range(k, plan.items, blocks):
            b, pix, n0 = t // per_image, t % per_image // plan.ntiles, t % plan.ntiles * bn
            if b != folded:
                folds.setdefault(k, []).append(b)
                folded = b
            visits.setdefault(k, []).append((b, pix // plan.tiles_w * th, pix % plan.tiles_w * tw, n0))
    return visits, folds


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("sms", sorted(SMS.values()), ids=sorted(SMS, key=SMS.get))
@pytest.mark.parametrize("b,c,h,w,co", RAGGED + [(3, 256, 37, 53, 160)], ids=RAGGED_IDS + ["B3-37x53-to-160"])
def test_v2_walk_covers_every_tile_once(b, c, h, w, co, sms, dtype):
    """Every output element of every image is written by exactly one item of
    the walk, on a grid of 132 blocks and of 7; each block folds once per
    image it meets, at the image's first item."""
    plan = tgc.v2_plan(b, c, h, w, co, sms, dtype)
    tile = tgc.BF16_TILE if dtype == torch.bfloat16 else tgc.FP32_TILE
    th, tw, bn = tile["TH"], tile["TW"], tile["BN"]
    assert plan.blocks <= sms and plan.blocks == min(sms, max(-(-b * c * plan.parts // tgc.V2_WARPS), plan.items))
    visits, folds = _walk(plan, plan.blocks, th, tw, bn)
    written = torch.zeros(b, co, h, w, dtype=torch.int32)
    for items in visits.values():
        for i, h0, w0, n0 in items:
            written[i, n0:n0 + bn, h0:h0 + th, w0:w0 + tw] += 1
    assert bool((written == 1).all())
    for k, items in visits.items():
        images = [i for i, *_ in items]
        assert folds[k] == sorted(set(images)) and images == sorted(images)


@pytest.mark.parametrize("parts", [1, 2, 4])
@pytest.mark.parametrize("loc", [0.0, 30.0], ids=["centred", "large-mean"])
def test_v2_fold_halved_under_silu(loc, parts):
    """v2's fold from the split sums [B, 2, C, parts], scaled by 0.5 as the
    wgmma body's SiLU (h + h tanh(h), h = y / 2) takes it, is `fold_stats` of
    the same sums (the parts added in part order) times 0.5; at a large mean
    the clamp at 0 included (one group is constant)."""
    n = parts * 1024
    rng = np.random.default_rng(22 + parts)
    x = torch.from_numpy((loc + 0.5 + rng.standard_normal((2, 256, n))).astype(np.float32))
    x[1, 8:16] = 0.3
    args = _inputs(1, 256, 1, 1, 128, seed=23)
    split = _emulate_v2_stats(x, parts)
    a, bb = _emulate_fold(split, args["gn_weight"], args["gn_bias"], GROUPS, EPS, n)
    total = torch.zeros(2, 2, 256)
    for q in range(parts):
        total = total + split[..., q]
    want = 0.5 * tgc.fold_stats(total, args["gn_weight"], args["gn_bias"], GROUPS, EPS, n)
    torch.testing.assert_close(0.5 * a, want[:, 0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(0.5 * bb, want[:, 1], rtol=1e-6, atol=1e-6 * max(1.0, loc))


@pytest.mark.parametrize("b,c,h,w,co", RAGGED[:3], ids=RAGGED_IDS[:3])
def test_v2_schedule_matches_plain(b, c, h, w, co):
    """The bf16 v2 kernel end to end in plain fp32: the split statistics at
    its plan on 7 SMs (each row taken as 16-byte aligned: no scalar head), the fold from
    them, and the wgmma body's schedule, against the plain composite."""
    args = _inputs(b, c, h, w, co, seed=h + w + co)
    parts = tgc.v2_plan(b, c, h, w, co, SMS["small"]).parts
    got = _emulate_conv_schedule(**args, groups=GROUPS, eps=EPS, silu=True,
                                 stats=_emulate_v2_stats(args["x"].reshape(b, c, -1), parts))
    want = tgc.gn_conv_reference(**args, groups=GROUPS, eps=EPS, silu=True)
    assert not torch.isnan(got).any()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5 * max(1.0, want.abs().max().item()), rtol=0)


def test_v2_plan_matches_the_kernel_source():
    """`V2_SPLIT`, `V2_WARPS` and `FP32_TILE` are the Python views of the v2
    kernel's constants, and `v2_plan` follows its grid rule: the parts over
    the grid's warps, the blocks no more than the larger phase's items."""
    src = (CSRC / "gn_conv.cu").read_text()
    outer = src[:src.index("namespace hop {")]
    found = {name: int(re.search(rf"\b{name} = (\d+);", src).group(1)) for name in tgc.V2_SPLIT}
    assert found == tgc.V2_SPLIT
    assert int(re.search(r"constexpr int THREADS = (\d+);", outer).group(1)) // 32 == tgc.V2_WARPS
    assert "constexpr int kV2Warps = THREADS / 32;" in src
    assert (int(re.search(r"constexpr int TH = (\d+), TW = (\d+);", outer).group(1)),
            int(re.search(r"constexpr int TH = (\d+), TW = (\d+);", outer).group(2))) == (tgc.FP32_TILE["TH"],
                                                                                       tgc.FP32_TILE["TW"])
    for name in ("BN", "BK"):
        assert int(re.search(rf"constexpr int {name} = (\d+);", outer).group(1)) == tgc.FP32_TILE[name]
    for rule in ("v2_parts(rows, static_cast<int64_t>(H) * W, full * kV2Warps)",
                 "std::max((rows * parts + kV2Warps - 1) / kV2Warps, static_cast<int64_t>(B) * tl.tiles_hw * tl.ntiles)",
                 "std::min(full, work)", "if (p > 1 && n / p < kV2MinSegment) break;",
                 "if (items * 100 >= room * kV2FillPct) return p;"):
        assert rule in " ".join(src.split()), rule
    # the rule's edges: a row too short to split; rows too few for the grid take the fullest parts
    assert tgc.v2_parts(64, 2 * 4096 - 1, 1056) == 1
    assert tgc.v2_parts(64, 76800, 1056) == 8 and tgc.v2_parts(1024, 76800, 1056) == 1
