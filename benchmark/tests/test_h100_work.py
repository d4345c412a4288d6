"""The work counters against hand-worked values at a small shape."""

import pytest
import torch

from reference import models as ref
from work import count as work_count
from work import roofline as R


def test_roofline_takes_the_larger_bound():
    assert R.roofline_s(989e12, 0) == pytest.approx(1.0)
    assert R.roofline_s(0, 3.35e12) == pytest.approx(1.0)
    assert R.roofline_s(989e9, 3.35e12) == pytest.approx(1.0)


def test_attention_counts_at_a_small_shape_with_lq_apart_from_lk():
    # B 2, Lq 8, Lk 4, N 3, d 16: S and O are 2 * 8 * 4 * 16 operations a head each
    flops, nbytes = R.attention_fwd(2, 8, 4, 3, 16)
    assert flops == 2 * 2 * (2 * 3) * (2 * 8 * 4 * 16) / 2
    assert nbytes == 2 * 2 * 3 * 16 * (2 * 8 + 2 * 4)
    bflops, bbytes = R.attention_bwd(2, 8, 4, 3, 16)
    assert bflops == 7 * 2.0 * 2 * 3 * 8 * 4 * 16
    assert bbytes == 2 * 2 * 3 * 16 * (4 * 8 + 4 * 4) + 8 * 2 * 3 * 8


def test_group_norm_and_conv_counts():
    assert R.group_norm_bytes(1000) == 4000
    assert R.conv3x3_flops(2, 4, 8, 5, 6) == 2 * 2 * 8 * 4 * 9 * 5 * 6


def test_the_counter_sees_products_and_attention_calls_on_meta():
    with torch.device("meta"):
        block = ref.TransformerBlock(32, 2, 16, 8, joint=True)
        x, ctx = torch.empty(4, 10, 32), torch.empty(4, 3, 8)
    work = work_count.count(lambda: block(x, ctx), block)
    assert work.attention == [(2, 20, 20, 2, 16)]  # joint: the [B, 2L] call; cross-attention is not listed
    proj = 3 * 2 * 40 * 32 * 32 + 2 * 40 * 32 * 32  # q, k, v and out of self-attention on 40 tokens
    proj += 2 * 40 * 32 * 32 * 2 + 2 * 2 * 12 * 8 * 32  # cross: q, out; k, v over 12 context tokens
    attn = 2 * (2 * 2 * 2 * 20 * 20 * 16) + 2 * (2 * 4 * 2 * 10 * 3 * 16)
    ff = 2 * 40 * 32 * 256 + 2 * 40 * 128 * 32
    assert work.flops == proj + attn + ff
