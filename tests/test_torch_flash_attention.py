"""Flash attention in the torch port: the plain version against the JAX package's
Pallas kernel (interpreter mode on the CPU), the bf16 kernel's schedule
emulated in plain torch against the plain version, the dispatch envelope at
the main path's shapes, and the kernel wrapper's refusals.

The kernel itself runs only on the card; `chip_smoke.py` holds it to the plain
version there."""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from diffusion_e2e_ft_tpu.kernels import flash_attention as jfa
from diffusion_e2e_ft_tpu.models import UNetConfig as JUNetConfig
from diffusion_e2e_ft_tpu_torch import kernels
from diffusion_e2e_ft_tpu_torch.kernels import in_kernel_envelope
from diffusion_e2e_ft_tpu_torch.kernels import flash_attention as tfa
from diffusion_e2e_ft_tpu_torch.models import AutoencoderKL, UNet2DCondition, UNetConfig, VAEConfig


@pytest.fixture
def interpret_mode():
    jfa.INTERPRET = True
    yield
    jfa.INTERPRET = False


def _qkv(bn, lq, lk, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((bn, l, d)).astype(np.float32) for l in (lq, lk, lk))


# fp32 on both sides; the two softmax orders differ only in summation order
# (online over 128-column blocks vs one pass), so 2e-5 is the fp32 bound the
# JAX package's own kernel tests use.
@pytest.mark.parametrize(
    "bn,lq,lk,d",
    [(2, 300, 300, 64), (1, 256, 512, 64), (1, 256, 256, 512)],
    ids=["ragged-d64", "cross-lengths-d64", "d512"],
)
def test_reference_matches_pallas_kernel(interpret_mode, bn, lq, lk, d):
    q, k, v = _qkv(bn, lq, lk, d, seed=lq + d)
    scale = d**-0.5
    want = np.asarray(jfa._flash_bnld(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, block_k=128))
    # [BN, L, D] is the port's [B, L, N, D] with B = BN, N = 1
    got = tfa.flash_attention_reference(
        *(torch.from_numpy(x)[:, :, None] for x in (q, k, v)), scale
    )[:, :, 0].numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def _emulate_bf16_schedule(q, k, v, scale, bq, bk, ds):
    """The bf16 forward kernel's algorithm (csrc/flash_attention.cu) in plain
    fp32 torch, [B, Lq, N, D] -> (out, lse [B, Lq, N]): d padded with zero
    columns to a multiple of 16; Q in tiles of `bq` rows and K, V in tiles of
    `bk` rows, zero-filled past Lq and Lk; each tile's logits summed from `ds`
    partial products over slices of d; columns past Lk at -inf; an online
    softmax in base 2 with scale * log2(e) folded into one multiply and the
    running max kept in that scale; O rescaled once per KV tile; the LSE
    converted back to the natural log as (m + log2 l) ln 2."""
    b, lq, n, d = q.shape
    lk = k.shape[1]
    dp = -(-d // 16) * 16
    sl2 = scale * math.log2(math.e)

    def tiles(t, rows):  # [B, L, N, D] -> [B, N, T, rows, DP], zero rows and columns past L and D
        length = t.shape[1]
        t = F.pad(t, (0, dp - d, 0, 0, 0, -length % rows))
        return t.permute(0, 2, 1, 3).reshape(b, n, -1, rows, dp)

    qt, kt, vt = tiles(q, bq), tiles(k, bk), tiles(v, bk)
    w = dp // ds
    out = torch.empty(b, n, qt.shape[2], bq, dp)
    lse = torch.empty(b, n, qt.shape[2], bq)
    for i in range(qt.shape[2]):
        qi = qt[:, :, i]
        m = torch.full((b, n, bq), -math.inf)
        l = torch.zeros(b, n, bq)
        acc = torch.zeros(b, n, bq, dp)
        for j in range(kt.shape[2]):
            s = sum(qi[..., p * w:(p + 1) * w] @ kt[:, :, j, :, p * w:(p + 1) * w].transpose(-1, -2)
                    for p in range(ds))
            s[..., max(lk - j * bk, 0):] = -math.inf
            m_new = torch.maximum(m, s.amax(-1) * sl2)
            corr = torch.exp2(m - m_new)
            p_ = torch.exp2(s * sl2 - m_new[..., None])
            l = l * corr + p_.sum(-1)
            acc = acc * corr[..., None] + p_ @ vt[:, :, j]
            m = m_new
        out[:, :, i] = acc / l[..., None]
        lse[:, :, i] = (m + torch.log2(l)) * math.log(2.0)
    out = out.reshape(b, n, -1, dp)[:, :, :lq, :d].permute(0, 2, 1, 3)
    return out, lse.reshape(b, n, -1)[:, :, :lq].transpose(1, 2)


# fp32 on both sides: the emulation's online softmax differs from the one-pass
# plain version only in summation order and in exp2 of a product against exp
# of a difference, ~1e-7 relative; 1e-5 holds both out and lse.
@pytest.mark.parametrize("lk", [256, 257, 300])
@pytest.mark.parametrize("d", sorted(tfa.BF16_TILES))
def test_bf16_schedule_matches_plain(d, lk):
    bq, bk, ds = tfa.BF16_TILES[d]
    rng = np.random.default_rng(d + lk)
    q = torch.from_numpy(rng.standard_normal((1, 300, 2, d)).astype(np.float32))  # Lq ragged against bq
    k, v = (torch.from_numpy(rng.standard_normal((1, lk, 2, d)).astype(np.float32)) for _ in range(2))
    scale = d**-0.5
    got_out, got_lse = _emulate_bf16_schedule(q, k, v, scale, bq, bk, ds)
    want_out, want_lse = tfa.flash_attention_fwd_lse_reference(q, k, v, scale)
    torch.testing.assert_close(got_out, want_out, atol=1e-5, rtol=0)
    torch.testing.assert_close(got_lse, want_lse, atol=1e-5, rtol=0)


def test_tiles_match_the_kernel_source():
    """`BF16_TILES` is the Python view of `Tile<D>` in the CUDA source."""
    src = (Path(tfa.__file__).parent.parent / "csrc" / "flash_attention.cu").read_text()
    found = {int(d): (int(bq), int(bk), int(ds)) for d, bq, bk, ds in re.findall(
        r"struct Tile<(\d+)> \{\s*static constexpr int BQ = (\d+), BK = (\d+), DS = (\d+),", src)}
    assert found == tfa.BF16_TILES
    assert set(found) == set(tfa.HEAD_DIMS)


def test_cpu_dispatch_takes_plain_version():
    q, k, v = (torch.from_numpy(x).view(1, 300, 1, 64) for x in _qkv(1, 300, 300, 64, seed=1))
    before = dict(tfa.launches)
    out = kernels.attention(q, k, v)
    torch.testing.assert_close(out, tfa.flash_attention_reference(q, k, v), rtol=0, atol=0)
    assert tfa.launches == before


def test_wrapper_refuses_cpu_tensor():
    q = torch.zeros(1, 256, 1, 64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfa.flash_attention(q, q, q)


def test_wrapper_refuses_unsupported_head_dim():
    q = torch.zeros(1, 256, 1, 96)
    with pytest.raises(ValueError, match="head dim 96"):
        tfa.flash_attention(q, q, q)


def _attention_sites(monkeypatch, height, width):
    """(Lq, Lk, d) of every attention call of the full-width SD2 UNet and VAE
    on one image, traced on the meta device (shapes only, no compute)."""
    sites = []

    def record(q, k, v, *, scale=None):
        sites.append((q.shape[1], k.shape[1], q.shape[-1]))
        return tfa.flash_attention_reference(q, k, v, scale)

    monkeypatch.setattr(kernels, "attention", record)
    with torch.device("meta"), torch.inference_mode():
        unet, vae = UNet2DCondition(UNetConfig.sd2()), AutoencoderKL(VAEConfig())
        z = vae.encode_mean(torch.empty(1, 3, height, width))
        unet(torch.empty(1, 8, *z.shape[2:]), 999, torch.empty(1, 2, 1024))
        vae.decode(z)
    return sites


def _jax_envelope(lq, lk, d):
    return not (d > 512 or jfa._pick_block_k(lk, d) is None or lq < 256)


@pytest.mark.parametrize(
    "hw,kernel_sites,jax_gaps",
    [((768, 768), 17, 0), ((576, 768), 17, 5), ((256, 256), 12, 0)],
    ids=["768x768", "576x768", "256x256"],
)
def test_envelope_on_main_path(monkeypatch, hw, kernel_sites, jax_gaps):
    sites = _attention_sites(monkeypatch, *hw)
    # 16 UNet transformer sites x (self + cross) + 2 VAE mid attentions
    assert len(sites) == 2 * 16 + 2
    inside = [s for s in sites if in_kernel_envelope(*s)]
    assert len(inside) == kernel_sites
    assert all(lk >= 256 for _, lk, _ in inside)  # never the 2-token cross-attention
    assert sum(d == 512 for _, _, d in inside) == 2
    # where the JAX envelope differs it is only the TPU block table's gap
    # (L=432 at 576x768 has no KV block that fits), never the reverse
    gaps = [s for s in inside if not _jax_envelope(*s)]
    assert len(gaps) == jax_gaps and all(lq == 432 for lq, _, _ in gaps)
    assert not [s for s in sites if _jax_envelope(*s) and not in_kernel_envelope(*s)]


def test_sd2_head_dims_match_jax_config():
    t, j = UNetConfig.sd2(), JUNetConfig.sd2()
    assert t.block_out_channels == j.block_out_channels
    assert t.num_attention_heads == j.num_attention_heads
    assert {c // h for c, h in zip(t.block_out_channels, t.num_attention_heads)} == {64}

