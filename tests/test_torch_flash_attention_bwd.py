"""Flash-attention backward in the torch port: the plain forward+LSE and plain
backward against the JAX package's Pallas kernels (interpreter mode on the
CPU), and the autograd Function's wiring (built with the plain versions)
against torch.autograd on `flash_attention_reference` and against jax.grad
of the JAX flash attention.

The kernels themselves run only on the card; `chip_smoke.py` holds them to
their plain versions there.

The bf16 kernels' tiled schedule is emulated in plain fp32 torch and held to
the plain backward; a test reads their tiles out of the CUDA source.

Tolerances: fp32 on both sides, differing only in summation order (blocked
online softmax vs one pass): 2e-5, the bound the JAX package's own kernel
tests use; the two torch routes to the same gradient: 1e-5."""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diffusion_e2e_ft_tpu.kernels import flash_attention as jfa
from diffusion_e2e_ft_tpu_torch import kernels
from diffusion_e2e_ft_tpu_torch.kernels import flash_attention as tfa
from diffusion_e2e_ft_tpu_torch.kernels import in_kernel_envelope
from diffusion_e2e_ft_tpu_torch.models import AutoencoderKL, UNet2DCondition, UNetConfig, VAEConfig


@pytest.fixture
def interpret_mode():
    jfa.INTERPRET = True
    yield
    jfa.INTERPRET = False


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _port(x: np.ndarray) -> torch.Tensor:
    """[BN, L, D] -> the port's [B, L, N, D] with B = BN, N = 1."""
    return torch.from_numpy(x)[:, :, None]


# (BN, Lq, Lk, D, block_k): exact blocks; KV padded to the block in the TPU
# kernel; Lq padded there (ragged for the port); the VAE's single 512-wide
# head; GeoWizard's SD1.5 head dims
BNLD_CASES = [
    (2, 256, 256, 64, 128),
    (1, 256, 300, 64, 128),
    (2, 300, 256, 64, 128),
    (1, 256, 256, 512, 128),
    (2, 300, 256, 40, 128),
    (1, 256, 300, 80, 128),
    (2, 256, 256, 160, 128),
]
BNLD_IDS = ["exact-d64", "padded-kv-d64", "ragged-lq-d64", "exact-d512", "ragged-lq-d40", "padded-kv-d80",
            "exact-d160"]


@pytest.mark.parametrize("bn,lq,lk,d,block_k", BNLD_CASES, ids=BNLD_IDS)
def test_fwd_lse_reference_matches_pallas(interpret_mode, bn, lq, lk, d, block_k):
    q, k, v = _arrays([(bn, lq, d), (bn, lk, d), (bn, lk, d)], seed=lq + lk + d)
    scale = d**-0.5
    out, lse = jfa._flash_bnld_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, block_k)
    got_out, got_lse = tfa.flash_attention_fwd_lse_reference(_port(q), _port(k), _port(v), scale)
    assert got_lse.shape == (bn, lq, 1) and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_out[:, :, 0].numpy(), np.asarray(out), atol=2e-5, rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse), atol=2e-5, rtol=0)


@pytest.mark.parametrize("bn,lq,lk,d,block_k", BNLD_CASES, ids=BNLD_IDS)
def test_bwd_reference_matches_pallas(interpret_mode, bn, lq, lk, d, block_k):
    q, k, v, do = _arrays([(bn, lq, d), (bn, lk, d), (bn, lk, d), (bn, lq, d)], seed=lq + lk + d + 1)
    scale = d**-0.5
    out, lse = jfa._flash_bnld_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, block_k)
    want = jfa._flash_bwd_bnld(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(do), out, lse,
                               scale, block_k)
    got = tfa.flash_attention_bwd_reference(
        _port(q), _port(k), _port(v), _port(do), _port(np.array(out)), torch.from_numpy(np.array(lse)), scale
    )
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g[:, :, 0].numpy(), np.asarray(w), atol=2e-5, rtol=0, err_msg=name)


def _tiles(t: torch.Tensor, rows: int, dp: int) -> torch.Tensor:
    """[B, L, N, D] -> [B, N, T, rows, DP]: zero rows past L and columns past D,
    as the kernels' cp.async fills a tile (source size 0 past the end)."""
    b, length, n, d = t.shape
    t = F.pad(t, (0, dp - d, 0, 0, 0, -length % rows))
    return t.permute(0, 2, 1, 3).reshape(b, n, -1, rows, dp)


def _row_tiles(x: torch.Tensor, rows: int) -> torch.Tensor:
    """[B, L, N] -> [B, N, T, rows], zero past L (the staged lse and delta)."""
    return F.pad(x, (0, 0, 0, -x.shape[1] % rows)).transpose(1, 2).reshape(x.shape[0], x.shape[2], -1, rows)


def _emulate_bwd_schedule(q, k, v, do, out, lse, scale, tiles):
    """The bf16 backward kernels' algorithm (csrc/flash_attention_bwd.cu) in
    plain fp32 torch, [B, L, N, D] -> (dq, dk, dv). d padded with zero columns
    to a multiple of 16. Each kernel's block owns `bm` rows and streams the
    other side in tiles of `bn` rows (`tiles[kernel] = (bm, bn, ds)`); the
    logits and dP of a tile are summed from `ds` partial products over
    slices of d, in slice order; p = exp2(s scale log2e - lse log2e) and
    ds = p (dP - delta) scale, set to 0 explicitly past Lq and Lk. dq: Q-major
    S = Q K^T, dq += ds K. dk/dv: KV-major, the transposed tiles S^T = K Q^T
    and dP^T = V dO^T with lse and delta along the columns, dv += P^T dO,
    dk += ds^T Q."""
    b, lq, n, d = q.shape
    lk = k.shape[1]
    dp = -(-d // 16) * 16
    log2e = math.log2(math.e)
    delta = (do * out).sum(-1)  # [B, Lq, N], as the wrapper computes it

    def products(x1, x2, y1, y2, ds):  # S = X1 Y1^T, dP = X2 Y2^T from ds partial products each
        w = dp // ds
        s, dpr = torch.zeros(()), torch.zeros(())
        for p in range(ds):
            cols = slice(p * w, (p + 1) * w)
            s = s + x1[..., cols] @ y1[..., cols].transpose(-1, -2)
            dpr = dpr + x2[..., cols] @ y2[..., cols].transpose(-1, -2)
        return s, dpr

    def probs(s, dpr, lse2, dd, valid):
        p = torch.exp2(s * scale * log2e - lse2)
        ds_ = p * (dpr - dd) * scale
        return p.masked_fill(~valid, 0.0), ds_.masked_fill(~valid, 0.0)

    bm, bn, ds = tiles["dq"]  # a block owns Q rows, streams K / V
    qt, dot = _tiles(q, bm, dp), _tiles(do, bm, dp)
    kt, vt = _tiles(k, bn, dp), _tiles(v, bn, dp)
    lse_t, dd_t = _row_tiles(lse, bm), _row_tiles(delta, bm)
    dq = torch.zeros(b, n, qt.shape[2], bm, dp)
    for i in range(qt.shape[2]):
        rows = i * bm + torch.arange(bm) < lq
        for j in range(kt.shape[2]):
            cols = j * bn + torch.arange(bn) < lk
            s, dpr = products(qt[:, :, i], dot[:, :, i], kt[:, :, j], vt[:, :, j], ds)
            _, ds_ = probs(s, dpr, lse_t[:, :, i, :, None] * log2e, dd_t[:, :, i, :, None], rows[:, None] & cols)
            dq[:, :, i] += ds_ @ kt[:, :, j]

    bm, bn, ds = tiles["dkv"]  # a block owns K / V rows, streams Q / dO
    kt, vt = _tiles(k, bm, dp), _tiles(v, bm, dp)
    qt, dot = _tiles(q, bn, dp), _tiles(do, bn, dp)
    lse_t, dd_t = _row_tiles(lse, bn), _row_tiles(delta, bn)
    dk = torch.zeros(b, n, kt.shape[2], bm, dp)
    dv = torch.zeros_like(dk)
    for i in range(kt.shape[2]):
        rows = i * bm + torch.arange(bm) < lk
        for j in range(qt.shape[2]):
            cols = j * bn + torch.arange(bn) < lq
            st, dpt = products(kt[:, :, i], vt[:, :, i], qt[:, :, j], dot[:, :, j], ds)
            pt, dst = probs(st, dpt, lse_t[:, :, j, None, :] * log2e, dd_t[:, :, j, None, :], rows[:, None] & cols)
            dv[:, :, i] += pt @ dot[:, :, j]
            dk[:, :, i] += dst @ qt[:, :, j]

    def untile(t, length):
        return t.reshape(b, n, -1, dp)[:, :, :length, :d].permute(0, 2, 1, 3)

    return untile(dq, lq), untile(dk, lk), untile(dv, lk)


# fp32 on both sides: the emulation differs from the one-pass plain backward
# in summation order (tiles, d slices) and in exp2 of a product against exp of
# a difference, ~1e-7 relative; 1e-5 holds dq, dk and dv.
@pytest.mark.parametrize("lk", [256, 257, 300])
@pytest.mark.parametrize("d", sorted(tfa.BWD_TILES))
def test_bwd_schedule_matches_plain(d, lk):
    rng = np.random.default_rng(d + lk)
    # Lq = 300: ragged against every tile (64, 32 and 16 rows)
    q, do = (torch.from_numpy(rng.standard_normal((1, 300, 2, d)).astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((1, lk, 2, d)).astype(np.float32)) for _ in range(2))
    scale = d**-0.5
    out, lse = tfa.flash_attention_fwd_lse_reference(q, k, v, scale)
    got = _emulate_bwd_schedule(q, k, v, do, out, lse, scale, tfa.BWD_TILES[d])
    want = tfa.flash_attention_bwd_reference(q, k, v, do, out, lse, scale)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a, w, atol=1e-5, rtol=0, msg=name)


def test_bwd_tiles_match_the_kernel_source():
    """`BWD_TILES` is the Python view of `BwdTile<D, kDkv>` in the CUDA source."""
    src = (Path(tfa.__file__).parent.parent / "csrc" / "flash_attention_bwd.cu").read_text()
    found: dict = {}
    for d, dkv, bm, bn, ds in re.findall(
            r"struct BwdTile<(\d+), (false|true)> \{\s*static constexpr int BM = (\d+), BN = (\d+), DS = (\d+),", src):
        found.setdefault(int(d), {})["dkv" if dkv == "true" else "dq"] = (int(bm), int(bn), int(ds))
    assert found == tfa.BWD_TILES
    assert set(found) == set(tfa.HEAD_DIMS) == set(tfa.GRAD_HEAD_DIMS)


def _grads(fn, q, k, v, g):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fn(*leaves)
    return (out.detach(), *torch.autograd.grad(out, leaves, torch.from_numpy(g)))


@pytest.mark.parametrize("shape", [(2, 300, 3, 64), (1, 260, 1, 512)], ids=["ragged-d64", "ragged-d512"])
def test_function_plain_wiring_matches_autograd(shape):
    q, k, v, g = _arrays([shape] * 4, seed=7)
    got = _grads(lambda *t: tfa.flash_attention_autograd(*t, impl=tfa.PLAIN), q, k, v, g)
    want = _grads(tfa.flash_attention_reference, q, k, v, g)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0, msg=name)


@pytest.mark.parametrize(
    "shape,block_k", [((1, 512, 2, 64), None), ((2, 300, 2, 64), 128)], ids=["public-api", "ragged"]
)
def test_function_plain_wiring_matches_jax_grad(interpret_mode, shape, block_k):
    """jax.grad through the JAX package's custom_vjp (Pallas forward+LSE, dq and
    dk/dv kernels) against the port's Function on the same inputs."""
    q, k, v, g = _arrays([shape] * 4, seed=11)
    scale = shape[-1] ** -0.5
    if block_k is None:  # the package's entry point picks its own blocks
        attn = jfa.flash_attention
    else:  # L=300 has no KV block in the JAX envelope; call its custom_vjp directly
        def attn(q, k, v):
            return jfa._flash_btnh(q, k, v, scale, block_k)

    want = jax.grad(lambda q, k, v: jnp.sum(attn(q, k, v) * g), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    )
    got = _grads(lambda *t: tfa.flash_attention_autograd(*t, impl=tfa.PLAIN), q, k, v, g)[1:]
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, rtol=0, err_msg=name)


def test_cpu_dispatch_with_grad_takes_plain_path():
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _arrays([(1, 300, 1, 64)] * 3, seed=3))
    before = dict(tfa.launches)
    out = kernels.attention(q, k, v)
    out.sum().backward()
    assert tfa.launches == before
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (q, k, v))


@pytest.mark.parametrize("fn", ["flash_attention_fwd_lse", "flash_attention_bwd"])
def test_wrappers_refuse_cpu_tensors(fn):
    q = torch.zeros(1, 256, 1, 64)
    args = (q, q, q) if fn == "flash_attention_fwd_lse" else (q, q, q, q, q, torch.zeros(1, 256, 1))
    with pytest.raises(ValueError, match="CUDA tensor"):
        getattr(tfa, fn)(*args)


def test_training_sites_in_envelope(monkeypatch):
    """The 480x640 training step's attention sites (shapes traced on the meta
    device): 15 UNet self-attention sites at d=64 (levels 0-2, 4800 / 1200 /
    300 tokens) and the VAE mid attention at d=512, 4800 tokens. L=300 has no
    KV block in the JAX envelope (it goes to XLA there); the port's kernels
    take it, masking the ragged tile."""
    sites = []

    def record(q, k, v, *, scale=None):
        sites.append((q.shape[1], k.shape[1], q.shape[-1]))
        return tfa.flash_attention_reference(q, k, v, scale)

    monkeypatch.setattr(kernels, "attention", record)
    with torch.device("meta"), torch.inference_mode():
        unet, vae = UNet2DCondition(UNetConfig.sd2()), AutoencoderKL(VAEConfig())
        z = vae.encode_mean(torch.empty(2, 3, 480, 640))
        unet(torch.empty(2, 8, *z.shape[2:]), 999, torch.empty(2, 2, 1024))
        vae.decode(z)
    inside = [s for s in sites if in_kernel_envelope(*s)]
    unet_sites = [s for s in inside if s[2] == 64]
    assert sorted({s[0] for s in unet_sites}) == [300, 1200, 4800]
    assert len(unet_sites) == 15 and all(lq == lk for lq, lk, _ in unet_sites)
    assert [s for s in inside if s[2] == 512] == [(4800, 4800, 512)] * 2  # encoder + decoder mid
    assert jfa._pick_block_k(300, 64) is None  # the JAX envelope's gap the port fills
