"""Flash-attention backward in the torch port: the plain forward+LSE and plain
backward against the JAX package's Pallas kernels (interpreter mode on the
CPU), and the autograd Function's wiring (built with the plain versions)
against torch.autograd on `flash_attention_reference` and against jax.grad
of the JAX flash attention.

The kernels themselves run only on the card; `chip_smoke.py` holds them to
their plain versions there.

Tolerances: fp32 on both sides, differing only in summation order (blocked
online softmax vs one pass): 2e-5, the bound the JAX package's own kernel
tests use; the two torch routes to the same gradient: 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
# kernel; Lq padded there (ragged for the port); the VAE's single 512-wide head
BNLD_CASES = [
    (2, 256, 256, 64, 128),
    (1, 256, 300, 64, 128),
    (2, 300, 256, 64, 128),
    (1, 256, 256, 512, 128),
]
BNLD_IDS = ["exact-d64", "padded-kv-d64", "ragged-lq-d64", "exact-d512"]


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
