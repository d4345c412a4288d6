"""PyTorch / CUDA port of `diffusion_e2e_ft_tpu` for NVIDIA Hopper (H100).

Mirrors the JAX package's layout (`kernels/`, `models/`, `ops/`, `pipelines/`,
`cli/`). Plain tensor code is PyTorch; the attention kernel is CUDA C++ for
sm_90a under `csrc/`, built with nvcc at first use. CPU tensors take each
kernel's plain PyTorch version.
"""
