"""PyTorch / CUDA port of `diffusion_e2e_ft_tpu` for NVIDIA Hopper (H100).

Mirrors the JAX package's layout (`kernels/`, `models/`, `ops/`, `pipelines/`,
`training/`, `cli/`). Plain tensor code is PyTorch; the flash-attention
forward and backward kernels are CUDA C++ for sm_90a under `csrc/`, built
with nvcc at first use. CPU tensors take each kernel's plain PyTorch version.
"""
