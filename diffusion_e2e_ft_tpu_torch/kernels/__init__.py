"""Attention dispatch (and GeoWizard's joint attention), the Hopper flash-attention kernels (forward, forward+LSE,
dq, dk/dv) with their autograd Function, GroupNorm with its statistics
kernel, and the fused GroupNorm+SiLU -> conv3x3 kernels (`gn_conv`)."""

from diffusion_e2e_ft_tpu_torch.kernels.attention import attention, in_kernel_envelope, joint_attention

__all__ = ["attention", "in_kernel_envelope", "joint_attention"]
