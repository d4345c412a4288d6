"""Offline data tools: VKITTI GT-normal generation (discontinuity-aware gradients +
MRF refinement, in torch on a device), Hypersim preprocessing (tone mapping,
distance->planar depth, in torch on a device) and split-list reconstruction."""
