"""Offline data tools: VKITTI GT-normal generation (discontinuity-aware gradients +
MRF refinement, in torch on a device), Hypersim preprocessing (tone mapping,
distance->planar depth, in torch on a device) and split-list reconstruction;
and the parity tools: layer-wise activation capture and diffing, the full-size
export round trip, and the HF state-dict key inventories."""
