"""Training data: the Hypersim / VirtualKITTI2 readers and the 9:1 probabilistic mixer."""
