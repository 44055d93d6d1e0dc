"""Hand-written Hopper kernels (csrc/) behind wrappers with plain PyTorch versions."""
