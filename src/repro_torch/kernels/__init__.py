"""Hand-written Hopper kernels (K1-K3), their plain PyTorch twins and the
device rule that picks between them."""
